#!/usr/bin/env python3
"""Chip smoke test of ofq_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repo root; needs one CUDA card
    python3 chip_smoke.py --profile  # also: device time by kernel (torch.profiler)
    python3 chip_smoke.py --baseline DIR
        # also: K1's source as an earlier tree DIR has it (a `git archive`
        # of that commit), built and timed beside the current one at the
        # same shapes in the same run

Phases (any failure raises and the script exits non-zero):
  1. device: require CUDA and `nvidia-smi`'s name and power limit of the
     card (printed beside the results; no result without them);
  2. build: compile every CUDA kernel from ofq_tpu_torch/csrc/ (one nvcc
     per source, in parallel); print ptxas's report (registers, spills) of
     K1's and K4's sources and the wgmma (HGMMA) instructions of each of
     K1's tensor-core kernels, read from the built library with cuobjdump,
     and fail if one has none;
  3. K1, the fused QLinear kernel (wgmma on the integer codes), against its
     plain PyTorch version on the card at the DeiT-S shapes, M = 64 * 198
     tokens (proj, fc1, fc2 at W2A2, one W4A4, one ragged case), with
     inputs built to land on LSQ and StatsQ rounding ties; elements
     differing counted (0 while the integer sums stay below 2^24);
  4. K2, the fused QKR attention core, against its plain version at
     B=64, N=198, H=6, C=384, d=64 (shared and per-head lhs, LSQ on/off);
     K3, its backward, the same way;
  5. serving: DeiT-S distilled W2A2 QKR at full width (random weights from
     a seeded torch.Generator), calibrated on a seeded batch of 64 and served
     through `Predictor` with both kernels, launch counts read around one
     predict call; the same model through the plain versions on the card
     must agree block by block and on top-1 for at least 95 % of 4 seeded
     batches; img/s over 10 calls after 3 warm-ups;
  6. training: one `make_train_step` QAT step of the same student with a
     float DeiT-S teacher, KD soft+hard and AdamW (bench.py's schedule) on
     bench.py's seeded batch of 64, kept on the device: exactly 36 K1,
     12 K2 and 12 K3 launches per step, finite loss and gradient norm;
     each block's backward through the kernels against the plain versions;
     every parameter gradient of the step against the composed model in
     fp64; train-step img/s over 5 steps after 2 warm-ups, kernels and
     plain; peak device memory;
  7. K4, the StatsQ matmul kernel, and K5, its dx product, against their
     plain versions in fp32 and bf16 at the DeiT-S shapes (proj, fc1, fc2
     with M = 64 * 198) and one ragged shape, with StatsQ ties built in;
  8. pallas serving: the same DeiT-S student with matmul_impl="pallas" in
     the bf16 stream (compute_dtype="bfloat16", the configuration of
     bench.py's `_rate(matmul_impl="pallas", compute_dtype="bfloat16")`)
     through `Predictor`: exactly 36 K4 launches per forward and none of
     K1-K3, the block and top-1 gates of phase 5 in bf16 form, img/s;
  9. pallas training: bench.py's pallas step (bf16 stream, fp32 masters,
     bf16 float teacher, KD soft+hard, AdamW, its seeded batch of 64 on the
     device): exactly 36 K4 launches per step and none of K1-K3, the gates
     of phase 6 in bf16 form, img/s, peak memory; then K5 on the 36 dx
     products of one backward of this step (upstream gradients and
     weights captured with hooks) against its plain version and against
     the dx that the backward computed;
 10. K6, K7, K8, the Swin window-attention tail kernels of the lab bench
     (benchmarks/window_attn_lab.py), against their plain version at the
     lab's shapes (Swin-T stage 0 at batch 64: 4096 windows of 49 tokens,
     3 heads of 32, bf16) on the lab's seeded data, each at each lab
     parameter set, with times, the plain version's, SDPA's on the same
     q, k, v (a related function) and the bound;
 11. float Swin-T serving: the float model (the student's warm start and
     teacher) in the bf16 stream with bf16 parameters through `Predictor`,
     no kernel in its forward; K6-K8 at their default parameters on the
     q, k, v of its two stage-0 blocks, captured with forward hooks (two
     launches each); img/s, peak memory;
 12. K4 at Swin-T's 15 shapes (M = 200 704 rows and K = 96 at stage 0)
     in bf16 against its plain version;
 13. Swin-T W2A2 QKR serving, matmul_impl="pallas" in the bf16 stream
     (the student of train_scripts/swin_t/w2a2_swin_t.sh), calibrated on a
     seeded batch, through `Predictor`: exactly 39 K4 launches per forward
     (3 per block and one per patch merging) and none of K1-K3 or K6-K8,
     the block (each block and patch merging alone) and top-1 gates of
     phase 8, img/s, peak memory.
With --baseline, phase 3 also times the earlier tree's K1 at the same
shapes (both through their C launchers alone), and the run ends with the
sums over the 36 launches of a fused step.  The line before the last is a
JSON object with every kernel's numbers (times in ms, CUDA events; bounds
from the H100 SXM data sheet); the last line is
{"ok": true, "device": {...}}.  Full results also go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet (dense): HBM3 bytes/s; the peak rate for each
# operand type.  K1 multiplies small integer codes (|XI * WI| <= 9 at W2A2),
# bf16 in the TPU kernel and exact at the bf16 tensor-core rate; K2
# multiplies fp32 values, at the fp32 (non-tensor-core) rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
BATCH = 64
# the two configurations of the DeiT-S W2A2 QKR student that the script
# drives: the fused kernels K1-K3 in fp32, and bench.py's pallas step
# (K4 in every quantized linear, the composed attention tail) in bf16
FUSED = dict(matmul_impl="fused", attn_impl="fused", compute_dtype=None)
PALLAS = dict(matmul_impl="pallas", attn_impl=None, compute_dtype="bfloat16")
# seeded batches of 64 over which the slice's kernel path and plain path
# are compared
CMP_BATCHES = 4


def log(*a):
    print(*a, flush=True)


def median_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1
def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check runs only on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = smi.stdout.strip().splitlines()
    if smi.returncode != 0 or not lines or len(lines[0].split(",")) != 2:
        # every number below is printed beside the card's name and power
        # limit; without them the run reports nothing
        raise SystemExit(
            f"chip_smoke: nvidia-smi did not report name,power.limit (exit "
            f"{smi.returncode}): {smi.stdout!r} {smi.stderr!r}")
    card = lines[0]
    # fp32 products in full fp32 for the plain versions (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return card


# ---------------------------------------------------------------- phase 2
# the sources whose ptxas report the build phase prints, and the one whose
# kernels run their products on wgmma
REPORT_SOURCES = ("fused_qlinear", "pallas_statsq")
TC_SOURCE = "fused_qlinear"


def _cuobjdump():
    from ofq_tpu_torch.ops import _build
    return os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")


def wgmma_counts(lib_path):
    """HGMMA (wgmma) instructions in each kernel of a built library, from
    its SASS (cuobjdump -sass)."""
    out = subprocess.run([_cuobjdump(), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {lib_path}: {out.stderr}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def phase_build():
    from ofq_tpu_torch.ops import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    dt = time.perf_counter() - t0
    tc = {}
    for name in _build.SOURCES:
        _build.load(name)
        for line in reports.get(name, "").splitlines():
            if (name in REPORT_SOURCES and "ptxas" in line) or (
                    "registers" in line or "spill" in line):
                log(f"[build] {name}: {line.strip()}")
    counts = wgmma_counts(_build._lib_path(TC_SOURCE))
    tc = {k: v for k, v in counts.items() if "_tc_kernel" in k}
    for fn, n in counts.items():
        log(f"[build] {TC_SOURCE}: {n} HGMMA (wgmma) instructions in {fn}")
    if not tc or not all(tc.values()):
        raise AssertionError(f"{TC_SOURCE}: a tensor-core kernel without "
                             f"wgmma: {tc}")
    log(f"[build] {len(_build.SOURCES)} kernels built in {dt:.1f} s "
        f"into {_build.BUILD_DIR}")
    return dict(seconds=dt, wgmma=tc,
                ptxas={n: reports.get(n, "") for n in REPORT_SOURCES})


def build_baseline(root):
    """K1's source of an earlier tree (`root`, a `git archive` of that
    commit), built with the current flags into root/_build_baseline; returns
    its library.  The earlier source includes no header of csrc/."""
    import ctypes
    from ofq_tpu_torch.ops import _build
    out_dir = os.path.join(root, "_build_baseline")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(root, "ofq_tpu_torch", "csrc", f"{TC_SOURCE}.cu")
    lib = os.path.join(out_dir, f"lib{TC_SOURCE}.so")
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                       capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        raise RuntimeError(f"baseline {TC_SOURCE}.cu failed to build:\n"
                           f"{p.stdout}{p.stderr}")
    for line in (p.stdout + p.stderr).splitlines():
        if "registers" in line or "spill" in line:
            log(f"[baseline] {TC_SOURCE}: {line.strip()}")
    log(f"[baseline] built K1 of {root}")
    return ctypes.CDLL(lib)


def raw_k1(lib, args):
    """K1's C launcher in `lib` (the current one or an earlier tree's: the
    same C signature) called straight on `args` (fused_qlinear_fwd's) into
    an output allocated once: the kernel and its launch, without the
    wrapper's checks and allocation, for a before-and-after on equal
    terms."""
    import ctypes
    import torch
    x2, s_tok, n_tok, b_pre, w, s_w, bvec, a_lo, a_hi, n_w = args
    M, K = x2.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x2.device)
    fn = lib.ofq_fused_qlinear_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    call = [x2.data_ptr(), s_tok.data_ptr(), n_tok, b_pre.data_ptr(),
            w.data_ptr(), s_w.data_ptr(), bvec.data_ptr(), y.data_ptr(),
            M, K, N, float(a_lo), float(a_hi), float(n_w)]
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(*call, stream)
        if err:
            raise RuntimeError(f"K1 launcher: CUDA error {err}")
        return y
    return run


def _versus(raw_ms, base_ms):
    """The before-and-after of a phase's log line (--baseline), or ''."""
    if base_ms is None:
        return ""
    return (f" (launcher alone {raw_ms:.4f} ms, the earlier kernel the "
            f"same way {base_ms:.4f} ms)")


def tc_design(shape):
    """A label for the launch of a wgmma kernel (its `launch_shape`)."""
    label = (f"wgmma BM 128 BN {shape['bn']}, {shape['grid'][0]}x"
             f"{shape['grid'][1]} persistent blocks of {shape['tiles']} M "
             f"tiles, {shape['stages']} raw slots")
    if shape["panel"]:
        label += ", W code panel"
    return dict(shape, label=label)


# ---------------------------------------------------------------- phase 3
def _statsq_weight(g, K, N, n):
    """A (K, N) kernel whose first half of columns sit on StatsQ ties:
    mean|w| = 0.5 there (scale 1) and every c * n is integral; the other
    columns are lecun-normal."""
    import torch
    w = torch.randn(K, N, generator=g) / K ** 0.5
    t = torch.randint(0, n // 2 + 1, (K // 2, N // 2), generator=g) / n
    ties = torch.cat([0.5 - t, 0.5 + t], 0)
    w[:, : N // 2] = ties * (torch.randint(0, 2, (K, N // 2), generator=g)
                             * 2 - 1)
    return w


def _k1_inputs(g, M, n_tok, K, N, a_bits, w_bits, all_positive, dev):
    """Activations, per-token scales and kernel with rounding ties: a third
    of the activations satisfy (x + b_pre) / s = k + 0.5 exactly, and half
    the weight columns have mean|w| = 0.5 (scale 1) with c * n integral."""
    import torch
    from ofq_tpu_torch.quant.lsq import thresholds
    lo, hi = thresholds(a_bits, all_positive)
    x = torch.randn(M, K, generator=g)
    if all_positive:
        x = x.abs()
    s = torch.randint(64, 256, (n_tok,), generator=g).float() / 128
    b_pre = torch.randint(-8, 9, (K,), generator=g).float() / 256
    k = torch.randint(lo, hi, (M, K), generator=g).float()
    tie = s.repeat(M // n_tok)[:, None] * (k + 0.5) - b_pre
    mask = torch.rand(M, K, generator=g) < 1 / 3
    x = torch.where(mask, tie, x)
    w = _statsq_weight(g, K, N, 2 ** (w_bits - 1))
    b_post = torch.randn(K, generator=g) * 0.05
    bias = torch.randn(N, generator=g) * 0.1
    return [a.to(dev) for a in (x, s, b_pre, w, b_post, bias)]


def phase_k1(dev, n_tok_main, batch=BATCH, base=None):
    import torch
    from ofq_tpu_torch.ops import fused_qlinear as fq
    from ofq_tpu_torch.quant.lsq import thresholds
    from ofq_tpu_torch.quant.statsq import statsq_scale
    g = torch.Generator().manual_seed(1)
    m_tok = batch * n_tok_main
    cases = [  # name, M, n_tok, K, N, bits, all_positive, main path
        ("proj", m_tok, n_tok_main, 384, 384, 2, False, True),
        ("fc1", m_tok, n_tok_main, 384, 1536, 2, False, True),
        ("fc2", m_tok, n_tok_main, 1536, 384, 2, True, True),
        ("proj_w4a4", m_tok, n_tok_main, 384, 384, 4, False, False),
        ("ragged", 3 * 37, 37, 200, 72, 2, False, False),
    ]
    results = []
    for name, M, n_tok, K, N, bits, all_pos, main in cases:
        x, s, b_pre, w, b_post, bias = _k1_inputs(
            g, M, n_tok, K, N, bits, bits, all_pos, dev)
        a_lo, a_hi = thresholds(bits, all_pos)
        n_w = float(2 ** (bits - 1))
        sw = statsq_scale(w).contiguous()
        wq = fq._wq_value(w, sw, n_w)
        bvec = (b_post @ wq + bias).contiguous()
        args = (x, s, n_tok, b_pre, w, sw, bvec, a_lo, a_hi, n_w)
        y_k = fq.fused_qlinear_fwd(*args)
        y_ref = fq.fused_qlinear_fwd_reference(*args)
        torch.cuda.synchronize()
        err = float((y_k - y_ref).abs().max())
        differing = int((y_k != y_ref).sum())
        scale = float(y_ref.abs().max())
        n_ties = int(((x + b_pre) / s.repeat(M // n_tok)[:, None]
                      - 0.5).remainder(1.0).eq(0).sum())
        c = torch.clamp(w / sw, -1.0, 1.0 - 1e-6) * n_w - 0.5
        w_ties = int((c - torch.floor(c)).eq(0.5).sum())
        if not (torch.isfinite(y_k).all() and err <= 1e-5 * scale):
            raise AssertionError(
                f"K1 {name}: kernel vs plain max|diff| {err} > 1e-5 * {scale}")
        ms = median_ms(lambda: fq.fused_qlinear_fwd(*args))
        plain_ms = median_ms(lambda: fq.fused_qlinear_fwd_reference(*args),
                             reps=10)
        raw_ms = base_ms = None
        if base:
            from ofq_tpu_torch.ops import _build
            raw_ms = median_ms(raw_k1(_build.load("fused_qlinear"), args))
            base_ms = median_ms(raw_k1(base, args))
        design = tc_design(fq.launch_shape(M, K, N, n_tok, a_lo, a_hi, n_w))
        xq = (torch.round(torch.clamp(
            (x + b_pre) / s.repeat(M // n_tok)[:, None], a_lo, a_hi))
            * s.repeat(M // n_tok)[:, None]).contiguous()
        mm_ms = median_ms(lambda: torch.matmul(xq, wq))
        nbytes = 4 * (M * K + K * N + M * N + n_tok + K + 2 * N)
        flops = 2 * M * K * N
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        log(f"[K1] {name:10s} M={M} K={K} N={N} W{bits}A{bits}"
            f"{' unsigned' if all_pos else ''}: max|diff| {err:.3e} "
            f"(bound {1e-5 * scale:.3e}), {differing} elements differing, "
            f"{n_ties} LSQ and {w_ties} StatsQ ties; kernel "
            f"({design['label']}) {ms:.4f} ms{_versus(raw_ms, base_ms)}, "
            f"plain "
            f"{plain_ms:.4f} ms, torch.matmul(x_q, w_q) "
            f"{mm_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        results.append(dict(name=name, M=M, K=K, N=N, bits=bits,
                            all_positive=all_pos, main_path=main,
                            design=design, differing=differing,
                            raw_ms=raw_ms, baseline_raw_ms=base_ms,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            matmul_ms=mm_ms, bound_ms=b_ms, bound_by=b_by,
                            bytes=nbytes, flops=flops, lsq_ties=n_ties,
                            statsq_ties=w_ties))
    return results


# ---------------------------------------------------------------- phase 4
def phase_k2(dev, N, B=BATCH):
    import torch
    import torch.nn.functional as F
    from ofq_tpu_torch.ops import fused_attention as fa
    g = torch.Generator().manual_seed(2)
    H, C, d, bits = 6, 384, 64, 2
    sm_scale = d ** -0.5
    results = []
    for shared in (True, False):
        K = C if shared else d
        lhs = torch.randn(*((B, N, K) if shared else (B, N, H, K)),
                          generator=g) * 0.5
        rhs = torch.randn(B, N, H, K, generator=g) * 0.5
        v = torch.randn(B, N, H, d, generator=g)
        s = (torch.rand(N, generator=g) * 0.01 + 0.005)
        lhs, rhs, v, s = [t.to(dev).contiguous() for t in (lhs, rhs, v, s)]
        for quantize in (True, False):
            args = (lhs, rhs, v, s, bits, sm_scale, quantize)
            o_k = fa.qkr_attention_fwd(*args)
            o_ref = fa.qkr_attention_fwd_reference(*args)
            torch.cuda.synchronize()
            diff = (o_k - o_ref).abs()
            outside = int((diff > 1e-4 * (1 + o_ref.abs())).sum())
            frac = outside / diff.numel()
            hard = 2 * float(s.max()) * float(v.abs().max())
            err = float(diff.max())
            name = (f"{'shared' if shared else 'per-head'} lhs, "
                    f"LSQ {'on' if quantize else 'off'}")
            if not (torch.isfinite(o_k).all() and frac <= 1e-3
                    and err <= hard):
                raise AssertionError(
                    f"K2 {name}: {outside} elements outside 1e-4*(1+|ref|) "
                    f"({frac:.2e}), max|diff| {err} (limit {hard})")
            ms = median_ms(lambda: fa.qkr_attention_fwd(*args))
            plain_ms = median_ms(
                lambda: fa.qkr_attention_fwd_reference(*args), reps=10)
            q = (lhs[:, None].expand(B, H, N, K) if shared
                 else lhs.permute(0, 2, 1, 3)).contiguous()
            kk = rhs.permute(0, 2, 1, 3).contiguous()
            vv = v.permute(0, 2, 1, 3).contiguous()
            sdpa_ms = median_ms(lambda: F.scaled_dot_product_attention(
                q, kk, vv, scale=sm_scale))
            nbytes = 4 * (lhs.numel() + rhs.numel() + 2 * v.numel() + N)
            flops = 2 * B * H * N * N * (K + d)
            b_ms, b_by = bound(nbytes, flops, PEAK_FP32_FLOPS)
            log(f"[K2] {name:24s} B={B} N={N} H={H} K={K} d={d}: max|diff| "
                f"{err:.3e} (limit {hard:.3e}), {outside} of {diff.numel()} "
                f"outside 1e-4*(1+|ref|); kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, SDPA (unquantized) {sdpa_ms:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by})")
            results.append(dict(name=name, shared=shared, quantize=quantize,
                                B=B, N=N, H=H, K=K, d=d, max_abs_err=err,
                                outside=outside, ms=ms, plain_ms=plain_ms,
                                sdpa_ms=sdpa_ms, bound_ms=b_ms,
                                bound_by=b_by, bytes=nbytes, flops=flops,
                                main_path=shared and quantize))
    return results


# ------------------------------------------------------------- phase 4b
def phase_k3(dev, N, B=BATCH):
    """K3, the attention backward, against its plain version, with the
    backward of F.scaled_dot_product_attention (LSQ off, lhs expanded per
    head, only the autograd.grad call timed) as the yardstick."""
    import torch
    import torch.nn.functional as F
    from ofq_tpu_torch.ops import fused_attention as fa
    g = torch.Generator().manual_seed(3)
    H, C, d, bits = 6, 384, 64, 2
    sm_scale = d ** -0.5
    results = []
    for shared in (True, False):
        K = C if shared else d
        lhs = torch.randn(*((B, N, K) if shared else (B, N, H, K)),
                          generator=g) * 0.5
        rhs = torch.randn(B, N, H, K, generator=g) * 0.5
        v = torch.randn(B, N, H, d, generator=g)
        s = torch.rand(N, generator=g) * 0.01 + 0.005
        go = torch.randn(B, N, H, d, generator=g)
        lhs, rhs, v, s, go = [t.to(dev).contiguous()
                              for t in (lhs, rhs, v, s, go)]
        for quantize in (True, False):
            args = (lhs, rhs, v, s, go, bits, sm_scale, quantize)
            got = fa.qkr_attention_bwd(*args)
            ref = fa.qkr_attention_bwd_reference(*args)
            torch.cuda.synchronize()
            name = (f"{'shared' if shared else 'per-head'} lhs, "
                    f"LSQ {'on' if quantize else 'off'}")
            shares, err = {}, 0.0
            for nm, a, b in zip(("dlhs", "drhs", "dv"), got, ref):
                diff = (a - b).abs()
                shares[nm] = float((diff > 1e-4 * (1 + b.abs())).float()
                                   .mean())
                err = max(err, float(diff.max()))
            # ds[n] sums 64 * 6 * 198 terms; one probability that lands on
            # the other side of an LSQ boundary (the K2 precedent) moves
            # one entry by about |dpq|, so ds is held by the share of its
            # N entries outside 1e-4 * (1 + |ref|): at most 2 %
            ds_diff = (got[3] - ref[3]).abs()
            ds_share = float((ds_diff > 1e-4 * (1 + ref[3].abs())).float()
                             .mean())
            ds_err = (float((got[3] - ref[3]).norm() / ref[3].norm())
                      if quantize else float(got[3].abs().max()))
            finite = all(bool(torch.isfinite(t).all()) for t in got)
            if not (finite and max(shares.values()) <= 1e-3
                    and ds_share <= 2e-2 and (quantize or ds_err == 0)):
                raise AssertionError(
                    f"K3 {name}: shares outside 1e-4*(1+|ref|) {shares}, "
                    f"ds {ds_share} of entries outside, error {ds_err}, "
                    f"finite {finite}")
            ms = median_ms(lambda: fa.qkr_attention_bwd(*args))
            plain_ms = median_ms(
                lambda: fa.qkr_attention_bwd_reference(*args), reps=10)
            q = (lhs[:, None].expand(B, H, N, K) if shared
                 else lhs.permute(0, 2, 1, 3)).contiguous().requires_grad_()
            kk = rhs.permute(0, 2, 1, 3).contiguous().requires_grad_()
            vv = v.permute(0, 2, 1, 3).contiguous().requires_grad_()
            out = F.scaled_dot_product_attention(q, kk, vv, scale=sm_scale)
            gg = go.permute(0, 2, 1, 3).contiguous()
            sdpa_ms = median_ms(lambda: torch.autograd.grad(
                out, (q, kk, vv), gg, retain_graph=True))
            del out, q, kk, vv
            nbytes = 4 * (2 * lhs.numel() + 2 * rhs.numel()
                          + 3 * v.numel() + 2 * N)
            flops = 2 * B * H * N * N * (3 * K + 2 * d)
            b_ms, b_by = bound(nbytes, flops, PEAK_FP32_FLOPS)
            log(f"[K3] {name:24s} B={B} N={N} H={H} K={K} d={d}: share "
                f"outside 1e-4*(1+|ref|) "
                f"{ {k: f'{v:.2e}' for k, v in shares.items()} }, ds "
                f"{ds_share:.2e} of entries, "
                f"{'rel L2 ' if quantize else 'max '}{ds_err:.2e}, max|diff| "
                f"{err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"SDPA backward (unquantized) {sdpa_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB)")
            results.append(dict(name=name, shared=shared, quantize=quantize,
                                B=B, N=N, H=H, K=K, d=d, max_abs_err=err,
                                outside_share=shares, ds_share=ds_share,
                                ds_err=ds_err, ms=ms,
                                plain_ms=plain_ms, sdpa_bwd_ms=sdpa_ms,
                                bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                                flops=flops, main_path=shared and quantize))
    return results


# ---------------------------------------------------------------- phase 7
def _k45_cases(m_tok):
    return [  # name, M, K, N (K4: x (M, K) @ Q(W) (K, N)), main path
        ("proj", m_tok, 384, 384, True),
        ("fc1", m_tok, 384, 1536, True),
        ("fc2", m_tok, 1536, 384, True),
        ("ragged", 1000, 200, 72, False),
    ]


def _k45_gate(y, ref, abs_sum):
    """The limits of PERF.md section 2: fp32, |y - ref| <= 1e-5 * the sum
    of |terms| (fp32 sums in two orders); bf16, plus 2^-7 * the larger of
    |y| and |ref|, at least one bf16 ulp of either (two fp32 sums rounded
    to bf16 on either side of a rounding boundary).  Returns (max |diff|,
    worst ratio to the limit, elements outside)."""
    import torch
    d = (y.float() - ref.float()).abs()
    lim = 1e-5 * abs_sum
    if y.dtype == torch.bfloat16:
        lim = lim + 2 ** -7 * torch.maximum(y.float().abs(), ref.float().abs())
    return (float(d.max()), float((d / lim.clamp_min(1e-30)).max()),
            int((d > lim).sum()))


def _k45_bound(M, K, N, dtype):
    import torch
    es = 2 if dtype == torch.bfloat16 else 4
    nbytes = es * (M * K + M * N) + 4 * (K * N + N)
    flops = 2 * M * K * N
    # bf16 x and the odd StatsQ level codes are exact in bf16: the product
    # could run at the bf16 tensor-core rate; an fp32 x at the fp32 rate
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return nbytes, flops, bound(nbytes, flops, peak)


def _swin_k4_cases(batch=BATCH):
    """K4's shapes in one Swin-T forward at `batch` (M, K, N): proj, fc1,
    fc2 of each stage on its (batch * H * W) tokens, and the reduction of
    each patch merging on the merged map's tokens."""
    from ofq_tpu_torch.models.swin import SWIN_TINY as cfg
    side, dim, cases = cfg.img_size // cfg.patch_size, cfg.embed_dim, []
    for stage in range(len(cfg.depths)):
        M, hid = batch * side * side, int(dim * cfg.mlp_ratio)
        cases += [(f"s{stage} proj", M, dim, dim, True),
                  (f"s{stage} fc1", M, dim, hid, True),
                  (f"s{stage} fc2", M, hid, dim, True)]
        if stage < len(cfg.depths) - 1:
            side = (side + 1) // 2
            cases.append((f"s{stage} reduction", batch * side * side,
                          4 * dim, 2 * dim, True))
            dim *= 2
    return cases


# K4's and K5's kernel (one template for both, in either stream)
K45_DESIGN = "CUDA-core template, 64x64 tiles, fp32 FMAs"


def phase_k45(dev, which, cases, dtypes=None):
    """K4 (`which` = "K4": y = x @ Q(W)) or K5 ("K5": dx = g @ Q(W)^T)
    against its plain version at `cases` (name, M, K, N, main path), in
    fp32 and bf16 (or `dtypes`); a main-path case counts in bf16."""
    import torch
    from ofq_tpu_torch.ops import pallas_statsq as ps
    from ofq_tpu_torch.quant.statsq import statsq_scale
    g = torch.Generator().manual_seed(4 if which == "K4" else 5)
    bits = 2
    n = 2 ** (bits - 1)
    results = []
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        for name, M, K, N, main in cases:
            w = _statsq_weight(g, K, N, n).to(dev)
            s = statsq_scale(w).contiguous()
            wq = ps._quant_tile(w, s, float(n))
            if which == "K4":
                # an LSQ output plus move_aft: levels * scale + a shift
                a = (torch.randint(-2, 2, (M, K), generator=g) * 0.25
                     + torch.randn(K, generator=g) * 0.05)
                a = a.to(dev, dtype).contiguous()
                args = (a, w, s, float(n))
                kern, plain = ps.pallas_statsq_fwd, ps.pallas_statsq_fwd_reference
                abs_sum = ps._acc32(a.abs(), wq.abs())
                wq_c = wq.to(dtype)
                yard = lambda: torch.matmul(a, wq_c)  # noqa: E731
                out_k = K
            else:
                a = (torch.randn(M, N, generator=g) * 1e-3).to(
                    dev, dtype).contiguous()
                args = (a, w, s, float(n), dtype)
                kern, plain = ps.pallas_statsq_dx, ps.pallas_statsq_dx_reference
                abs_sum = ps._acc32(a.abs(), wq.abs().T)
                wq_c = wq.to(dtype)
                yard = lambda: torch.matmul(a, wq_c.T)  # noqa: E731
                out_k = N
            y_k = kern(*args)
            y_ref = plain(*args)
            torch.cuda.synchronize()
            err, ratio, outside = _k45_gate(y_k, y_ref, abs_sum)
            c = torch.clamp(w / s, -1.0, 1.0 - 1e-6) * n - 0.5
            w_ties = int((c - torch.floor(c)).eq(0.5).sum())
            dt = str(dtype).replace("torch.", "")
            if not (torch.isfinite(y_k).all() and outside == 0):
                raise AssertionError(
                    f"{which} {name} {dt}: {outside} elements outside the "
                    f"limit (worst ratio {ratio:.3f}), max|diff| {err}")
            ms = median_ms(lambda: kern(*args))
            plain_ms = median_ms(lambda: plain(*args), reps=10)
            yard_ms = median_ms(yard)
            nbytes, flops, (b_ms, b_by) = _k45_bound(M, K, N, dtype)
            log(f"[{which}] {name:6s} {dt:8s} M={M} K={K} N={N}: max|diff| "
                f"{err:.3e}, worst |diff|/limit {ratio:.3f}, {w_ties} StatsQ "
                f"ties; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"torch.matmul(a, Q(W){'^T' if which == 'K5' else ''}) "
                f"{yard_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
            results.append(dict(name=name, dtype=dt, M=M, K=K, N=N,
                                main_path=main and dtype == torch.bfloat16,
                                design=K45_DESIGN,
                                max_abs_err=err, worst_ratio=ratio,
                                statsq_ties=w_ties, ms=ms, plain_ms=plain_ms,
                                matmul_ms=yard_ms, bound_ms=b_ms,
                                bound_by=b_by, bytes=nbytes, flops=flops,
                                contraction=out_k))
            del a, w, s, wq, wq_c, abs_sum, y_k, y_ref, args
    return results


def phase_k5_captured(recs):
    """K5 on the dx products of one backward of the pallas step: against
    its plain version (the limit of phase 7) and against the dx that the
    backward computed, which multiplies by Q(W) rounded to bf16, as JAX's
    `_vjp_bwd` does: |K5 - dx| <= (2^-8 + 1e-5) * sum |g| |Q(W)| plus
    2^-7 * max(|K5|, |dx|) (the bf16 rounding of Q(W) is at most 2^-8 of
    each level; one output ulp).  Only these launches count as K5's."""
    import torch
    from ofq_tpu_torch import ops
    from ofq_tpu_torch.ops import pallas_statsq as ps
    from ofq_tpu_torch.quant.statsq import statsq_scale
    ops.reset_launch_counts()
    worst = {"plain": 0.0, "backward": 0.0}
    errs = {"plain": 0.0, "backward": 0.0}
    for rec in recs:
        w = rec["w"]
        N = w.shape[1]
        g2 = rec["g"].reshape(-1, N).contiguous()
        s = statsq_scale(w).contiguous()
        n = float(2 ** (rec["bits"] - 1))
        dx_k = ps.pallas_statsq_dx(g2, w, s, n, g2.dtype)
        dx_p = ps.pallas_statsq_dx_reference(g2, w, s, n, g2.dtype)
        dx_b = rec["dx"].reshape(dx_k.shape)
        abs_sum = ps._acc32(g2.abs(), ps._quant_tile(w, s, n).abs().T)
        for key, ref, extra in (("plain", dx_p, 0.0),
                                ("backward", dx_b, 2 ** -8)):
            d = (dx_k.float() - ref.float()).abs()
            lim = ((1e-5 + extra) * abs_sum + 2 ** -7 * torch.maximum(
                dx_k.float().abs(), ref.float().abs())).clamp_min(1e-30)
            worst[key] = max(worst[key], float((d / lim).max()))
            errs[key] = max(errs[key], float(d.max()))
        rec.clear()
    torch.cuda.synchronize()
    launches = ops.pallas_statsq_dx.launches
    shapes = _shapes(ops.pallas_statsq_dx)
    log(f"[K5] on the {len(recs)} dx products of one pallas train step: "
        f"{launches} launches, by (M,K,N) {shapes}; max|diff| vs plain "
        f"{errs['plain']:.3e} (worst |diff|/limit {worst['plain']:.3f}), vs "
        f"the backward's dx {errs['backward']:.3e} (worst {worst['backward']:.3f})")
    if launches != len(recs) or max(worst.values()) > 1.0:
        raise AssertionError(f"K5 on the captured dx products: {launches} "
                             f"launches, worst ratios {worst}")
    return dict(launches=launches, launch_shapes=shapes, max_abs_err=errs,
                worst_ratio=worst)


# ---------------------------------------------------------------- phase 5
def _describe(conf):
    if conf["compute_dtype"] is None:
        return "fused QLinear + fused attention, fp32"
    return (f"matmul_impl={conf['matmul_impl']!r} (K4), composed attention, "
            f"{conf['compute_dtype']} stream")


def _path_counts(cfg):
    """(quantized linears, attention blocks) of a model configuration:
    DeiT, 3 linears per block (proj, fc1, fc2); Swin, 3 per block and the
    reduction of each patch merging (Swin-T: 36 + 3 = 39)."""
    if hasattr(cfg, "depths"):
        blocks = sum(cfg.depths)
        return 3 * blocks + len(cfg.depths) - 1, blocks
    return 3 * cfg.depth, cfg.depth


def _expected(conf, cfg, train):
    """Launches of every kernel wrapper in one forward (or train step)."""
    from ofq_tpu_torch import ops
    n_linear, n_attn = _path_counts(cfg)
    want = dict.fromkeys(ops.launch_counts(), 0)
    if conf["matmul_impl"] == "fused":
        want["fused_qlinear_fwd"] = n_linear
    if conf["matmul_impl"] == "pallas":
        want["pallas_statsq_fwd"] = n_linear
    if conf["attn_impl"] == "fused":
        want["qkr_attention_fwd"] = n_attn
        if train:
            want["qkr_attention_bwd"] = n_attn
    return want


# each block alone, kernels vs plain: the largest share of (image, token)
# rows with an element outside `_outside`; end-to-end top-1 agreement
BLOCK_ROWS = 1e-3
TOP1 = 0.95
# Swin-T's block tolerance, restated from what was measured (PERF.md
# section 2): at its stage-2 reduction and stage-3 shapes (M = 3136,
# K = 768 to 3072) cuBLAS's fp32 product, in the plain path, sums in
# another order than K4, so an output that cancels differs by a few fp32
# ulps of its terms, many bf16 ulps of itself (49 % of the stage-2
# reduction's rows had such an element); 2^-8 of its row's largest |ref|
# covers that, and the limit on the rows stays BLOCK_ROWS
SWIN_GATE = dict(rows=BLOCK_ROWS, row_floor=2 ** -8)


def _outside(y, ref, conf, row_floor=0.0):
    """Elements of `y` outside the stream's tolerance around `ref`: fp32,
    1e-4 * (1 + |ref|); bf16, one bf16 ulp of the element itself, at most
    2^-7 * |ref|, plus `row_floor` times the row's largest |ref| (PERF.md,
    section 2)."""
    d = (y - ref).abs()
    if conf["compute_dtype"] is None:
        return d > 1e-4 * (1 + ref.abs())
    r = ref.abs().float()
    return d.float() > 2 ** -7 * r + row_floor * r.amax(-1, keepdim=True)


def _row_shares(y, ref, conf, row_floor=0.0):
    """The shares of (image, token) rows with an element outside
    `_outside`, and with an element differing at all."""
    return (float(_outside(y, ref, conf, row_floor).any(-1).float().mean()),
            float((y != ref).any(-1).float().mean()))


def _log_rows(what, shares, limit=BLOCK_ROWS):
    log(f"{what}: share of (image, token) rows with an element outside the "
        f"tolerance {[f'{a:.2e}' for a, _ in shares]}, differing at all "
        f"{[f'{b:.2e}' for _, b in shares]}")
    if max(a for a, _ in shares) > limit:
        raise AssertionError(f"{what}: more than {limit} of the rows "
                             f"of a block differ: {shares}")
    return [a for a, _ in shares]


def _shapes(fn):
    return {str(k): v for k, v in fn.launch_shapes.items()}


def phase_slice(dev, conf, name, policy, batch=BATCH, gate=None):
    """Serving the W2A2 QKR student `name` under `policy` in the
    configuration `conf` through `Predictor` (`gate`: `check_blocks`)."""
    import numpy as np
    import torch
    from ofq_tpu_torch import ops
    from ofq_tpu_torch.calibrate import calibrate
    from ofq_tpu_torch.models import create_model
    from ofq_tpu_torch.serve import Predictor

    t0 = time.perf_counter()
    model = create_model(
        name, policy=policy, device=dev,
        generator=torch.Generator().manual_seed(0), head_std=0.02, **conf)
    cfg = model.cfg
    img, classes = cfg.img_size, cfg.num_classes
    rng = np.random.default_rng(0)
    calib = rng.normal(size=(batch, img, img, 3)).astype(np.float32)
    images = rng.normal(size=(batch, img, img, 3)).astype(np.float32)
    calibrate(model, calib)
    torch.cuda.synchronize()
    log(f"[slice] {name} W2A2 QKR, {_describe(conf)}, "
        f"{sum(p.numel() for p in model.parameters())} params, built and "
        f"calibrated in {time.perf_counter() - t0:.1f} s")
    pred = Predictor(model, batch_size=batch, img_size=img, device=dev)

    ops.reset_launch_counts()
    probs = pred.predict(images)
    launches = ops.launch_counts()
    shapes = {**_shapes(ops.fused_qlinear_fwd),
              **_shapes(ops.pallas_statsq_fwd)}
    log(f"[slice] launches in one predict: {launches}; by (M,K,N): {shapes}")
    want = _expected(conf, cfg, train=False)
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    if not (probs.shape == (batch, classes) and np.isfinite(probs).all()
            and np.allclose(probs.sum(-1), 1.0, atol=1e-4)):
        raise AssertionError(f"predictions are not finite ({batch}, "
                             f"{classes}) probability rows")

    # Kernel path vs plain path.  A kernel and its plain version sum in
    # another order, so now and then a value crosses an LSQ boundary and
    # moves one 2-bit level (in bf16, a one-ulp difference of an output
    # does), and the random-weight W2A2 model carries such a move on
    # through the later blocks and scrambles that image's top-1.  So (a)
    # each block is held alone, on the plain path's input to it (at most
    # BLOCK_ROWS of its (image, token) rows may have an element outside
    # `_outside`); (b) end to end, on CMP_BATCHES seeded batches, top-1
    # agreement with the plain path at least TOP1, printed beside
    # the number of images whose probabilities differ at all and both
    # paths' agreement with the composed model run in fp64 on the card
    # (how far rounding alone moves top-1).
    blocks = check_blocks(model, images, dev, conf, gate)
    batches = [images] + [rng.normal(size=images.shape).astype(np.float32)
                          for _ in range(CMP_BATCHES - 1)]
    p_k = np.concatenate([probs] + [pred.predict(b) for b in batches[1:]])
    model.use_kernels = False
    p_p = np.concatenate([pred.predict(b) for b in batches])
    model.use_kernels = True
    p_64 = composed_fp64_probs(model, batches, dev)
    top1 = {k: p.argmax(-1) for k, p in (("kernels", p_k), ("plain", p_p),
                                          ("fp64", p_64))}
    agree = float((top1["kernels"] == top1["plain"]).mean())
    agree_64 = {k: float((top1[k] == top1["fp64"]).mean())
                for k in ("kernels", "plain")}
    max_diff = float(np.abs(p_k - p_p).max())
    touched = int((np.abs(p_k - p_p).max(-1) > 0).sum())
    log(f"[slice] {len(p_k)} images, {touched} with any probability "
        f"differing: top-1 agreement kernels vs plain "
        f"{agree * 100:.2f} %; vs the composed fp64 model: kernels "
        f"{agree_64['kernels'] * 100:.2f} %, plain "
        f"{agree_64['plain'] * 100:.2f} %; max |prob diff| kernels vs plain "
        f"{max_diff:.3e}, max prob {float(p_p.max()):.4f}")
    if not np.isfinite(p_k).all() or agree < TOP1:
        raise AssertionError(f"top-1 agreement {agree} < {TOP1}")

    def rate(n_calls=10):
        for _ in range(3):
            pred.predict(images)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n_calls):
            pred.predict(images)
        torch.cuda.synchronize()
        return batch * n_calls / (time.perf_counter() - t)

    torch.cuda.reset_peak_memory_stats()
    img_s = rate()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model.use_kernels = False
    img_s_plain = rate()
    model.use_kernels = True
    log(f"[slice] Predictor.predict, B={batch}: {img_s:.1f} img/s with the "
        f"kernels, {img_s_plain:.1f} img/s through the plain versions; "
        f"peak device memory {peak_gb:.2f} GB with the kernels")
    prof = (phase_profile(lambda: pred.predict(images), "predict call")
            if "--profile" in sys.argv else None)
    return dict(config=conf, profile=prof, launches=launches,
                launch_shapes=shapes,
                compared_images=len(p_k), images_differing=touched,
                blocks=blocks,
                top1_agreement=agree, top1_agreement_fp64=agree_64,
                max_prob_diff=max_diff,
                img_per_s=img_s, img_per_s_plain=img_s_plain,
                peak_mem_gb=peak_gb)




def check_blocks(model, images, dev, conf=FUSED, gate=None):
    """Each block through the kernels against the same block through the
    plain versions, on the plain path's input to that block, held by
    `gate`: at most `rows` of its rows outside `_outside` with `row_floor`
    (default: BLOCK_ROWS, no row term)."""
    import torch
    gate = gate or dict(rows=BLOCK_ROWS, row_floor=0.0)
    seen = []
    hooks = [getattr(model, n).register_forward_hook(
        lambda mod, args, out: seen.append((args[0], out)))
        for n in model.block_names]
    model.use_kernels = False
    try:
        with torch.inference_mode():
            model(torch.from_numpy(images).to(dev))
    finally:
        model.use_kernels = True
        for h in hooks:
            h.remove()
    shares = []
    with torch.inference_mode():
        for name, (x, ref) in zip(model.block_names, seen):
            y = getattr(model, name)(x)
            if not torch.isfinite(y).all():
                raise AssertionError(f"{name}: non-finite output")
            shares.append(_row_shares(y, ref, conf, gate["row_floor"]))
    return _log_rows("[slice] each block alone, kernels vs plain on the same "
                     "input", shares, gate["rows"])


def composed_fp64(model):
    """A copy of `model` on the composed path in fp64: no kernels, no bf16
    stream (the same weights and scales)."""
    import copy
    ref = copy.deepcopy(model).double()
    for m in ref.modules():
        for attr in ("matmul_impl", "attn_impl", "compute_dtype"):
            if hasattr(m, attr):
                setattr(m, attr, None)
    return ref


def composed_fp64_probs(model, batches, dev):
    """The same weights and scales through the composed path in fp64."""
    import numpy as np
    import torch
    ref = composed_fp64(model)
    out = []
    with torch.inference_mode():
        for b in batches:
            x = torch.from_numpy(b).to(dev, torch.float64)
            out.append(torch.softmax(ref(x), dim=-1).cpu().numpy())
    del ref
    return np.concatenate(out)


# ---------------------------------------------------------------- phase 6
TRAIN_STEPS_TIMED, TRAIN_STEPS_WARM = 5, 2
# whole-step gradient gate.  fp32: for every parameter, the kernel path's
# relative L2 distance from the composed fp64 gradient may be at most
# twice the plain path's plus a floor; the floor is the median over
# parameters of the plain path's distance (how far rounding alone moves a
# gradient of this chaotic random-weight W2A2 model in this run), and
# never below GRAD_GATE_MIN_FLOOR.  bf16: the fp64 model has no bf16
# stream, so its distance (~0.9) measures bf16 rounding and holds nothing;
# every parameter's gradient through the kernels is held against the plain
# path's, on the same bf16 inputs, to GRAD_GATE_BF16 relative L2 (the
# fp64 distances are printed beside it)
GRAD_GATE_MIN_FLOOR = 1e-3
GRAD_GATE_BF16 = 1e-3


def phase_train(dev, conf=FUSED, name="deit_small_distilled_patch16_224",
                batch=BATCH):
    """One QAT train step of DeiT-S W2A2 QKR with the float teacher, KD
    soft+hard and AdamW, through the kernels of `conf`: K1 and K2 forward
    and K3 backward (fused, fp32), or K4 forward (pallas, the bf16 stream
    with fp32 masters and a bf16 teacher, as bench.py builds it)."""
    import numpy as np
    import torch
    from ofq_tpu_torch import ops
    from ofq_tpu_torch.calibrate import calibrate
    from ofq_tpu_torch.models import create_model
    from ofq_tpu_torch.models.deit import VARIANTS
    from ofq_tpu_torch.quant import QuantPolicy, w2a2_qkr_policy
    from ofq_tpu_torch.train import (TrainState, cosine_with_warmup_cooldown,
                                     make_optimizer, make_train_step)

    t0 = time.perf_counter()
    cfg = VARIANTS[name]
    cd = conf["compute_dtype"]
    student = create_model(
        name, policy=w2a2_qkr_policy(cfg.depth), device=dev,
        generator=torch.Generator().manual_seed(0), head_std=0.02, **conf)
    # bench.py: the teacher in the student's stream, its params cast to
    # bf16 under the bf16 stream
    teacher = create_model(name, policy=QuantPolicy(), device=dev,
                           generator=torch.Generator().manual_seed(1),
                           compute_dtype=cd)
    if cd:
        teacher.to(torch.bfloat16)
    # the batch of bench.py, kept on the device
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(batch, cfg.img_size, cfg.img_size,
                                          3)).astype(np.float32)).to(dev)
    label = torch.from_numpy(rng.integers(0, cfg.num_classes,
                                          size=(batch,))).to(dev)
    data = {"image": x, "label": label}
    calibrate(student, x[:8])
    opt = make_optimizer(cosine_with_warmup_cooldown(
        5.47e-4, epochs=300, warmup_epochs=5, warmup_lr=1e-6, min_lr=1e-5),
        weight_decay=0.05)
    state = TrainState.create(student, opt)
    step = make_train_step(student, opt, teacher=teacher,
                           loss_kind="kd_soft_hard", device=dev)
    torch.cuda.synchronize()
    log(f"[train] {name} W2A2 QKR student ({_describe(conf)}) and float "
        f"teacher ({next(teacher.parameters()).dtype}) built, calibrated in "
        f"{time.perf_counter() - t0:.1f} s")

    ops.reset_launch_counts()
    state, metrics = step(state, data)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    shapes = {**_shapes(ops.fused_qlinear_fwd),
              **_shapes(ops.pallas_statsq_fwd)}
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    log(f"[train] launches in one step: {launches}; by (M,K,N): {shapes}; "
        f"loss {loss:.6f}, grad_norm {gnorm:.6f}")
    want = _expected(conf, cfg, train=True)
    if launches != want:
        raise AssertionError(f"expected launches per step {want}, got "
                             f"{launches}")
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        raise AssertionError(f"loss {loss}, grad_norm {gnorm}")

    blocks = check_blocks_backward(student, teacher, data, conf)
    grads = check_step_grads(student, teacher, data, conf)
    captured = (capture_dx_products(student, teacher, data)
                if conf["matmul_impl"] == "pallas" else None)

    def rate():
        nonlocal state
        for _ in range(TRAIN_STEPS_WARM):
            state, m = step(state, data)
        float(m["loss"])
        t = time.perf_counter()
        for _ in range(TRAIN_STEPS_TIMED):
            state, m = step(state, data)
        if not np.isfinite(float(m["loss"])):  # host fetch: the barrier
            raise AssertionError("non-finite loss")
        return batch * TRAIN_STEPS_TIMED / (time.perf_counter() - t)

    torch.cuda.reset_peak_memory_stats()
    img_s = rate()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    student.use_kernels = False
    img_s_plain = rate()
    student.use_kernels = True
    log(f"[train] train step, B={batch}: {img_s:.1f} img/s with the kernels, "
        f"{img_s_plain:.1f} img/s through the plain versions "
        f"({TRAIN_STEPS_TIMED} steps after {TRAIN_STEPS_WARM} warm-ups); "
        f"peak device memory {peak_gb:.2f} GB with the kernels")
    prof = (phase_profile(lambda: float(step(state, data)[1]["loss"]),
                          "train step")
            if "--profile" in sys.argv else None)
    return dict(config=conf, profile=prof, launches=launches,
                launch_shapes=shapes, loss=loss, grad_norm=gnorm,
                blocks=blocks, grads=grads, img_per_s=img_s,
                img_per_s_plain=img_s_plain, peak_mem_gb=peak_gb,
                captured=captured)


def _kd_loss(model, teacher, x, label):
    import torch
    from ofq_tpu_torch.train import kd_soft_and_hard
    with torch.no_grad():
        t_logits = teacher(x)
    return kd_soft_and_hard(model(x), label, t_logits)


def check_blocks_backward(model, teacher, data, conf=FUSED):
    """Each block's VJP through the kernels against the same block through
    the plain versions, on the plain path's input to that block and its
    upstream gradient (captured with hooks on one plain backward)."""
    import torch
    seen = {}

    def fwd_hook(name):
        def hook(mod, args, out):
            seen[name] = [args[0].detach()]
            out.register_hook(lambda g: seen[name].append(g.detach()))
        return hook

    hooks = [getattr(model, n).register_forward_hook(fwd_hook(n))
             for n in model.block_names]
    model.train()
    model.use_kernels = False
    try:
        _kd_loss(model, teacher, data["image"], data["label"]).backward()
    finally:
        for h in hooks:
            h.remove()
    model.zero_grad(set_to_none=True)
    shares = []
    for name in model.block_names:
        x_in, g_out = seen.pop(name)
        dx = []
        for use in (True, False):
            model.use_kernels = use
            xi = x_in.clone().requires_grad_()
            y = getattr(model, name)(xi)
            dx.append(torch.autograd.grad(y, xi, g_out)[0])
            del y, xi
        model.use_kernels = True
        if not torch.isfinite(dx[0]).all():
            raise AssertionError(f"{name}: non-finite dx")
        shares.append(_row_shares(dx[0], dx[1], conf))
    return _log_rows("[train] each block's backward alone, kernels vs plain "
                     "on the same input and upstream gradient, rows of dx",
                     shares)


def check_step_grads(model, teacher, data, conf=FUSED):
    """The whole step's parameter gradients through the kernels and through
    the plain versions, each against the composed model in fp64 on the
    card (the same weights, scales and batch; no bf16 stream), and against
    each other."""
    import torch

    def grads(m, t, x):
        params = dict(m.named_parameters())
        g = torch.autograd.grad(_kd_loss(m, t, x, data["label"]),
                                list(params.values()), allow_unused=True)
        return {n: (torch.zeros_like(p) if gi is None else gi).double()
                for (n, p), gi in zip(params.items(), g)}

    model.train()
    g_k = grads(model, teacher, data["image"])
    model.use_kernels = False
    g_p = grads(model, teacher, data["image"])
    model.use_kernels = True
    ref = composed_fp64(model)
    t64 = composed_fp64(teacher)
    g_64 = grads(ref, t64, data["image"].double())
    del ref, t64
    rows = []
    for n, g in g_64.items():
        norm = max(float(g.norm()), 1e-30)
        rows.append(dict(
            name=n, rel_kernels=float((g_k[n] - g).norm()) / norm,
            rel_plain=float((g_p[n] - g).norm()) / norm,
            rel_kernels_plain=float((g_k[n] - g_p[n]).norm())
            / max(float(g_p[n].norm()), 1e-30)))
    rk_all = sorted(r["rel_kernels"] for r in rows)
    rp_all = sorted(r["rel_plain"] for r in rows)
    rkp = max(r["rel_kernels_plain"] for r in rows)
    floor = max(GRAD_GATE_MIN_FLOOR, rp_all[len(rp_all) // 2])

    def total(g):
        return float(sum(float((g[n] - g_64[n]).square().sum())
                         for n in g_64)) ** 0.5
    ref_norm = float(sum(float(g.square().sum()) for g in g_64.values())
                     ) ** 0.5
    glob = {"kernels": total(g_k) / ref_norm, "plain": total(g_p) / ref_norm}
    log(f"[train] whole-step gradients vs the composed fp64 model, relative "
        f"L2 per parameter ({len(rows)}): kernels median "
        f"{rk_all[len(rk_all) // 2]:.3e} max {rk_all[-1]:.3e}; plain median "
        f"{rp_all[len(rp_all) // 2]:.3e} max {rp_all[-1]:.3e}; all "
        f"parameters together: kernels {glob['kernels']:.3e}, plain "
        f"{glob['plain']:.3e}; kernels vs plain, largest per parameter "
        f"{rkp:.3e}")
    if conf["compute_dtype"] is None:
        log(f"[train] gate: kernels <= 2 x plain + {floor:.3e} against fp64")
        bad = [r for r in rows
               if r["rel_kernels"] > 2 * r["rel_plain"] + floor]
        bad_all = glob["kernels"] > 2 * glob["plain"] + floor
    else:
        log(f"[train] gate: kernels vs plain <= {GRAD_GATE_BF16} per "
            f"parameter (the fp64 distances are not gated in bf16)")
        bad = [r for r in rows if r["rel_kernels_plain"] > GRAD_GATE_BF16]
        bad_all = False
    if bad or bad_all:
        raise AssertionError(f"gradient gate failed: {bad[:5]}, {glob}")
    return dict(floor=floor, all_params=glob, kernels_vs_plain_max=rkp,
                per_param=rows)


def capture_dx_products(model, teacher, data):
    """One backward of the pallas step with a hook on every quantized
    linear's StatsQ matmul: its weight, the upstream gradient g of its
    output and the dx that `_PallasStatsQMatmul.backward` computed."""
    from ofq_tpu_torch.nn import linear
    orig = linear.statsq_matmul
    recs = []

    def hooked(x, kernel, bits, **kw):
        y = orig(x, kernel, bits, **kw)
        # a copy: the train steps timed after the capture update the
        # parameter in place
        rec = dict(w=kernel.detach().clone(), bits=bits)
        y.register_hook(lambda g: rec.__setitem__("g", g.detach()))
        x.register_hook(lambda g: rec.__setitem__("dx", g.detach()))
        recs.append(rec)
        return y

    model.train()
    linear.statsq_matmul = hooked
    try:
        _kd_loss(model, teacher, data["image"], data["label"]).backward()
    finally:
        linear.statsq_matmul = orig
    model.zero_grad(set_to_none=True)
    if len(recs) != 3 * len(model.block_names) or not all(
            "g" in r and "dx" in r for r in recs):
        raise AssertionError(f"captured {len(recs)} dx products")
    return recs


# ---------------------------------------------------------------- K6-K8
# the lab's shapes (benchmarks/window_attn_lab.py:26): Swin-T stage 0 at
# batch 64, Bn windows of n tokens, H heads of width d
LAB_BN, LAB_N, LAB_H, LAB_D = 64 * 64, 49, 3, 32
# each kernel at each lab parameter set (VARIANTS :279); K678_DEFAULT are
# the wrappers' defaults, run on the float model's captures
K678_DEFAULT = {"K6": dict(WB=16), "K7": dict(WB=16, P=3),
                "K8": dict(WB=16, P=4)}
K678_CASES = [
    ("K6", "window_attn_units", dict(WB=16)),
    ("K6", "window_attn_units", dict(WB=64)),
    ("K7", "window_attn_packed", dict(WB=16, P=3)),
    ("K7", "window_attn_packed", dict(WB=16, P=6)),
    ("K7", "window_attn_packed", dict(WB=16, P=12)),
    ("K7", "window_attn_packed", dict(WB=32, P=12)),
    ("K8", "window_attn_packed_aligned", dict(WB=16, P=4)),
    ("K8", "window_attn_packed_aligned", dict(WB=16, P=8)),
    ("K8", "window_attn_packed_aligned", dict(WB=16, P=12)),
]
# the gate (PERF.md section 2): at most this share of the elements differ
TAIL_DIFFERING = 1e-3


def _tail_gate(y, ref, q, k, v):
    """K6-K8 against their plain version: every element within one bf16
    ulp of itself, 2^-7 max(|y|, |ref|), plus 2^-8 sum_m p_m |v_m| (a
    probability that rounds to bf16 the other way moves its output row by
    up to 2^-8 p_m |v_m|), and at most TAIL_DIFFERING of the elements
    differing at all.  Returns (max |diff|, worst |diff| / limit, share
    differing)."""
    import torch
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * (
        q.shape[-1] ** -0.5)
    pv = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, dim=-1),
                      v.float().abs())
    del s
    y32, r32 = y.float(), ref.float()
    d = (y32 - r32).abs()
    lim = 2 ** -7 * torch.maximum(y32.abs(), r32.abs()) + 2 ** -8 * pv
    return (float(d.max()), float((d / lim.clamp_min(1e-30)).max()),
            float((d > 0).float().mean()))


def _check_tail(what, y, ref, q, k, v):
    import torch
    err, worst, share = _tail_gate(y, ref, q, k, v)
    if not (torch.isfinite(y.float()).all() and worst <= 1.0
            and share <= TAIL_DIFFERING):
        raise AssertionError(
            f"{what}: max|diff| {err}, worst |diff|/limit {worst:.3f}, "
            f"{share:.2e} of the elements differ (limit {TAIL_DIFFERING})")
    return err, worst, share


def phase_k678(dev):
    """K6-K8 against their plain version at the lab's shapes, on the lab's
    seeded data (`_data`: normal samples rounded to bf16), each at each lab
    parameter set, with times, the plain version's, SDPA's on the same
    q, k, v and the bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from ofq_tpu_torch.ops import window_attention as wa
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(
        size=(LAB_BN, LAB_N, LAB_H, LAB_D)).astype(np.float32)).to(
            dev, torch.bfloat16) for _ in range(3))
    ref = wa.window_attn_tail_reference(q, k, v)
    plain_ms = median_ms(lambda: wa.window_attn_tail_reference(q, k, v),
                         reps=10)
    qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    sdpa_ms = median_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    del qh, kh, vh
    nbytes = 4 * q.numel() * 2
    flops = 4 * LAB_BN * LAB_H * LAB_N * LAB_N * LAB_D
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    results = []
    for key, fn_name, kw in K678_CASES:
        fn = getattr(wa, fn_name)
        y = fn(q, k, v, **kw)
        torch.cuda.synchronize()
        err, worst, share = _check_tail(f"{key} {kw}", y, ref, q, k, v)
        ms = median_ms(lambda: fn(q, k, v, **kw))
        log(f"[{key}] {fn_name} {kw} (Bn={LAB_BN}, n={LAB_N}, H={LAB_H}, "
            f"d={LAB_D}): max|diff| {err:.3e}, worst |diff|/limit "
            f"{worst:.3f}, {share:.2e} of the elements differ; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {sdpa_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        results.append(dict(kernel=key, name=fn_name, params=kw,
                            default=kw == K678_DEFAULT[key], max_abs_err=err,
                            worst_ratio=worst, differing=share, ms=ms,
                            plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                            flops=flops))
        del y
    return results


def phase_swin_float(dev, batch=BATCH):
    """The float Swin-T (the student's warm start and teacher) served in
    the bf16 stream with bf16 parameters through `Predictor`: no kernel
    runs in its forward; forward hooks capture the q, k, v of its two
    stage-0 blocks, on which K6-K8 run at their default parameters under
    the gate of `phase_k678` (two launches each); img/s, peak memory."""
    import numpy as np
    import torch
    from ofq_tpu_torch import ops
    from ofq_tpu_torch.models import create_model
    from ofq_tpu_torch.ops import window_attention as wa
    from ofq_tpu_torch.quant import QuantPolicy
    from ofq_tpu_torch.serve import Predictor

    model = create_model("swin_t", policy=QuantPolicy(), device=dev,
                         generator=torch.Generator().manual_seed(1),
                         compute_dtype="bfloat16").to(torch.bfloat16)
    cfg = model.cfg
    pred = Predictor(model, batch_size=batch, img_size=cfg.img_size,
                     device=dev)
    images = np.random.default_rng(2).normal(
        size=(batch, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    qkv = {}
    hooks = [getattr(model, n).attn.qkv.register_forward_hook(
        lambda mod, a, y, n=n: qkv.__setitem__(n, y))
        for n in ("features_1_0", "features_1_1")]
    ops.reset_launch_counts()
    probs = pred.predict(images)
    launches = ops.launch_counts()
    for h in hooks:
        h.remove()
    if any(launches.values()):
        raise AssertionError(f"the float forward launched {launches}")
    if not (probs.shape == (batch, cfg.num_classes)
            and np.isfinite(probs).all()):
        raise AssertionError("float Swin-T: predictions are not finite")

    C, H = cfg.embed_dim, cfg.num_heads[0]
    ops.reset_launch_counts()
    captured = []
    for name, t in qkv.items():
        Bn, n, _ = t.shape
        q, k, v = (x.reshape(Bn, n, H, C // H).contiguous()
                   for x in torch.split(t, C, dim=-1))
        if q.shape != (LAB_BN, LAB_N, LAB_H, LAB_D) or q.dtype != \
                torch.bfloat16:
            raise AssertionError(f"{name}: captured q {q.dtype} "
                                 f"{tuple(q.shape)}, not the lab's shape")
        ref = wa.window_attn_tail_reference(q, k, v)
        for fn in (wa.window_attn_units, wa.window_attn_packed,
                   wa.window_attn_packed_aligned):
            y = fn(q, k, v)
            torch.cuda.synchronize()
            err, worst, share = _check_tail(f"{fn.__name__} on {name}", y,
                                            ref, q, k, v)
            captured.append(dict(block=name, name=fn.__name__,
                                 max_abs_err=err, worst_ratio=worst,
                                 differing=share))
            log(f"[swin-float] {fn.__name__} on the q, k, v of {name}: "
                f"max|diff| {err:.3e}, worst |diff|/limit {worst:.3f}, "
                f"{share:.2e} of the elements differ")
    k678_launches = {k: v for k, v in ops.launch_counts().items()
                     if k.startswith("window_attn")}
    if set(k678_launches.values()) != {2}:
        raise AssertionError(f"K6-K8 launches {k678_launches}, want 2 each")
    del qkv, q, k, v, ref, y

    def rate(n_calls=10):
        for _ in range(3):
            pred.predict(images)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n_calls):
            pred.predict(images)
        torch.cuda.synchronize()
        return batch * n_calls / (time.perf_counter() - t)

    torch.cuda.reset_peak_memory_stats()
    img_s = rate()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[swin-float] float Swin-T, bf16 parameters and stream, "
        f"Predictor.predict B={batch}: {img_s:.1f} img/s, peak device "
        f"memory {peak_gb:.2f} GB; K6-K8 launches on the captures "
        f"{k678_launches}")
    prof = (phase_profile(lambda: pred.predict(images), "predict call")
            if "--profile" in sys.argv else None)
    return dict(profile=prof, forward_launches=launches,
                k678_launches=k678_launches, captured=captured,
                img_per_s=img_s, peak_mem_gb=peak_gb)


# ------------------------------------------------- optional: --profile
def phase_profile(fn, what, n_calls=3):
    """Device time by kernel over `n_calls` calls of `fn` (torch.profiler)
    and the device's idle share of the window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies); the CPU-side aten ops
        # carry the time of the kernels they launch as well
        if ev.device_type != DeviceType.CUDA or ev.count == 0:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n_calls, ev.count // n_calls, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    per_call = wall_ms / n_calls
    log(f"[profile] per {what}: wall {per_call:.2f} ms, device busy "
        f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / per_call):.3f}, "
        f"{sum(r[1] for r in rows)} device operations")
    for ms, calls, key in rows[:15]:
        log(f"[profile] {ms:8.3f} ms {100 * ms / busy:5.1f} %  x{calls:<4d} "
            f"{key[:90]}")
    return dict(wall_ms_per_call=per_call, device_busy_ms_per_call=busy,
                rows=[dict(ms=ms, calls=c, name=k) for ms, c, k in rows])


def compare_baseline(full):
    """K1's time summed over the 36 launches of a fused step, the current
    kernel's and the earlier tree's (--baseline), each through its C
    launcher alone into a preallocated output, and the ratio."""
    counts = full["train"]["launch_shapes"]
    rows = [r for r in full["k1"] if r["main_path"]]
    n = [counts.get(str((r["M"], r["K"], r["N"])), 0) for r in rows]
    cur = sum(c * r["raw_ms"] for c, r in zip(n, rows))
    old = sum(c * r["baseline_raw_ms"] for c, r in zip(n, rows))
    out = dict(launches=sum(n), ms=cur, baseline_ms=old,
               speedup=old / cur if cur else None)
    log(f"[versus earlier] K1, {out['launches']} launches of a fused DeiT-S "
        f"train step: {cur:.3f} ms now, {old:.3f} ms earlier (launchers "
        f"alone), {out['speedup']:.2f}x")
    return out


def _kernel_row(name, src, launches, r, **extra):
    return dict(name=name, route="cuda", source=src[0], replaces=src[1],
                launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=None, **extra)


def main() -> int:
    t_start = time.perf_counter()
    sys.path.insert(0, HERE)
    import torch
    card = phase_device()
    log(card)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build = phase_build()
    base = None
    if "--baseline" in sys.argv:
        base = build_baseline(sys.argv[sys.argv.index("--baseline") + 1])
    from ofq_tpu_torch.models.deit import DEIT_SMALL
    from ofq_tpu_torch.quant import w2a2_qkr_policy, w2a2_qkr_swin_policy
    n_tok = DEIT_SMALL.n_tokens  # 14 * 14 patches + cls + dist = 198
    deit = "deit_small_distilled_patch16_224"
    full = dict(card=card, build_s=build["seconds"], build=build)
    full["k1"] = phase_k1(dev, n_tok, base=base)
    full["k2"] = phase_k2(dev, n_tok)
    full["k3"] = phase_k3(dev, n_tok)
    full["slice"] = phase_slice(dev, FUSED, deit, w2a2_qkr_policy(12))
    torch.cuda.empty_cache()
    full["train"] = phase_train(dev, FUSED)
    torch.cuda.empty_cache()
    full["k4"] = phase_k45(dev, "K4", _k45_cases(BATCH * n_tok))
    full["k5"] = phase_k45(dev, "K5", _k45_cases(BATCH * n_tok))
    torch.cuda.empty_cache()
    full["slice_pallas"] = phase_slice(dev, PALLAS, deit, w2a2_qkr_policy(12))
    torch.cuda.empty_cache()
    tp = full["train_pallas"] = phase_train(dev, PALLAS)
    full["k5_captured"] = phase_k5_captured(tp.pop("captured"))
    torch.cuda.empty_cache()
    full["k678"] = phase_k678(dev)
    torch.cuda.empty_cache()
    full["swin_float"] = phase_swin_float(dev)
    torch.cuda.empty_cache()
    full["k4_swin"] = phase_k45(dev, "K4", _swin_k4_cases(),
                                dtypes=(torch.bfloat16,))
    torch.cuda.empty_cache()
    sp = full["swin_pallas"] = phase_slice(dev, PALLAS, "swin_t",
                                           w2a2_qkr_swin_policy(),
                                           gate=SWIN_GATE)
    torch.cuda.empty_cache()

    srcs = {
        "K1": ("ofq_tpu_torch/csrc/fused_qlinear.cu",
               "ofq_tpu/ops/fused_qlinear.py:71"),
        "K2": ("ofq_tpu_torch/csrc/fused_attention.cu",
               "ofq_tpu/ops/fused_attention.py:81"),
        "K3": ("ofq_tpu_torch/csrc/fused_attention_bwd.cu",
               "ofq_tpu/ops/fused_attention.py:102"),
        "K4": ("ofq_tpu_torch/csrc/pallas_statsq.cu",
               "ofq_tpu/ops/pallas_statsq.py:41"),
        "K5": ("ofq_tpu_torch/csrc/pallas_statsq.cu",
               "ofq_tpu/ops/pallas_statsq.py:57"),
        "K6": ("ofq_tpu_torch/csrc/window_attention.cu",
               "benchmarks/window_attn_lab.py:89"),
        "K7": ("ofq_tpu_torch/csrc/window_attention.cu",
               "benchmarks/window_attn_lab.py:140"),
        "K8": ("ofq_tpu_torch/csrc/window_attention.cu",
               "benchmarks/window_attn_lab.py:204"),
    }
    kernels = []
    tr = full["train"]
    for r in full["k1"]:
        if r["main_path"]:
            kernels.append(_kernel_row(
                f"fused_qlinear_fwd {r['name']} "
                f"({r['M']}x{r['K']}x{r['N']}) [{r['design']['label']}]",
                srcs["K1"],
                tr["launch_shapes"].get(str((r["M"], r["K"], r["N"])), 0),
                r, path="fused train step", design=r["design"]["label"]))
    for key, fn in (("k2", "qkr_attention_fwd"),
                    ("k3", "qkr_attention_bwd")):
        for r in full[key]:
            if r["main_path"]:
                kernels.append(_kernel_row(
                    f"{fn} (shared lhs, LSQ on, {r['B']}x{r['N']}x"
                    f"{r['H']}x{r['K']}, d={r['d']})", srcs[key.upper()],
                    tr["launches"][fn], r, path="fused train step",
                    design="CUDA cores, fp32"))
    for r in full["k4"]:
        if r["main_path"]:
            kernels.append(_kernel_row(
                f"pallas_statsq_fwd {r['name']} bf16 "
                f"({r['M']}x{r['K']}x{r['N']})", srcs["K4"],
                tp["launch_shapes"].get(str((r["M"], r["K"], r["N"])), 0), r,
                path="pallas bf16 train step", design=r["design"]))
        elif r["dtype"] == "float32" and r["name"] == "fc1":
            # no model path runs the fp32 stream: the row of K4 in fp32,
            # launched only by this phase's comparison
            kernels.append(_kernel_row(
                f"pallas_statsq_fwd {r['name']} fp32 "
                f"({r['M']}x{r['K']}x{r['N']})", srcs["K4"], 0, r,
                path=None, design=r["design"]))
    caps = full["k5_captured"]["launch_shapes"]
    for r in full["k5"]:
        if r["main_path"]:
            kernels.append(_kernel_row(
                f"pallas_statsq_dx {r['name']} bf16 "
                f"({r['M']}x{r['K']}x{r['N']})", srcs["K5"],
                caps.get(str((r["M"], r["K"], r["N"])), 0), r,
                path="the dx products of one pallas bf16 train step, "
                     "captured with hooks", design=r["design"]))
    for r in full["k4_swin"]:
        kernels.append(_kernel_row(
            f"pallas_statsq_fwd Swin-T {r['name']} bf16 "
            f"({r['M']}x{r['K']}x{r['N']})", srcs["K4"],
            sp["launch_shapes"].get(str((r["M"], r["K"], r["N"])), 0), r,
            path="Swin-T W2A2 QKR pallas bf16 serving forward",
            design=r["design"]))
    captured = full["swin_float"]["captured"]
    for r in full["k678"]:
        if r["default"]:
            kernels.append(_kernel_row(
                f"{r['name']} {r['params']} ({LAB_BN}x{LAB_N}x{LAB_H}x"
                f"{LAB_D} bf16)", srcs[r["kernel"]],
                full["swin_float"]["k678_launches"][r["name"]],
                dict(r, max_abs_err=max([r["max_abs_err"]] + [
                    c["max_abs_err"] for c in captured
                    if c["name"] == r["name"]])),
                path="the lab's run and the q, k, v of the float Swin-T's "
                     "two stage-0 blocks, captured with hooks",
                yardstick_sdpa_ms=r["sdpa_ms"],
                design="CUDA cores, one warp per query row"))
    if any(k["launches"] <= 0 for k in kernels if k["path"] is not None):
        raise AssertionError(f"a kernel of the path was not launched: "
                             f"{kernels}")
    if base:
        full["versus_baseline"] = compare_baseline(full)
    full["seconds"] = time.perf_counter() - t_start
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(full, f, indent=1)
    log(f"[done] {full['seconds']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
