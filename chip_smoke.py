#!/usr/bin/env python3
"""Chip smoke test of ofq_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repo root; needs one CUDA card
    python3 chip_smoke.py --profile  # also: device time by kernel (torch.profiler)

Phases (any failure raises and the script exits non-zero):
  1. device: require CUDA, print the card's name and power limit;
  2. build: compile every CUDA kernel of the serving path from
     ofq_tpu_torch/csrc/ (one nvcc per source, in parallel);
  3. K1, the fused QLinear kernel, against its plain PyTorch version on the
     card at the DeiT-S shapes, M = 64 * 198 tokens (proj, fc1, fc2 at W2A2,
     one W4A4, one ragged
     case), with inputs built to land on LSQ and StatsQ rounding ties;
  4. K2, the fused QKR attention core, against its plain version at
     B=64, N=198, H=6, C=384, d=64 (shared and per-head lhs, LSQ on/off);
  5. the slice: DeiT-S distilled W2A2 QKR at full width (random weights from
     a seeded torch.Generator), calibrated on a seeded batch of 64 and served
     through `Predictor` with both kernels, launch counts read around one
     predict call; the same model through the plain versions on the card
     must agree block by block and on top-1 for at least 95 % of 4 seeded
     batches; img/s over 10 calls after 3 warm-ups.
The line before the last is a JSON object with every kernel's numbers
(times in ms, CUDA events; bounds from the H100 SXM data sheet); the last
line is {"ok": true, "device": {...}}.  Full results also go to
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
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        f"{torch.cuda.get_device_name(0)}, power limit not read")
    # fp32 products in full fp32 for the plain versions (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return card


# ---------------------------------------------------------------- phase 2
def phase_build():
    from ofq_tpu_torch.ops import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    dt = time.perf_counter() - t0
    for name in _build.SOURCES:
        _build.load(name)
        for line in reports.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {len(_build.SOURCES)} kernels built in {dt:.1f} s "
        f"into {_build.BUILD_DIR}")
    return dt


# ---------------------------------------------------------------- phase 3
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
    n = 2 ** (w_bits - 1)
    w = torch.randn(K, N, generator=g) / K ** 0.5
    t = torch.randint(0, n // 2 + 1, (K // 2, N // 2), generator=g) / n
    ties = torch.cat([0.5 - t, 0.5 + t], 0)
    ties = ties * (torch.randint(0, 2, (K, N // 2), generator=g) * 2 - 1)
    w[:, : N // 2] = ties
    b_post = torch.randn(K, generator=g) * 0.05
    bias = torch.randn(N, generator=g) * 0.1
    return [a.to(dev) for a in (x, s, b_pre, w, b_post, bias)]


def phase_k1(dev, n_tok_main, batch=BATCH):
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
        xq = (torch.round(torch.clamp(
            (x + b_pre) / s.repeat(M // n_tok)[:, None], a_lo, a_hi))
            * s.repeat(M // n_tok)[:, None]).contiguous()
        mm_ms = median_ms(lambda: torch.matmul(xq, wq))
        nbytes = 4 * (M * K + K * N + M * N + n_tok + K + 2 * N)
        flops = 2 * M * K * N
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        log(f"[K1] {name:10s} M={M} K={K} N={N} W{bits}A{bits}"
            f"{' unsigned' if all_pos else ''}: max|diff| {err:.3e} "
            f"(bound {1e-5 * scale:.3e}), {n_ties} LSQ and {w_ties} StatsQ "
            f"ties; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul(x_q, w_q) "
            f"{mm_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        results.append(dict(name=name, M=M, K=K, N=N, bits=bits,
                            all_positive=all_pos, main_path=main,
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


# ---------------------------------------------------------------- phase 5
def phase_slice(dev, name="deit_small_distilled_patch16_224", batch=BATCH):
    import numpy as np
    import torch
    from ofq_tpu_torch import ops
    from ofq_tpu_torch.calibrate import calibrate
    from ofq_tpu_torch.models import create_model
    from ofq_tpu_torch.models.deit import VARIANTS
    from ofq_tpu_torch.ops import fused_qlinear as fq
    from ofq_tpu_torch.quant import w2a2_qkr_policy
    from ofq_tpu_torch.serve import Predictor

    t0 = time.perf_counter()
    cfg = VARIANTS[name]
    img, depth, classes = cfg.img_size, cfg.depth, cfg.num_classes
    model = create_model(
        name, policy=w2a2_qkr_policy(depth), device=dev,
        generator=torch.Generator().manual_seed(0), head_std=0.02,
        matmul_impl="fused", attn_impl="fused")
    rng = np.random.default_rng(0)
    calib = rng.normal(size=(batch, img, img, 3)).astype(np.float32)
    images = rng.normal(size=(batch, img, img, 3)).astype(np.float32)
    calibrate(model, calib)
    torch.cuda.synchronize()
    log(f"[slice] {name} W2A2 QKR, fused QLinear + fused attention, "
        f"{sum(p.numel() for p in model.parameters())} params, built and "
        f"calibrated in {time.perf_counter() - t0:.1f} s")
    pred = Predictor(model, batch_size=batch, img_size=img, device=dev)

    ops.reset_launch_counts()
    probs = pred.predict(images)
    launches = {"fused_qlinear_fwd": fq.fused_qlinear_fwd.launches,
                "qkr_attention_fwd": ops.qkr_attention_fwd.launches}
    shapes = dict(fq.fused_qlinear_fwd.launch_shapes)
    log(f"[slice] launches in one predict: {launches}; K1 by (M,K,N): "
        f"{ {str(k): v for k, v in shapes.items()} }")
    if (launches["fused_qlinear_fwd"] != 3 * depth
            or launches["qkr_attention_fwd"] != depth):
        raise AssertionError(f"expected {3 * depth} K1 and {depth} K2 "
                             f"launches: {launches}")
    if not (probs.shape == (batch, classes) and np.isfinite(probs).all()
            and np.allclose(probs.sum(-1), 1.0, atol=1e-4)):
        raise AssertionError(f"predictions are not finite ({batch}, "
                             f"{classes}) probability rows")

    # Kernel path vs plain path.  K2 and its plain version sum in fp32 in
    # different orders, so now and then a probability crosses an LSQ
    # boundary and moves one 2-bit level, and the random-weight W2A2 model
    # carries such a move on through the later blocks and scrambles that
    # image's top-1.  So (a) each block is held alone, on the plain path's
    # input to it (at most 0.1 % of its (image, token) rows may differ
    # beyond 1e-4 * (1 + |ref|), the bound of phase 4); (b) end to end, on
    # CMP_BATCHES seeded batches, top-1 agreement with the plain path at
    # least 95 %, printed beside the number of images whose probabilities
    # differ at all and both paths' agreement with the composed model run
    # in fp64 on the card (how far fp32 rounding alone moves top-1).
    blocks = check_blocks(model, images, dev)
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
    if not np.isfinite(p_k).all() or agree < 0.95:
        raise AssertionError(f"top-1 agreement {agree} < 0.95")

    def rate(n_calls=10):
        for _ in range(3):
            pred.predict(images)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n_calls):
            pred.predict(images)
        torch.cuda.synchronize()
        return batch * n_calls / (time.perf_counter() - t)

    img_s = rate()
    model.use_kernels = False
    img_s_plain = rate()
    model.use_kernels = True
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[slice] Predictor.predict, B={batch}: {img_s:.1f} img/s with the "
        f"kernels, {img_s_plain:.1f} img/s through the plain versions; "
        f"peak device memory {peak_gb:.2f} GB")
    prof = phase_profile(pred, images) if "--profile" in sys.argv else None
    return dict(profile=prof, launches=launches,
                launch_shapes={str(k): v for k, v in shapes.items()},
                compared_images=len(p_k), images_differing=touched,
                blocks=blocks,
                top1_agreement=agree, top1_agreement_fp64=agree_64,
                max_prob_diff=max_diff,
                img_per_s=img_s, img_per_s_plain=img_s_plain,
                peak_mem_gb=peak_gb)


def check_blocks(model, images, dev, limit=1e-3):
    """Each block through the kernels against the same block through the
    plain versions, on the plain path's input to that block."""
    import torch
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
    fracs = []
    with torch.inference_mode():
        for name, (x, ref) in zip(model.block_names, seen):
            y = getattr(model, name)(x)
            if not torch.isfinite(y).all():
                raise AssertionError(f"{name}: non-finite output")
            rows = ((y - ref).abs() > 1e-4 * (1 + ref.abs())).any(-1)
            fracs.append(float(rows.float().mean()))
    log(f"[slice] each block alone, kernels vs plain on the same input: "
        f"share of (image, token) rows outside 1e-4*(1+|ref|) "
        f"{[f'{f:.2e}' for f in fracs]}")
    if max(fracs) > limit:
        raise AssertionError(f"a block differs in more than {limit} of its "
                             f"rows: {fracs}")
    return fracs


def composed_fp64_probs(model, batches, dev):
    """The same weights and scales through the composed path in fp64."""
    import copy
    import numpy as np
    import torch
    ref = copy.deepcopy(model).double()
    for m in ref.modules():
        for attr in ("matmul_impl", "attn_impl"):
            if hasattr(m, attr):
                setattr(m, attr, None)
    out = []
    with torch.inference_mode():
        for b in batches:
            x = torch.from_numpy(b).to(dev, torch.float64)
            out.append(torch.softmax(ref(x), dim=-1).cpu().numpy())
    del ref
    return np.concatenate(out)


# ------------------------------------------------- optional: --profile
def phase_profile(pred, images, n_calls=3):
    """Device time by kernel over `n_calls` predict calls (torch.profiler)
    and the device's idle share of the window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pred.predict(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            pred.predict(images)
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
    log(f"[profile] per predict call: wall {per_call:.2f} ms, device busy "
        f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / per_call):.3f}")
    for ms, calls, key in rows[:15]:
        log(f"[profile] {ms:8.3f} ms {100 * ms / busy:5.1f} %  x{calls:<4d} "
            f"{key[:90]}")
    return dict(wall_ms_per_call=per_call, device_busy_ms_per_call=busy,
                rows=[dict(ms=ms, calls=c, name=k) for ms, c, k in rows])


def main() -> int:
    t_start = time.perf_counter()
    sys.path.insert(0, HERE)
    import torch
    card = phase_device()
    log(card)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build_s = phase_build()
    from ofq_tpu_torch.models.deit import DEIT_SMALL
    n_tok = DEIT_SMALL.n_tokens  # 14 * 14 patches + cls + dist = 198
    k1 = phase_k1(dev, n_tok)
    k2 = phase_k2(dev, n_tok)
    sl = phase_slice(dev)

    k1_src = ("ofq_tpu_torch/csrc/fused_qlinear.cu",
              "ofq_tpu/ops/fused_qlinear.py:71")
    k2_src = ("ofq_tpu_torch/csrc/fused_attention.cu",
              "ofq_tpu/ops/fused_attention.py:81")
    kernels = []
    for r in k1:
        if r["main_path"]:
            kernels.append(dict(
                name=f"fused_qlinear_fwd {r['name']} "
                     f"({r['M']}x{r['K']}x{r['N']})",
                route="cuda", source=k1_src[0], replaces=k1_src[1],
                launches=sl["launch_shapes"].get(
                    str((r["M"], r["K"], r["N"])), 0),
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=None))
    for r in k2:
        if r["main_path"]:
            kernels.append(dict(
                name="qkr_attention_fwd (shared lhs, LSQ on, "
                     f"{r['B']}x{r['N']}x{r['H']}x{r['K']}, d={r['d']})",
                route="cuda", source=k2_src[0], replaces=k2_src[1],
                launches=sl["launches"]["qkr_attention_fwd"],
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=None))
    if any(k["launches"] <= 0 for k in kernels):
        raise AssertionError(f"a kernel of the path was not launched: "
                             f"{kernels}")
    full = dict(card=card, build_s=build_s, k1=k1, k2=k2, slice=sl,
                seconds=time.perf_counter() - t_start)
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
