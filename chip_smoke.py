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
     plain; peak device memory.
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
    prof = (phase_profile(lambda: pred.predict(images), "predict call")
            if "--profile" in sys.argv else None)
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


# ---------------------------------------------------------------- phase 6
TRAIN_STEPS_TIMED, TRAIN_STEPS_WARM = 5, 2
# whole-step gradient gate: for every parameter, the kernel path's
# relative L2 distance from the composed fp64 gradient may be at most
# twice the plain path's plus a floor; the floor is the median over
# parameters of the plain path's distance (how far fp32 rounding alone
# moves a gradient of this chaotic random-weight W2A2 model in this run),
# and never below GRAD_GATE_MIN_FLOOR
GRAD_GATE_MIN_FLOOR = 1e-3


def phase_train(dev, name="deit_small_distilled_patch16_224", batch=BATCH):
    """One QAT train step of DeiT-S W2A2 QKR with the float teacher, KD
    soft+hard and AdamW, through K1 and K2 (forward) and K3 (backward)."""
    import numpy as np
    import torch
    from ofq_tpu_torch import ops
    from ofq_tpu_torch.calibrate import calibrate
    from ofq_tpu_torch.models import create_model
    from ofq_tpu_torch.models.deit import VARIANTS
    from ofq_tpu_torch.ops import fused_qlinear as fq
    from ofq_tpu_torch.quant import QuantPolicy, w2a2_qkr_policy
    from ofq_tpu_torch.train import (TrainState, cosine_with_warmup_cooldown,
                                     make_optimizer, make_train_step)

    t0 = time.perf_counter()
    cfg = VARIANTS[name]
    student = create_model(
        name, policy=w2a2_qkr_policy(cfg.depth), device=dev,
        generator=torch.Generator().manual_seed(0), head_std=0.02,
        matmul_impl="fused", attn_impl="fused")
    teacher = create_model(name, policy=QuantPolicy(), device=dev,
                           generator=torch.Generator().manual_seed(1))
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
    log(f"[train] {name} W2A2 QKR student (fused QLinear + fused attention) "
        f"and float teacher built, calibrated in "
        f"{time.perf_counter() - t0:.1f} s")

    ops.reset_launch_counts()
    state, metrics = step(state, data)
    torch.cuda.synchronize()
    launches = {"fused_qlinear_fwd": fq.fused_qlinear_fwd.launches,
                "qkr_attention_fwd": ops.qkr_attention_fwd.launches,
                "qkr_attention_bwd": ops.qkr_attention_bwd.launches}
    shapes = {str(k): v for k, v in fq.fused_qlinear_fwd.launch_shapes.items()}
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    log(f"[train] launches in one step: {launches}; K1 by (M,K,N): {shapes}; "
        f"loss {loss:.6f}, grad_norm {gnorm:.6f}")
    d = cfg.depth
    if launches != {"fused_qlinear_fwd": 3 * d, "qkr_attention_fwd": d,
                    "qkr_attention_bwd": d}:
        raise AssertionError(f"expected {3 * d} K1, {d} K2 and {d} K3 "
                             f"launches per step: {launches}")
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        raise AssertionError(f"loss {loss}, grad_norm {gnorm}")

    blocks = check_blocks_backward(student, teacher, data)
    grads = check_step_grads(student, teacher, data)

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
    return dict(profile=prof, launches=launches, launch_shapes=shapes,
                loss=loss, grad_norm=gnorm, blocks=blocks, grads=grads,
                img_per_s=img_s, img_per_s_plain=img_s_plain,
                peak_mem_gb=peak_gb)


def _kd_loss(model, teacher, x, label):
    import torch
    from ofq_tpu_torch.train import kd_soft_and_hard
    with torch.no_grad():
        t_logits = teacher(x)
    return kd_soft_and_hard(model(x), label, t_logits)


def check_blocks_backward(model, teacher, data, limit=1e-3):
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
    fracs = []
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
        rows = ((dx[0] - dx[1]).abs() > 1e-4 * (1 + dx[1].abs())).any(-1)
        fracs.append(float(rows.float().mean()))
    log(f"[train] each block's backward alone, kernels vs plain on the same "
        f"input and upstream gradient: share of (image, token) rows of dx "
        f"outside 1e-4*(1+|ref|) {[f'{f:.2e}' for f in fracs]}")
    if max(fracs) > limit:
        raise AssertionError(f"a block's dx differs in more than {limit} of "
                             f"its rows: {fracs}")
    return fracs


def check_step_grads(model, teacher, data):
    """The whole step's parameter gradients through the kernels and through
    the plain versions, each against the composed model in fp64 on the
    card (the same weights, scales and batch)."""
    import copy
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
    ref = copy.deepcopy(model).double()
    for m in ref.modules():
        for attr in ("matmul_impl", "attn_impl"):
            if hasattr(m, attr):
                setattr(m, attr, None)
    t64 = copy.deepcopy(teacher).double()
    g_64 = grads(ref, t64, data["image"].double())
    del ref, t64
    rows = []
    for n, g in g_64.items():
        norm = max(float(g.norm()), 1e-30)
        rows.append(dict(name=n, rel_kernels=float((g_k[n] - g).norm()) / norm,
                         rel_plain=float((g_p[n] - g).norm()) / norm))
    rk_all = sorted(r["rel_kernels"] for r in rows)
    rp_all = sorted(r["rel_plain"] for r in rows)
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
        f"{glob['plain']:.3e}; gate kernels <= 2 x plain + {floor:.3e}")
    bad = [r for r in rows if r["rel_kernels"] > 2 * r["rel_plain"] + floor]
    if bad or glob["kernels"] > 2 * glob["plain"] + floor:
        raise AssertionError(f"gradient gate failed: {bad[:5]}, {glob}")
    return dict(floor=floor, all_params=glob, per_param=rows)


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
    k3 = phase_k3(dev, n_tok)
    sl = phase_slice(dev)
    torch.cuda.empty_cache()
    tr = phase_train(dev)

    k1_src = ("ofq_tpu_torch/csrc/fused_qlinear.cu",
              "ofq_tpu/ops/fused_qlinear.py:71")
    k2_src = ("ofq_tpu_torch/csrc/fused_attention.cu",
              "ofq_tpu/ops/fused_attention.py:81")
    k3_src = ("ofq_tpu_torch/csrc/fused_attention_bwd.cu",
              "ofq_tpu/ops/fused_attention.py:102")
    kernels = []
    for r in k1:
        if r["main_path"]:
            kernels.append(dict(
                name=f"fused_qlinear_fwd {r['name']} "
                     f"({r['M']}x{r['K']}x{r['N']})",
                route="cuda", source=k1_src[0], replaces=k1_src[1],
                launches=tr["launch_shapes"].get(
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
                launches=tr["launches"]["qkr_attention_fwd"],
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=None))
    for r in k3:
        if r["main_path"]:
            kernels.append(dict(
                name="qkr_attention_bwd (shared lhs, LSQ on, "
                     f"{r['B']}x{r['N']}x{r['H']}x{r['K']}, d={r['d']})",
                route="cuda", source=k3_src[0], replaces=k3_src[1],
                launches=tr["launches"]["qkr_attention_bwd"],
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=None))
    if any(k["launches"] <= 0 for k in kernels):
        raise AssertionError(f"a kernel of the path was not launched: "
                             f"{kernels}")
    full = dict(card=card, build_s=build_s, k1=k1, k2=k2, k3=k3, slice=sl,
                train=tr, seconds=time.perf_counter() - t_start)
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
