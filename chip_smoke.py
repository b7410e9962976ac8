#!/usr/bin/env python3
"""Chip smoke test of ofq_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repo root; needs one CUDA card
    python3 chip_smoke.py --profile  # also: device time by kernel (torch.profiler)
    python3 chip_smoke.py --baseline DIR
        # also: K1's-K8's sources as an earlier tree DIR
        # has them (a `git archive` of that commit), built and timed beside
        # the current ones at the same shapes in the same run

Phases (any failure raises and the script exits non-zero):
  1. device: require CUDA and `nvidia-smi`'s name and power limit of the
     card (printed beside the results; no result without them);
  2. build: compile every CUDA kernel from ofq_tpu_torch/csrc/ (one nvcc
     per source, in parallel); print ptxas's report (registers, spills) of
     K1's, K4's and K3's sources and the tensor-core instructions of each
     kernel that runs its products there (TC_KERNELS: HGMMA, wgmma, in K1;
     HMMA, mma.sync, in K3-bf16's passes and K6-K8; UTMALDG, TMA loads, in
     K6), read from the built library with cuobjdump, and fail if one has
     none;
  3. K1, the fused QLinear kernel (wgmma on the integer codes), against its
     plain PyTorch version on the card at the DeiT-S shapes, M = 64 * 198
     tokens (proj, fc1, fc2 and, without QKR, qkv at W2A2, one W4A4, one
     ragged case), with
     inputs built to land on LSQ and StatsQ rounding ties; elements
     differing counted (0 while the integer sums stay below 2^24);
  4. K2, the fused QKR attention core, against its plain version at
     B=64, N=198, H=6, C=384, d=64 (shared and per-head lhs, LSQ on/off),
     in fp32 and in the bf16 stream (`k2_gate`; K2's score tile, which K3's
     pass A shares, register-tiled on the CUDA cores in both streams);
     K3, its backward, the same way (K3-bf16's products on the tensor
     cores but for the score tile, K3 fp32 register-tiled);
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
  5b, 6b. the same serving and train step with the fused kernels in the
     bf16 stream (FUSED_BF16: bench.py's `matmul_impl="fused"` bf16 row,
     fp32 masters, bf16 teacher): the same launch counts, the bf16 gates;
  6c. the CGA finetune step (phase 2 of train_scripts/deit_s/
     w2a2_deit_s.sh: qk_reparam_type=1, boundary range 0.005, the learning
     rate pinned at 1e-5) of the same student in FUSED (fp32 masters) and
     in FUSED_BF16 (bf16 masters, EMA 0.9999, AGC 0.01): 3 steps, each with
     the plain step's launches (36 K1, 12 K2, 12 K3), no frozen entry's
     bits changed, the masks against the CPU's from the same fp32 masters
     (equal but within 2 fp32 ulps of a band edge), a trainable share in
     (0, 0.1) per selected kernel, zero moments for the entries frozen at
     every step, (fp32) a moved trainable entry in every selected kernel,
     (bf16) bf16 masters, fp32 moments and the EMA recomputed bit for bit;
     the eval step over 256 seeded images (the last batch padded by 8
     rows of label -1) against the Predictor's top-1 and top-5 hits; the
     step's wall ms beside the same step without CGA; under FUSED the
     self-check (`restore_frozen` taking the new value must trip the
     frozen-bits gate, `mask_grads` as the identity the moments gate, the
     unmodified step must pass; one `[selfcheck]` line each);
  7. K4, the StatsQ matmul kernel, and K5, its dx product, against their
     plain versions in fp32 and bf16 at the DeiT-S shapes (proj, fc1, fc2,
     K4 also qkv
     with M = 64 * 198) and one ragged shape, with StatsQ ties built in;
     the pre-pass's Q(W) against `_quant_tile` bit for bit;
  8. pallas serving: the same DeiT-S student with matmul_impl="pallas" in
     the bf16 stream (compute_dtype="bfloat16", the configuration of
     bench.py's `_rate(matmul_impl="pallas", compute_dtype="bfloat16")`)
     through `Predictor`: exactly 36 K4 launches per forward and none of
     K1-K3, the bf16 gates, img/s;
  9. pallas training: bench.py's pallas step (bf16 stream, fp32 masters,
     bf16 float teacher, KD soft+hard, AdamW, its seeded batch of 64 on the
     device): exactly 36 K4 launches per step and none of K1-K3, the bf16
     gates, img/s, peak memory; then K5 on the 36 dx products of one
     backward of this step (upstream gradients and weights captured with
     hooks) against its plain version and against the dx that the
     backward computed;
  9b. the gate self-check: deliberate faults wrapped around the real
     kernels (K4 with one output column moved by one weight level, K4
     with one 16-deep slice of its contraction left out, K2 reading the
     scale of row n + 1, K2 with the same slice of its scores' contraction
     left out (the block gate and K2's own gate, `k2_gate`), K2 in its
     per-head form reading head h + 1's q (the fp32 block gate of the
     student without QKR), K3 with ds doubled, K3 with dlhs doubled, K3 with dv zeroed over 16 keys of one
     head), each of which must trip the bf16 gates it aims at, and on a
     Swin-T path K4 with one output column moved by one weight level in
     stage 2's fc1 alone, which must trip the Swin-T block gate
     (SWIN_GATE), then the unmodified kernels, which must pass them; one
     line per result;
 10. K6, K7, K8, the Swin window-attention tail kernels of the lab bench
     (benchmarks/window_attn_lab.py), against their plain version at the
     lab's shapes (Swin-T stage 0 at batch 64: 4096 windows of 49 tokens,
     3 heads of 32, bf16) on the lab's seeded data, each at each lab
     parameter set, with times, the plain version's, SDPA's on the same
     q, k, v (the same function: the kernels' library time) and the
     bound; all three run on the tensor cores (TC_KERNELS: HMMA), K6 with
     TMA loads; K6's three ablation forms (nodots, nosm, scoresonly)
     against their plain versions (nodots bit-exact; scoresonly within one
     bf16 ulp plus the fp32 summation bound; nosm under the tail gate with
     p := s), timed, with their bounds;
 10a. K6's nosm and scoresonly forms under their gates on data drawn from
     the card tests' seeds 4-8 at the lab's shape (`[K6 seed]` lines), and
     K6 in every form against the tile emulated with the card's
     accumulator (`mma_sum`; `[K6 emulated]`: the elements whose bits
     differ, 0 required where no exp enters, and the emulated and the
     kernel's worst |diff| / limit);
 10b. the port's lab entry point (ofq_tpu_torch.benchmarks.
     window_attn_lab): all 17 of the lab's variants once at its shapes
     with its check (< 5e-2 against its XLA tail); no variant may raise
     or fail, and every K6-K8 kernel and K6 form must launch;
 11. float Swin-T serving: the float model (the student's warm start and
     teacher) in the bf16 stream with bf16 parameters through `Predictor`,
     no kernel in its forward; K6-K8 at their default parameters on the
     q, k, v of its two stage-0 blocks, captured with forward hooks (two
     launches each); img/s, peak memory;
 12. K4 at Swin-T's 19 shapes, qkv's among them (M = 200 704 rows and
     K = 96 at stage 0)
     in bf16 against its plain version;
 13. Swin-T W2A2 QKR serving, matmul_impl="pallas" in the bf16 stream
     (the student of train_scripts/swin_t/w2a2_swin_t.sh), calibrated on a
     seeded batch, through `Predictor`: exactly 39 K4 launches per forward
     (3 per block and one per patch merging) and none of K1-K3 or K6-K8,
     the bf16 block (each block and patch merging alone) and top-1 gates,
     img/s, peak memory;
 13b. the Swin-T QAT train step, pallas bf16 at B=64 with drop_path 0.0
     (bench.py's Swin rows; fp32 masters, the float Swin-T teacher in
     bf16, KD soft+hard on non-distilled logits, AdamW): exactly 39 K4 a
     step and nothing else, finite loss and gradient norm, each block's
     and patch merging's backward under SWIN_GATE, the whole-step rule as
     it stands (2 x the order spread + the floor, the composed fp64 Swin-T
     beside it), the relative-position bias tables' readings printed,
     img/s kernels and plain, peak memory;
 13c. the Swin-T CGA finetune step (phase 2 of w2a2_swin_t.sh:
     model_type "swin", qk_reparam_type=1, boundary 0.005, lr 1e-5),
     pallas bf16 with fp32 masters: the selection with the 3 reductions,
     3 gated steps (`cga_steps`), the eval step against the Predictor,
     wall ms beside the step without CGA;
 13d. dropout and drop-path (`phase_dropout`): the DeiT-S fused fp32 step
     with drop_rate = drop_path_rate = 0.1 and a CUDA generator (36 K1,
     12 K2, 12 K3; every mask's kept share within KEPT_SIGMAS of keep; the
     default CUDA generator untouched), two steps seeded alike bit-equal,
     another seed not; attn_drop_rate 0.1: no K2 or K3 in the train step,
     12 K2 in eval; one Swin-T pallas step at drop_path_rate 0.2 (39 K4);
 13e. remat (`phase_remat`), dropout on: DeiT-S fused fp32 with remat=True
     and with attn_impl='remat', Swin-T pallas with remat_stages=(0, 1, 2,
     3) and with attn_impl='remat', each one's loss and gradients bit-equal
     to the same step without remat, peak memory of both; a BatchNorm
     DeiT-S step with and without remat=True (`bn_remat_step`): every
     parameter and running statistic bit-equal (they move once a step).
 13g. the LN->BN swap, the oscillation hook, per-layer gradient norms and
     the MLP activations besides GELU, at full width: DeiT-S W2A2 QKR with
     norm_layer="batchnorm" fused fp32 (`phase_bn`): one step (36 K1, 12
     K2, 12 K3; `per_layer_grad_norms`, the squares summing to grad_norm's
     within 1e-5) under phase_train's gates, the running statistics'
     updates held by the whole-step rule as the gradients are, then served
     in eval mode through them (36 K1, 12 K2); Swin-T with the swap,
     pallas bf16: one step (39 K4) under SWIN_GATE, its statistics'
     updates against the rounded-once reference; the oscillation hook
     (`phase_oscillation`): DeiT-S fused bf16, bf16 masters, EMA, 3 steps
     with momentum 0.5 and threshold 0.4 (36 K1, 12 K2, 12 K3 each), every
     frozen entry's image its frozen integer, the hook's update against
     the same on the CPU from the masters it read, the per-layer norms
     (bf16: 2^-6), wall ms beside the step without it; prelu and rprelu
     fused fp32 steps (36 K1, 12 K2, 12 K3) under phase_train's gates (the
     `act` parameters' gradients among the whole step's), relu and
     'None' fused fp32 serving (36 K1, 12 K2).
 13f. the students without QKR (train_scripts' W2A2 flags with
     --qk_reparam dropped: `QAttention`, whose fused tail runs K2 and K3
     in their per-head form, lhs = q, K = d = 64) and with full-LSQ
     weights (--wq-mode lsq: `LsqLinear`, plain products), at full depth:
     DeiT-S fused fp32 serving (48 K1 and 12 K2 a forward) and train step
     (48 K1, 12 K2, 12 K3), the fused bf16 step, the pallas bf16 step (48
     K4), the full-LSQ fused fp32 step (12 K2, 12 K3, no K1), each under
     phase_slice's and phase_train's gates; the telemetry losses on the
     QKR student, fused fp32, with the float teacher built alike: kd_qk
     and kd_qkv (`qqkkvv`: 36 K1, the composed attention, no K2 or K3)
     and kd_token (`return_features`: 36 K1, 12 K2, 12 K3), each loss
     beside its plain path's and the fp64 model's (the kernel path's no
     farther from the fp64 loss than 2 x the plain path's + 1e-4 of it)
     and the whole-step rule on that loss; Swin-T without QKR pallas bf16
     serving and train step (51 K4: qkv, proj, fc1, fc2 of 12 blocks and 3
     reductions) under SWIN_GATE; then, after phase 14, the int8 serving
     of DeiT-S without QKR (48 int8_mm) and the frozen packed artifact of
     the full-LSQ student (`export_packed(..., wq_mode="lsq")`: every W2
     block kernel's codes equal to those the integer core rebuilds from
     the restored `weight_quant.s` and to the live student's, served
     through `Predictor.from_packed(int_core=True)`: 48 int8_mm).
The int8 path (bench.py's int8 configuration, INT8: matmul_impl="int8",
composed attention, bf16 stream; no TPU kernel lies on it, its integer
product `int8_mm` is torch._int_mm, a library call):
 14. int8_mm against its plain version at every shape of the int8 paths
     (DeiT-S at B = 64 and 256, Swin-T at B = 64), codes at the ends of
     the W2A2 and W4A8 ranges: 0 elements differing; the median of 20
     calls, the plain version's, the bf16 torch.matmul of the dequantized
     operands', the bound;
 15. DeiT-S int8 serving through `Predictor`: exactly 60 int8_mm a
     forward (v, qkx, proj, fc1, fc2 of 12 blocks) and no kernel, the bf16
     gates against this path's plain version, the same bits through the
     plain product in every block output and the logits, top-1 agreement
     with the composed products printed, img/s, peak memory; then the int8
     gate self-check (int8_mm with one output column moved by one code
     step must trip the 0-differing gate and the block gate, the
     unmodified product must pass both);
 16. a frozen packed artifact of that student (`deploy.export_packed` on
     the card, `Predictor.from_packed(int_core=True)`): its codes equal to
     those the integer core rebuilds and to the live student's, the gates
     of phase 15, img/s at B = 64 and 256, artifact bytes against fp32
     bytes, and one forward through its fp products (int_core=False);
 17. bench.py's int8 train step (fp32 masters, bf16 teacher, KD
     soft+hard, AdamW, B = 64): 60 int8_mm a step, the bf16 step gates,
     every whole-step gradient bit-identical through the plain product;
 18. Swin-T int8 serving (63 int8_mm a forward: 12 blocks x 5 and 3
     reductions) and its frozen artifact, as phases 15 and 16 at B = 64;
 19. bench.py's Swin-T int8 train step at B = 48 (drop_path 0.0): 63
     int8_mm a step, the bf16 step gates under SWIN_GATE, every whole-step
     gradient bit-identical through the plain product;
every path's int8_mm launches by shape held to phase 14's count.
The training CLI (`phase_cli`, in a temporary directory, synthetic data):
 20. the recipe train_scripts/deit_s/w2a2_deit_s.sh through
     `cli.train.main` / `cli.cga.main` / `cli.eval.main` / `serve.main`
     at DeiT-S width, B = 64, 2 steps an epoch: (a) the float DeiT-S from
     seed 0 written as the original layout's `.pth.tar`, the warm start
     and the teacher loaded from it bit for bit (q/k/v the thirds of the
     file's qkv); (b) phase 1 with --matmul-impl fused --attn-impl fused,
     2 epochs: 36 K1 + 12 K2 + 12 K3 each step, the epoch-0 checkpoint
     the same bits as the steps composed from the loaded start; (c)
     auto-resume to epoch 2, restored bit for bit; (d) the CGA command
     from phase 1: no frozen entry's bits change, the rate min_lr at every
     step; (e) eval equal to `Predictor.from_experiment`; (f) serving,
     `--export`, `--artifact --int-core` (its codes the integer core's
     and the live student's, 60 int8_mm a forward); (g) Swin-T through
     its recipe without the warm-start flags, --matmul-impl pallas
     --compute-dtype bfloat16, one epoch: 39 K4 a step and a forward.
     One `[cli]` line each (wall s, steps, launches, checkpoint bytes,
     save and restore GB/s); the K1, K2, K3 and Swin-T K4 entries of the
     kernels line carry their launches there (`cli_launches`), the int8
     line the integer-core forward's.
The agreement gates: fp32, the kernel path against the plain path; bf16,
each path against a rounded-once reference (the plain path with every
product summed in fp64 and rounded once to the dtype it returns), the
kernel path no farther from it than the plain path allows (BLOCK_ROWS and
what follows it), and each whole-step gradient no farther than twice its
order spread (the plain path summed in other legitimate fp32 orders,
`summed_in_chunks`) plus a floor.
Phase 4b prints the device time of K3's four passes at the main path's
case in each stream (torch.profiler).
With --baseline, phases 3, 4, 4b, 7, 9, 10 and 12 also time the earlier
tree's K1, K2 and K3 (both streams; K3's passes too), K4 and K5 (both
streams, DeiT-S's and Swin-T's shapes, K5 also on the captured dx
products), K6 (every form), K7 and K8 at the same shapes, both through
their C launchers alone, count the output elements where the two differ,
and the run ends with the sums over K1's to K5's launches on their paths
and K6's, K7's and K8's times per launch.  The
line before the last is a JSON object with every kernel's numbers (times
in ms, CUDA events; bounds from the H100 SXM data sheet), after a line
with the int8 paths' int8_mm entries ({"int8_mm": [...]}); the last line
is {"ok": true, "device": {...}}.  Full results also go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import functools
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
# the three configurations of the DeiT-S W2A2 QKR student that the script
# drives: the fused kernels K1-K3 in fp32 and in the bf16 stream (bench.py's
# `matmul_impl="fused"` bf16 row), and bench.py's pallas step (K4 in every
# quantized linear, the composed attention tail) in bf16
FUSED = dict(matmul_impl="fused", attn_impl="fused", compute_dtype=None)
FUSED_BF16 = dict(FUSED, compute_dtype="bfloat16")
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
# the sources whose ptxas report the build phase prints
REPORT_SOURCES = ("fused_qlinear", "pallas_statsq", "fused_attention_bwd")
# the kernels that run their products on the tensor cores, by source: a
# part of the (mangled) kernel name and the SASS instruction it must hold
# (HGMMA: wgmma; HMMA: mma.sync)
TC_KERNELS = {
    "fused_qlinear": [("_tc_kernel", "HGMMA")],
    "fused_attention_bwd": [("qkr_bwd_rows_tc_kernel", "HMMA"),
                            ("qkr_bwd_cols_tc_kernel", "HMMA"),
                            ("qkr_bwd_dlhs_tc_kernel", "HMMA")],
    # K7 and K8: window_attn_tc_kernel on either shared-memory layout; K6:
    # units_tc_kernel<form> in each form with a product (the
    # full tail 7, nosm 5, scoresonly 1; nodots, 2, has none), and in every
    # form its loads by TMA (UTMALDG)
    "window_attention": [("Swizzled64", "HMMA"), ("Slotted80", "HMMA"),
                         ("units_tc_kernelILi7E", "HMMA"),
                         ("units_tc_kernelILi5E", "HMMA"),
                         ("units_tc_kernelILi1E", "HMMA"),
                         ("units_tc_kernel", "UTMALDG")],
}
# the SASS instructions mma_counts counts: wgmma, mma.sync, TMA loads
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG")


def _cuobjdump():
    from ofq_tpu_torch.ops import _build
    return os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")


def mma_counts(lib_path):
    """HGMMA (wgmma), HMMA (mma.sync) and UTMALDG (TMA load) instructions
    in each kernel of a built library, from its SASS (cuobjdump -sass)."""
    out = subprocess.run([_cuobjdump(), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {lib_path}: {out.stderr}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op in SASS_OPS:
                if op in line:
                    counts[fn][op] += 1
    return counts


def phase_build():
    from ofq_tpu_torch.ops import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    dt = time.perf_counter() - t0
    for name in _build.SOURCES:
        _build.load(name)
        for line in reports.get(name, "").splitlines():
            if (name in REPORT_SOURCES and "ptxas" in line) or (
                    "registers" in line or "spill" in line):
                log(f"[build] {name}: {line.strip()}")
    tc = {}
    for src, wanted in TC_KERNELS.items():
        counts = mma_counts(_build._lib_path(src))
        for part, op in wanted:
            found = {fn: c[op] for fn, c in counts.items() if part in fn}
            for fn, n in found.items():
                log(f"[build] {src}: {n} {op} instructions in {fn}")
            if not found or not all(found.values()):
                raise AssertionError(f"{src}: a tensor-core kernel "
                                     f"({part}) without {op}: {found}")
            tc.update({f"{src}:{fn}": {op: n} for fn, n in found.items()})
    log(f"[build] {len(_build.SOURCES)} kernels built in {dt:.1f} s "
        f"into {_build.BUILD_DIR}")
    return dict(seconds=dt, tensor_core_instructions=tc,
                ptxas={n: reports.get(n, "") for n in REPORT_SOURCES})


# the sources that --baseline builds from the earlier tree: K1, K2, K3,
# K4 and K5, K6-K8
BASELINE_SOURCES = ("fused_qlinear", "fused_attention", "fused_attention_bwd",
                    "pallas_statsq", "window_attention")


def build_baseline(root):
    """The BASELINE_SOURCES of an earlier tree (`root`, a `git archive` of
    that commit), built with the current flags into root/_build_baseline
    (one nvcc each, all at once; a source finds its headers in its own
    csrc/); returns their libraries by name."""
    import ctypes
    from ofq_tpu_torch.ops import _build
    out_dir = os.path.join(root, "_build_baseline")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in BASELINE_SOURCES:
        src = os.path.join(root, "ofq_tpu_torch", "csrc", f"{name}.cu")
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        out, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"baseline {name}.cu failed to build:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[baseline] {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(lib)
    log(f"[baseline] built {', '.join(BASELINE_SOURCES)} of {root}")
    return libs


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


def raw_k2(lib, args):
    """K2's C launcher for the stream dtype of `args` (qkr_attention_fwd's)
    in `lib` (the current tree's or an earlier one's: the same C
    signatures) called straight on `args` into an output allocated once;
    the launcher sets its own shared memory."""
    import ctypes
    import torch
    lhs, rhs, v, s, bits, sm_scale, quantize = args
    B, N, H, K = rhs.shape
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    fn = getattr(lib, "ofq_qkr_attention_fwd"
                 + ("_bf16" if v.dtype == torch.bfloat16 else ""))
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    call = [lhs.data_ptr(), int(lhs.ndim == 4), rhs.data_ptr(), v.data_ptr(),
            s.data_ptr(), out.data_ptr(), B, N, H, K, v.shape[-1],
            float(2 ** bits - 1), float(sm_scale), int(bool(quantize)),
            torch.cuda.current_stream().cuda_stream]

    def run():
        err = fn(*call)
        if err:
            raise RuntimeError(f"K2 launcher: CUDA error {err}")
        return out
    return run


def raw_k3(lib, args):
    """K3's C launcher for the stream dtype of `args` (qkr_attention_bwd's)
    in `lib` (the current tree's or an earlier one's: the same C
    signatures) called straight on `args` into outputs and scratch
    allocated once; the scratch rows are N rounded up to 8 apart, room
    for either tree."""
    import ctypes
    import torch
    lhs, rhs, v, s, g, bits, sm_scale, quantize = args
    B, N, H, K = rhs.shape
    d = v.shape[-1]
    ldp = -(-N // 8) * 8
    st = dict(dtype=v.dtype, device=rhs.device)
    outs = [torch.empty(lhs.shape, **st), torch.empty(rhs.shape, **st),
            torch.empty(v.shape, **st),
            torch.empty((N,), dtype=torch.float32, device=rhs.device),
            torch.empty((B, H, N, ldp), **st),
            torch.empty((B, H, N, ldp), **st),
            torch.empty((B, H, N), dtype=torch.float32, device=rhs.device)]
    fn = getattr(lib, "ofq_qkr_attention_bwd"
                 + ("_bf16" if v.dtype == torch.bfloat16 else ""))
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    call = ([lhs.data_ptr(), int(lhs.ndim == 4), rhs.data_ptr(),
             v.data_ptr(), s.data_ptr(), g.data_ptr()]
            + [t.data_ptr() for t in outs]
            + [B, N, H, K, d, float(2 ** bits - 1), float(sm_scale),
               int(bool(quantize)), torch.cuda.current_stream().cuda_stream])

    def run():
        err = fn(*call)
        if err:
            raise RuntimeError(f"K3 launcher: CUDA error {err}")
        return outs
    return run


def raw_k45(lib, which, a, w, s, n_levels):
    """K4's (`which` "K4": a = x) or K5's ("K5": a = g) C launcher in `lib`
    (the current tree's or an earlier one's) called straight on (a, w, s)
    into an output allocated once.  The current launcher also takes the
    pre-pass's scratch, kept as `run.levels` (Q(W) for K4, Q(W)^T for K5,
    flat); the earlier launcher, which quantized on load, takes none."""
    import ctypes
    import torch
    K, N = w.shape
    M = a.shape[0]
    out = torch.empty((M, N if which == "K4" else K), dtype=a.dtype,
                      device=a.device)
    fn = getattr(lib, "ofq_pallas_statsq_" + ("fwd" if which == "K4"
                                               else "dx"))
    levels = None
    if hasattr(lib, "ofq_pallas_statsq_launch"):
        levels = torch.empty(K * N, dtype=torch.float32, device=a.device)
    ptrs = [a.data_ptr(), w.data_ptr(), s.data_ptr()] + (
        [] if levels is None else [levels.data_ptr()]) + [out.data_ptr()]
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    call = ptrs + [M, K, N, float(n_levels), int(a.dtype == torch.bfloat16),
                   torch.cuda.current_stream().cuda_stream]

    def run():
        err = fn(*call)
        if err:
            raise RuntimeError(f"{which} launcher: CUDA error {err}")
        return out
    run.levels = levels
    return run


def levels_differing(levels, which, w, s, n_levels):
    """Elements of the pre-pass's Q(W) (`raw_k45`'s `run.levels`, after a
    run) whose bits differ from `_quant_tile` on the card; for K5 against
    its transpose."""
    import torch
    from ofq_tpu_torch.ops import pallas_statsq as ps
    want = ps._quant_tile(w, s, float(n_levels))
    if which == "K5":
        want = want.T.contiguous()
    got = levels.view(want.shape)
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())


def _versus(raw_ms, base_ms, differing):
    """The before-and-after of a phase's log line (--baseline), or ''."""
    if base_ms is None:
        return ""
    return (f" (launcher alone {raw_ms:.4f} ms, the earlier kernel the "
            f"same way {base_ms:.4f} ms, {differing} output elements "
            f"differing from it)")


def against_earlier(current, earlier):
    """(ms, earlier ms, output elements differing) of two launchers alone
    (`raw_k1`/`raw_k2`/`raw_k3`/`raw_k45` runners) on the same inputs
    (--baseline)."""
    ms, base_ms = median_ms(current), median_ms(earlier)
    outs = [current(), earlier()]
    outs = [o if isinstance(o, list) else [o] for o in outs]
    # the cotangents and ds (K3), or the output (K1, K2); not K3's scratch
    differing = sum(int((a != b).sum()) for a, b in zip(outs[0][:4],
                                                        outs[1][:4]))
    return ms, base_ms, differing


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
        # the non-QKR QAttention's qkv linear (QKR has none)
        ("qkv", m_tok, n_tok_main, 384, 1152, 2, False, True),
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
        raw_ms = base_ms = differing = None
        if base:
            from ofq_tpu_torch.ops import _build
            raw_ms, base_ms, differing = against_earlier(
                raw_k1(_build.load("fused_qlinear"), args),
                raw_k1(base["fused_qlinear"], args))
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
            f"({design['label']}) {ms:.4f} ms"
            f"{_versus(raw_ms, base_ms, differing)}, "
            f"plain "
            f"{plain_ms:.4f} ms, torch.matmul(x_q, w_q) "
            f"{mm_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        results.append(dict(name=name, M=M, K=K, N=N, bits=bits,
                            all_positive=all_pos, main_path=main,
                            design=design, differing=differing,
                            raw_ms=raw_ms, baseline_raw_ms=base_ms,
                            baseline_differing=differing,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            matmul_ms=mm_ms, bound_ms=b_ms, bound_by=b_by,
                            bytes=nbytes, flops=flops, lsq_ties=n_ties,
                            statsq_ties=w_ties))
    return results


# ---------------------------------------------------------------- phase 4
def _attn_outside(y, ref):
    """K2's and K3's elementwise tolerance against their plain versions
    (PERF.md section 2): fp32, 1e-4 * (1 + |ref|); bf16, one bf16 ulp of
    the larger magnitude, 2^-7 max(|y|, |ref|), plus that fp32 term (both
    sum in fp32 in other orders, then round to bf16)."""
    import torch
    a, b = y.float(), ref.float()
    lim = 1e-4 * (1 + b.abs())
    if y.dtype == torch.bfloat16:
        lim = lim + 2 ** -7 * torch.maximum(a.abs(), b.abs())
    return (a - b).abs() > lim


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _attn_bound(B, N, H, K, d, lhs_numel, dtype, backward):
    """Bytes (each input read once, each output written once) and
    operations of K2 or K3, and the bound at the peak of the operand type
    (bf16 products are exact and could run on the tensor cores)."""
    import torch
    es = 2 if dtype == torch.bfloat16 else 4
    rhs_numel, v_numel = B * N * H * K, B * N * H * d
    if backward:
        nbytes = es * (2 * lhs_numel + 2 * rhs_numel + 3 * v_numel) + 8 * N
        flops = 2 * B * H * N * N * (3 * K + 2 * d)
    else:
        nbytes = es * (lhs_numel + rhs_numel + 2 * v_numel) + 4 * N
        flops = 2 * B * H * N * N * (K + d)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return nbytes, flops, bound(nbytes, flops, peak)


def _attn_cases(dev, seed, N, B, with_g):
    """K2's and K3's inputs at the slice's shapes, per stream dtype: fp32,
    then the same values rounded to bf16 (s fp32), shared and per-head
    lhs; yields (dtype, shared, K, tensors)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    H, C, d = 6, 384, 64
    for shared in (True, False):
        K = C if shared else d
        ts = [torch.randn(*((B, N, K) if shared else (B, N, H, K)),
                          generator=g) * 0.5,
              torch.randn(B, N, H, K, generator=g) * 0.5,
              torch.randn(B, N, H, d, generator=g),
              torch.rand(N, generator=g) * 0.01 + 0.005]
        if with_g:
            ts.append(torch.randn(B, N, H, d, generator=g))
        for dtype in (torch.float32, torch.bfloat16):
            yield dtype, shared, K, [
                t.to(dev, dtype if i != 3 else torch.float32)
                .contiguous() for i, t in enumerate(ts)]


def _k2_design(dtype, N):
    """K2's score form and occupancy at N keys (a log label)."""
    import torch
    from ofq_tpu_torch.ops import fused_attention as fa
    smem, blocks = fa.fwd_launch_config(N, dtype == torch.bfloat16)
    return (f"CUDA cores, the shared score tile (8 x 7 a thread, one FMA "
            f"chain a score, 3-stage cp.async ring) and pq v (8 x 2 a "
            f"thread); {smem} B shared, {blocks} blocks per SM (the CUDA "
            f"runtime's occupancy)")


def k2_gate(what, o_k, o_ref, s, v):
    """K2 against its plain version (PERF.md section 2): finite, at most
    0.1 % of the elements outside `_attn_outside`, max|diff| at most
    2 max(s) max|v| (one LSQ level); raises GateTripped, else returns
    (max|diff|, its limit, elements outside)."""
    import torch
    diff = (o_k.float() - o_ref.float()).abs()
    outside = int(_attn_outside(o_k, o_ref).sum())
    hard = 2 * float(s.max()) * float(v.float().abs().max())
    err = float(diff.max())
    if not (torch.isfinite(o_k.float()).all() and outside <= 1e-3 * diff.numel()
            and err <= hard and o_k.dtype == o_ref.dtype):
        raise GateTripped(
            f"{what}: {outside} elements outside the tolerance "
            f"({outside / diff.numel():.2e}), max|diff| {err} (limit {hard}), "
            f"{o_k.dtype}")
    return err, hard, outside


def phase_k2(dev, N, B=BATCH, base=None):
    """K2 against its plain version (`k2_gate`), with SDPA (LSQ off, lhs
    expanded per head) as the yardstick; with `base` (--baseline) also the
    launcher alone, the current tree's and the earlier one's, and the
    output elements where the two differ."""
    import torch
    import torch.nn.functional as F
    from ofq_tpu_torch.ops import fused_attention as fa
    H, d, bits = 6, 64, 2
    sm_scale = d ** -0.5
    results = []
    for dtype, shared, K, (lhs, rhs, v, s) in _attn_cases(dev, 2, N, B, False):
        dt = _dtype_name(dtype)
        for quantize in (True, False):
            args = (lhs, rhs, v, s, bits, sm_scale, quantize)
            o_k = fa.qkr_attention_fwd(*args)
            o_ref = fa.qkr_attention_fwd_reference(*args)
            torch.cuda.synchronize()
            name = (f"{'shared' if shared else 'per-head'} lhs, "
                    f"LSQ {'on' if quantize else 'off'}, {dt}")
            err, hard, outside = k2_gate(f"K2 {name}", o_k, o_ref, s, v)
            ms = median_ms(lambda: fa.qkr_attention_fwd(*args))
            plain_ms = median_ms(
                lambda: fa.qkr_attention_fwd_reference(*args), reps=10)
            raw_ms = base_ms = differing = None
            if base:
                from ofq_tpu_torch.ops import _build
                raw_ms, base_ms, differing = against_earlier(
                    raw_k2(_build.load("fused_attention"), args),
                    raw_k2(base["fused_attention"], args))
            q = (lhs[:, None].expand(B, H, N, K) if shared
                 else lhs.permute(0, 2, 1, 3)).contiguous()
            kk = rhs.permute(0, 2, 1, 3).contiguous()
            vv = v.permute(0, 2, 1, 3).contiguous()
            sdpa_ms = median_ms(lambda: F.scaled_dot_product_attention(
                q, kk, vv, scale=sm_scale))
            del q, kk, vv
            nbytes, flops, (b_ms, b_by) = _attn_bound(
                B, N, H, K, d, lhs.numel(), dtype, backward=False)
            design = _k2_design(dtype, N)
            log(f"[K2] {name:30s} B={B} N={N} H={H} K={K} d={d}: max|diff| "
                f"{err:.3e} (limit {hard:.3e}), {outside} of {o_k.numel()} "
                f"outside the tolerance; kernel ({design}) {ms:.4f} ms"
                f"{_versus(raw_ms, base_ms, differing)}, plain "
                f"{plain_ms:.4f} ms, SDPA (unquantized, {dt}) "
                f"{sdpa_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
            results.append(dict(name=name, dtype=dt, shared=shared,
                                quantize=quantize, B=B, N=N, H=H, K=K, d=d,
                                max_abs_err=err, outside=outside, ms=ms,
                                design=design, raw_ms=raw_ms,
                                baseline_raw_ms=base_ms,
                                baseline_differing=differing,
                                plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                                bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                                flops=flops, main_path=shared and quantize))
    return results


# ------------------------------------------------------------- phase 4b
def _k3_design(dtype, N):
    import torch
    from ofq_tpu_torch.ops import fused_attention as fa
    bf16 = dtype == torch.bfloat16
    smem, ldp, stages, blocks = fa.bwd_launch_config(N, bf16)
    tail = (f"pass A {smem} B shared, {blocks} blocks per SM (the CUDA "
            f"runtime's occupancy), scratch rows {ldp} apart")
    scores = (f"pass A's score tile K2's (CUDA cores, 8 x 7 a thread, "
              f"{stages}-stage cp.async ring)")
    if bf16:
        return f"mma.sync m16n8k16 for dpq and passes B, C; {scores}; {tail}"
    return ("CUDA cores, register tiles (8 x 8 outputs a thread in passes "
            "B, C, 4 x 7 in pass A's dpq), float4 operand reads, cp.async "
            f"rings (B and C 3 stages of 16); {scores}; {tail}")


# K3's four launches by a part of their kernels' names: A (rows: the score
# tile, dpq, the row work), B (cols: dv, drhs), C (dlhs), D (ds)
K3_PASSES = (("A", "rows"), ("B", "cols"), ("C", "dlhs"), ("D", "ds_kernel"))


def pass_times(run, calls=5):
    """Device ms per call of each of K3's passes over `calls` calls of a
    launcher `run` (torch.profiler, device kernels only), or {} where the
    profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        for name, part in K3_PASSES:
            if part in ev.key:
                out[name] = out.get(name, 0.0) + dev_us / 1e3 / calls
    return out


def _passes_label(times):
    return (", ".join(f"{k} {v:.4f}" for k, v in sorted(times.items()))
            + " ms" if times else "not measured")


def phase_k3(dev, N, B=BATCH, base=None):
    """K3, the attention backward, against its plain version, with the
    backward of F.scaled_dot_product_attention (LSQ off, lhs expanded per
    head, only the autograd.grad call timed) as the yardstick; with `base`
    (--baseline) also the launcher alone, the current tree's and the
    earlier one's, and the output elements where the two differ."""
    import torch
    import torch.nn.functional as F
    from ofq_tpu_torch.ops import fused_attention as fa
    H, d, bits = 6, 64, 2
    sm_scale = d ** -0.5
    results = []
    for dtype, shared, K, (lhs, rhs, v, s, go) in _attn_cases(
            dev, 3, N, B, True):
        dt = _dtype_name(dtype)
        for quantize in (True, False):
            args = (lhs, rhs, v, s, go, bits, sm_scale, quantize)
            got = fa.qkr_attention_bwd(*args)
            ref = fa.qkr_attention_bwd_reference(*args)
            torch.cuda.synchronize()
            name = (f"{'shared' if shared else 'per-head'} lhs, "
                    f"LSQ {'on' if quantize else 'off'}, {dt}")
            shares, err = {}, 0.0
            for nm, a, b in zip(("dlhs", "drhs", "dv"), got, ref):
                if a.dtype != dtype:
                    raise AssertionError(f"K3 {name}: {nm} is {a.dtype}")
                shares[nm] = float(_attn_outside(a, b).float().mean())
                err = max(err, float((a.float() - b.float()).abs().max()))
            # ds[n] sums 64 * 6 * 198 terms; one probability that lands on
            # the other side of an LSQ boundary (the K2 precedent) moves
            # one entry by about |dpq|, so ds is held by the share of its
            # N entries outside 1e-4 * (1 + |ref|): at most 2 %
            ds_diff = (got[3] - ref[3]).abs()
            ds_share = float((ds_diff > 1e-4 * (1 + ref[3].abs())).float()
                             .mean())
            ds_err = (float((got[3] - ref[3]).norm() / ref[3].norm())
                      if quantize else float(got[3].abs().max()))
            finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
            if not (finite and max(shares.values()) <= 1e-3
                    and ds_share <= 2e-2 and (quantize or ds_err == 0)):
                raise AssertionError(
                    f"K3 {name}: shares outside the tolerance {shares}, "
                    f"ds {ds_share} of entries outside, error {ds_err}, "
                    f"finite {finite}")
            ms = median_ms(lambda: fa.qkr_attention_bwd(*args))
            plain_ms = median_ms(
                lambda: fa.qkr_attention_bwd_reference(*args), reps=10)
            raw_ms = base_ms = differing = passes = base_passes = None
            if rhs.is_cuda:
                from ofq_tpu_torch.ops import _build
                current = raw_k3(_build.load("fused_attention_bwd"), args)
                earlier = base and raw_k3(base["fused_attention_bwd"], args)
                if base:
                    raw_ms, base_ms, differing = against_earlier(current,
                                                                 earlier)
                if shared and quantize:
                    # the main path's case: device time by pass, the
                    # earlier tree's beside it
                    passes = pass_times(current)
                    base_passes = pass_times(earlier) if base else None
                    log(f"[K3 passes] {name}: {_passes_label(passes)}"
                        + (f"; earlier tree {_passes_label(base_passes)}"
                           if base else ""))
                del current, earlier
            q = (lhs[:, None].expand(B, H, N, K) if shared
                 else lhs.permute(0, 2, 1, 3)).contiguous().requires_grad_()
            kk = rhs.permute(0, 2, 1, 3).contiguous().requires_grad_()
            vv = v.permute(0, 2, 1, 3).contiguous().requires_grad_()
            out = F.scaled_dot_product_attention(q, kk, vv, scale=sm_scale)
            gg = go.permute(0, 2, 1, 3).contiguous()
            sdpa_ms = median_ms(lambda: torch.autograd.grad(
                out, (q, kk, vv), gg, retain_graph=True))
            del out, q, kk, vv
            nbytes, flops, (b_ms, b_by) = _attn_bound(
                B, N, H, K, d, lhs.numel(), dtype, backward=True)
            log(f"[K3] {name:30s} B={B} N={N} H={H} K={K} d={d}: share "
                f"outside the tolerance "
                f"{ {k: f'{v:.2e}' for k, v in shares.items()} }, ds "
                f"{ds_share:.2e} of entries, "
                f"{'rel L2 ' if quantize else 'max '}{ds_err:.2e}, max|diff| "
                f"{err:.3e}; kernel ({_k3_design(dtype, N)}) {ms:.4f} ms"
                f"{_versus(raw_ms, base_ms, differing)}, plain "
                f"{plain_ms:.4f} ms, "
                f"SDPA backward (unquantized, {dt}) {sdpa_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB)")
            results.append(dict(name=name, dtype=dt, shared=shared,
                                quantize=quantize, B=B, N=N, H=H, K=K, d=d,
                                max_abs_err=err,
                                outside_share=shares, ds_share=ds_share,
                                ds_err=ds_err, ms=ms,
                                design=_k3_design(dtype, N),
                                raw_ms=raw_ms, baseline_raw_ms=base_ms,
                                baseline_differing=differing,
                                pass_ms=passes, baseline_pass_ms=base_passes,
                                plain_ms=plain_ms, sdpa_bwd_ms=sdpa_ms,
                                bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                                flops=flops, main_path=shared and quantize))
    return results


# ---------------------------------------------------------------- phase 7
def _k45_cases(m_tok, qkv=False):
    """K4's or K5's cases; `qkv`: with the non-QKR qkv linear's shape (K4
    only: K5 lies on no path of the non-QKR student)."""
    return [  # name, M, K, N (K4: x (M, K) @ Q(W) (K, N)), main path
        ("proj", m_tok, 384, 384, True),
        ("fc1", m_tok, 384, 1536, True),
        ("fc2", m_tok, 1536, 384, True),
        *([("qkv", m_tok, 384, 1152, True)] if qkv else []),
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
    fc2 of each stage on its (batch * H * W) tokens, the non-QKR qkv
    linear's, and the reduction of each patch merging on the merged map's
    tokens."""
    from ofq_tpu_torch.models.swin import SWIN_TINY as cfg
    side, dim, cases = cfg.img_size // cfg.patch_size, cfg.embed_dim, []
    for stage in range(len(cfg.depths)):
        M, hid = batch * side * side, int(dim * cfg.mlp_ratio)
        cases += [(f"s{stage} proj", M, dim, dim, True),
                  (f"s{stage} fc1", M, dim, hid, True),
                  (f"s{stage} fc2", M, hid, dim, True),
                  (f"s{stage} qkv", M, dim, 3 * dim, True)]
        if stage < len(cfg.depths) - 1:
            side = (side + 1) // 2
            cases.append((f"s{stage} reduction", batch * side * side,
                          4 * dim, 2 * dim, True))
            dim *= 2
    return cases


# K4's and K5's kernels (one product body for both, in either stream); the
# block tile of each shape is the built library's (`k45_design`)
K45_DESIGN = ("Q(W) pre-pass once per call, then register-tiled CUDA-core "
              "fp32 FMAs (8x8 outputs a thread, 3-stage cp.async ring)")


def k45_design(M, C, dtype):
    """The launch of K4's or K5's product for an (M, C) output, as the built
    library exports it, with a label."""
    import torch
    from ofq_tpu_torch.ops import pallas_statsq as ps
    cfg = ps.launch_config(M, C, dtype == torch.bfloat16)
    label = (f"{K45_DESIGN}: {cfg['tile'][0]}x{cfg['tile'][1]} tiles of "
             f"{cfg['threads']} threads, {cfg['grid'][0]}x{cfg['grid'][1]} "
             f"blocks, {cfg['smem']} B shared, {cfg['blocks_per_sm']} "
             f"blocks/SM")
    return dict(cfg, label=label)


def phase_k45(dev, which, cases, dtypes=None, base=None):
    """K4 (`which` = "K4": y = x @ Q(W)) or K5 ("K5": dx = g @ Q(W)^T)
    against its plain version at `cases` (name, M, K, N, main path), in
    fp32 and bf16 (or `dtypes`); a main-path case counts in bf16.  Each
    case also holds the pre-pass's Q(W) to `_quant_tile` bit for bit, and
    with `base` (--baseline) times the earlier tree's launcher beside the
    current one and counts the output elements that differ."""
    import torch
    from ofq_tpu_torch.ops import _build
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
            raw = raw_k45(_build.load("pallas_statsq"), which, a, w, s, n)
            raw()
            torch.cuda.synchronize()
            err, ratio, outside = _k45_gate(y_k, y_ref, abs_sum)
            lv_diff = levels_differing(raw.levels, which, w, s, n)
            c = torch.clamp(w / s, -1.0, 1.0 - 1e-6) * n - 0.5
            w_ties = int((c - torch.floor(c)).eq(0.5).sum())
            dt = str(dtype).replace("torch.", "")
            if not (torch.isfinite(y_k).all() and outside == 0
                    and lv_diff == 0):
                raise AssertionError(
                    f"{which} {name} {dt}: {outside} elements outside the "
                    f"limit (worst ratio {ratio:.3f}), max|diff| {err}; "
                    f"{lv_diff} levels of the pre-pass differing from "
                    f"_quant_tile")
            raw_ms = base_ms = differing = None
            if base:
                raw_ms, base_ms, differing = against_earlier(
                    raw, raw_k45(base["pallas_statsq"], which, a, w, s, n))
            design = k45_design(M, N if which == "K4" else K, dtype)
            ms = median_ms(lambda: kern(*args))
            plain_ms = median_ms(lambda: plain(*args), reps=10)
            yard_ms = median_ms(yard)
            nbytes, flops, (b_ms, b_by) = _k45_bound(M, K, N, dtype)
            log(f"[{which}] {name:6s} {dt:8s} M={M} K={K} N={N}: max|diff| "
                f"{err:.3e}, worst |diff|/limit {ratio:.3f}, {w_ties} StatsQ "
                f"ties, pre-pass levels bit for bit; kernel "
                f"({design['label']}) {ms:.4f} ms"
                f"{_versus(raw_ms, base_ms, differing)}, plain "
                f"{plain_ms:.4f} ms, "
                f"torch.matmul(a, Q(W){'^T' if which == 'K5' else ''}) "
                f"{yard_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
            results.append(dict(name=name, dtype=dt, M=M, K=K, N=N,
                                main_path=main and dtype == torch.bfloat16,
                                design=design["label"], launch=design,
                                raw_ms=raw_ms, baseline_raw_ms=base_ms,
                                baseline_differing=differing,
                                max_abs_err=err, worst_ratio=ratio,
                                statsq_ties=w_ties, ms=ms, plain_ms=plain_ms,
                                matmul_ms=yard_ms, bound_ms=b_ms,
                                bound_by=b_by, bytes=nbytes, flops=flops,
                                contraction=out_k))
            del a, w, s, wq, wq_c, abs_sum, y_k, y_ref, args, raw
    return results


def phase_k5_captured(recs, base=None):
    """K5 on the dx products of one backward of the pallas step: against
    its plain version (the limit of phase 7) and against the dx that the
    backward computed, which multiplies by Q(W) rounded to bf16, as JAX's
    `_vjp_bwd` does: |K5 - dx| <= (2^-8 + 1e-5) * sum |g| |Q(W)| plus
    2^-7 * max(|K5|, |dx|) (the bf16 rounding of Q(W) is at most 2^-8 of
    each level; one output ulp).  Only these launches count as K5's.  With
    `base` (--baseline), each product also through the current and the
    earlier launcher alone: times and output elements differing."""
    import torch
    from ofq_tpu_torch import ops
    from ofq_tpu_torch.ops import _build
    from ofq_tpu_torch.ops import pallas_statsq as ps
    from ofq_tpu_torch.quant.statsq import statsq_scale
    ops.reset_launch_counts()
    worst = {"plain": 0.0, "backward": 0.0}
    errs = {"plain": 0.0, "backward": 0.0}
    versus = []
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
        if base:
            raw_ms, base_ms, differing = against_earlier(*(
                raw_k45(lib, "K5", g2, w, s, n)
                for lib in (_build.load("pallas_statsq"),
                            base["pallas_statsq"])))
            versus.append(dict(M=g2.shape[0], K=w.shape[0], N=N,
                               raw_ms=raw_ms, baseline_raw_ms=base_ms,
                               differing=differing))
        rec.clear()
    torch.cuda.synchronize()
    launches = ops.pallas_statsq_dx.launches
    shapes = _shapes(ops.pallas_statsq_dx)
    log(f"[K5] on the {len(recs)} dx products of one pallas train step: "
        f"{launches} launches, by (M,K,N) {shapes}; max|diff| vs plain "
        f"{errs['plain']:.3e} (worst |diff|/limit {worst['plain']:.3f}), vs "
        f"the backward's dx {errs['backward']:.3e} (worst {worst['backward']:.3f})")
    if versus:
        log(f"[K5] the same {len(versus)} products through the launchers "
            f"alone: {sum(v['raw_ms'] for v in versus):.3f} ms now, "
            f"{sum(v['baseline_raw_ms'] for v in versus):.3f} ms earlier, "
            f"{sum(v['differing'] for v in versus)} output elements "
            f"differing")
    if launches != len(recs) or max(worst.values()) > 1.0:
        raise AssertionError(f"K5 on the captured dx products: {launches} "
                             f"launches, worst ratios {worst}")
    return dict(launches=launches, launch_shapes=shapes, max_abs_err=errs,
                worst_ratio=worst, versus_baseline=versus)


# ---------------------------------------------------------------- phase 5
def _describe(conf):
    """A label of a configuration of the student: its linears, its
    attention tail and its stream."""
    if "frozen_int_bits" in conf:
        linears = ("frozen packed artifact, integer core (int8_mm)"
                   if conf["frozen_int_bits"] else
                   "frozen packed artifact, fp products")
    else:
        linears = {"fused": "fused QLinear (K1)",
                   "pallas": "matmul_impl='pallas' (K4)",
                   "int8": "matmul_impl='int8' (int8_mm, torch._int_mm)"}[
                       conf["matmul_impl"]]
    attn = ("fused attention (K2, K3)" if conf["attn_impl"] == "fused"
            else "composed attention")
    return f"{linears}, {attn}, {conf['compute_dtype'] or 'float32'} stream"


def _policy_label(policy):
    """The student's recipe: W2A2 QKR, W2A2 without QKR, or full-LSQ, and
    its MLP activation where it is not GELU."""
    act = ("" if policy is None or policy.act_layer == "gelu"
           else f", act_layer {policy.act_layer}")
    if policy is None or policy.qk_reparam:
        return "W2A2 QKR" + act
    return ("W2A2 full-LSQ (--wq-mode lsq), no QKR" if policy.lsq_weights
            else "W2A2 without QKR") + act


def _path_counts(cfg, policy=None):
    """(quantized linears in the blocks, attention blocks, reductions) of a
    model configuration under `policy` (None: W2A2 QKR): QKR, 3 linears
    per block (proj, fc1, fc2); without QKR 4 (and qkv); Swin adds the
    reduction of each patch merging (Swin-T QKR: 36 + 3 = 39, without QKR
    48 + 3 = 51)."""
    per = 3 if policy is None or policy.qk_reparam else 4
    if hasattr(cfg, "depths"):
        blocks = sum(cfg.depths)
        return per * blocks, blocks, len(cfg.depths) - 1
    return per * cfg.depth, cfg.depth, 0


def int_path(conf):
    """Whether a configuration's products run on the integer codes."""
    return conf["matmul_impl"] == "int8" or bool(conf.get("frozen_int_bits"))


def _expected(conf, cfg, train, policy=None):
    """Launches of every kernel wrapper in one forward (or train step) of
    the student under `policy` (None: W2A2 QKR), as JAX's module tree
    implies: a full-LSQ DeiT's linears are `torch.matmul` (no K1, K4); the
    Gram telemetry (`qqkkvv`) runs the composed attention (no K2, K3)."""
    from ofq_tpu_torch import ops
    n_linear, n_attn, n_red = _path_counts(cfg, policy)
    qkr = policy is None or policy.qk_reparam
    lsq = (policy is not None and policy.lsq_weights
           and not hasattr(cfg, "depths"))
    want = dict.fromkeys(ops.launch_counts(), 0)
    if conf["matmul_impl"] == "fused" and not lsq:
        want["fused_qlinear_fwd"] = n_linear + n_red
    if conf["matmul_impl"] == "pallas" and not lsq:
        want["pallas_statsq_fwd"] = n_linear + n_red
    if int_path(conf):
        # every quantized linear (a full-LSQ one's frozen integer core
        # too) and QKR's v and qkx products, forward only
        want["int8_mm"] = n_linear + n_red + (2 * n_attn if qkr else 0)
    if conf["attn_impl"] == "fused" and not getattr(cfg, "qqkkvv", False):
        want["qkr_attention_fwd"] = n_attn
        if train:
            want["qkr_attention_bwd"] = n_attn
    return want


# The agreement gates of the slices (PERF.md section 2).  A kernel and its
# plain version sum in other orders, so now and then a value crosses an
# LSQ boundary and moves one 2-bit level (in bf16 a one-ulp difference of
# an output does), and the random-weight W2A2 model carries such a move on
# through the later blocks and scrambles that image's top-1.  So each
# block is held alone, on the plain path's input to it, and the whole
# model end to end.
#
# fp32 (the fused configuration): kernels against plain.  Each block: at
# most BLOCK_ROWS of its (image, token) rows with an element outside
# `_outside`; end to end, top-1 agreement at least TOP1.
BLOCK_ROWS = 1e-3
TOP1 = 0.95
# bf16: each path against the rounded-once reference (`rounded_once`: the
# plain path with every product summed in fp64 and rounded once to the
# dtype it returns; every bf16 rounding of the stream kept), so the gate
# depends on neither path's summation order.  Each block: the kernel
# path's share of rows outside `_outside` at most max(BLOCK_ROWS, BLOCK_C
# * the plain path's share); each block's backward the same on the rows
# of dx, and each of its parameters' gradients by the whole-step rule
# below; end to end, the kernel path's top-1 agreement with the reference
# at least the plain path's minus TOP1_SIGMAS standard errors of their
# paired difference, sqrt(n01 + n10) / images, where n01 and n10 count
# the images on which exactly one of the two paths agrees (McNemar).
BLOCK_C = 2
TOP1_SIGMAS = 3
# the bf16 backward's rows of dx add 2^-8 of the row's largest |ref| to
# the element tolerance: an element of dx is a sum of signed terms that
# cancel, so any two summation orders put some element of nearly every
# row more than a bf16 ulp of itself apart (97-99 % of DeiT-S's rows on
# an H100 without the term, plain and kernels alike)
BACKWARD_ROW_FLOOR = 2 ** -8
# Swin-T's element tolerance adds 2^-8 of the row's largest |ref| (PERF.md
# section 2): at its stage-2 reduction and stage-3 shapes (M = 3136,
# K = 768 to 3072) an output that cancels differs between fp32 sums in
# two orders by a few fp32 ulps of its terms, many bf16 ulps of itself
# (49 % of the stage-2 reduction's rows had such an element, cuBLAS
# against K4), which would fill both paths' row counts alike
SWIN_GATE = dict(rows=BLOCK_ROWS, row_floor=2 ** -8)


class GateTripped(AssertionError):
    """An agreement gate refused the kernel path (what the gate self-check
    expects of each injected fault)."""


@contextlib.contextmanager
def rounded_once():
    """The bf16 gates' reference: while it is active every product the
    port's plain path takes (torch.matmul, torch.einsum, `@`, and through
    autograd their backward products) is summed in fp64 and rounded once
    to the dtype it returns; every other operation, and so every bf16
    rounding of the stream, is the plain path's own.  Run it with the
    model on its plain path."""
    import functools
    import torch
    mm, es, op = torch.matmul, torch.einsum, torch.Tensor.__matmul__

    def matmul(a, b):
        dt = torch.promote_types(a.dtype, b.dtype)
        if not dt.is_floating_point:
            return mm(a, b)
        return mm(a.double(), b.double()).to(dt)

    def einsum(eq, *operands):
        if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
            operands = operands[0]
        dt = functools.reduce(torch.promote_types,
                              [o.dtype for o in operands])
        return es(eq, *(o.double() for o in operands)).to(dt)

    torch.matmul, torch.einsum = matmul, einsum
    torch.Tensor.__matmul__ = matmul
    try:
        yield
    finally:
        torch.matmul, torch.einsum = mm, es
        torch.Tensor.__matmul__ = op


def _chunked_sum(es, eq, a, b, j):
    """The two-operand einsum `eq` of a and b in one legitimate fp32 order:
    the contraction (its largest summed index) split into j near-equal
    chunks, each chunk summed in fp32 (operands widened exactly), the
    chunks added in fp32 in order; returns fp32.  `es`: torch's own
    einsum."""
    import torch
    ins, out = eq.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    summed = [c for c in dict.fromkeys(sa + sb) if c not in out]
    a, b = a.float(), b.float()
    if not summed:
        return es(eq, a, b)
    size = {c: n for s, t in ((sa, a), (sb, b)) for c, n in zip(s, t.shape)}
    c = max(summed, key=lambda x: size[x])
    acc = None
    for ca, cb in zip(
            torch.tensor_split(a, j, dim=sa.index(c)) if c in sa else [a] * j,
            torch.tensor_split(b, j, dim=sb.index(c)) if c in sb else [b] * j):
        part = es(eq, ca, cb)
        acc = part if acc is None else acc + part
    return acc


def _chunked_product(es, j):
    """An autograd Function for `_chunked_sum` whose backward products
    (the cotangent of each operand, itself a two-operand einsum) are
    summed the same way and rounded once to the operand's dtype."""
    import torch

    class Chunked(torch.autograd.Function):
        @staticmethod
        def forward(ctx, eq, a, b):
            ctx.eq = eq
            ctx.save_for_backward(a, b)
            dt = torch.promote_types(a.dtype, b.dtype)
            return _chunked_sum(es, eq, a, b, j).to(dt)

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensors
            ins, out = ctx.eq.replace(" ", "").split("->")
            sa, sb = ins.split(",")
            ga = gb = None
            if ctx.needs_input_grad[1]:
                ga = _chunked_sum(es, f"{out},{sb}->{sa}", g, b, j).to(
                    a.dtype)
            if ctx.needs_input_grad[2]:
                gb = _chunked_sum(es, f"{sa},{out}->{sb}", a, g, j).to(
                    b.dtype)
            return None, ga, gb

    return Chunked.apply


@contextlib.contextmanager
def summed_in_chunks(j):
    """Another legitimate fp32 summation order of the plain path: while it
    is active every product that `rounded_once` patches (torch.matmul,
    torch.einsum, `@`, and through autograd their backward products) has
    its contraction split into j chunks, each summed in fp32, the chunks
    added in fp32 in order and the result rounded once to the dtype it
    returns.  Run with the model on its plain path, it measures how far
    summation order alone moves a result (the whole-step gradient rule's
    order spread)."""
    import torch
    mm, es, op = torch.matmul, torch.einsum, torch.Tensor.__matmul__
    product = _chunked_product(es, j)

    def refuse(what):
        # a product left in its own order would narrow the spread unseen
        raise NotImplementedError(f"summed_in_chunks: {what}")

    def matmul(a, b):
        if not (a.dtype.is_floating_point or b.dtype.is_floating_point):
            return mm(a, b)
        if b.dim() not in (1, 2):
            refuse(f"a matmul with a {b.dim()}-d right operand")
        a2 = a.reshape(-1, a.shape[-1]) if a.dim() > 1 else a[None]
        b2 = b if b.dim() == 2 else b[:, None]
        y = product("mk,kn->mn", a2, b2)
        lead = a.shape[:-1]
        return y.reshape(*lead, b.shape[1]) if b.dim() == 2 else \
            y.reshape(lead)

    def einsum(eq, *operands):
        if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
            operands = operands[0]
        if not any(o.dtype.is_floating_point for o in operands):
            return es(eq, *operands)
        if len(operands) != 2 or "..." in eq or "->" not in eq:
            refuse(f"the einsum {eq!r} of {len(operands)} operands")
        return product(eq, *operands)

    torch.matmul, torch.einsum = matmul, einsum
    torch.Tensor.__matmul__ = matmul
    try:
        yield
    finally:
        torch.matmul, torch.einsum = mm, es
        torch.Tensor.__matmul__ = op


# the summation orders whose spread the whole-step gradient rule allows
# (bf16 paths): the plain path as it stands and split into these chunks
ORDER_CHUNKS = (2, 3, 4)


@contextlib.contextmanager
def plain_path(model):
    """`model` through its kernels' plain versions while active."""
    model.use_kernels = False
    try:
        yield
    finally:
        model.use_kernels = True


@contextlib.contextmanager
def reference_path(model):
    """`model` on the bf16 gates' reference path while active."""
    with plain_path(model), rounded_once():
        yield


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
    """The fp32 block gate: kernels against plain."""
    log(f"{what}: share of (image, token) rows with an element outside the "
        f"tolerance {[f'{a:.2e}' for a, _ in shares]}, differing at all "
        f"{[f'{b:.2e}' for _, b in shares]}")
    if max(a for a, _ in shares) > limit:
        raise GateTripped(f"{what}: more than {limit} of the rows of a "
                          f"block differ: {shares}")
    return [a for a, _ in shares]


def _block_rows_gate(what, rows, limit=BLOCK_ROWS):
    """The bf16 block gate.  `rows` holds, per block, the shares of rows
    outside the tolerance: kernels vs the reference, plain vs the
    reference, and (printed only) kernels vs plain with the share
    differing at all."""
    fmt = lambda xs: [f"{x:.2e}" for x in xs]  # noqa: E731
    k, p, kp, dif = ([r[i] for r in rows] for i in range(4))
    log(f"{what}: share of (image, token) rows with an element outside the "
        f"tolerance against the rounded-once reference, kernels {fmt(k)}, "
        f"plain {fmt(p)}; kernels vs plain (not gated in bf16) {fmt(kp)}, "
        f"differing at all {fmt(dif)}")
    bad = [(i, a, b) for i, (a, b) in enumerate(zip(k, p))
           if a > max(limit, BLOCK_C * b)]
    if bad:
        raise GateTripped(f"{what}: blocks (index, kernels, plain) past "
                          f"max({limit}, {BLOCK_C} x plain): {bad}")
    return dict(kernels=k, plain=p, kernels_vs_plain=kp)


def _shapes(fn):
    return {str(k): v for k, v in fn.launch_shapes.items()}
def phase_slice(dev, conf, name, policy, batch=BATCH, gate=None,
                built=None, timed=True):
    """Serving the W2A2 student `name` under `policy` (QKR, or without
    it) in the configuration `conf` through `Predictor` (`gate`:
    `check_blocks`);
    `built`: the (model, images, rng) of `build_served`, or of a frozen
    artifact's or a trained student's model; `timed=False` skips the
    img/s measurement."""
    import numpy as np
    import torch
    from ofq_tpu_torch import ops
    from ofq_tpu_torch.serve import Predictor

    t0 = time.perf_counter()
    model, images, rng = built or build_served(dev, conf, name, policy,
                                               batch)
    cfg = model.cfg
    log(f"[slice] {name} {_policy_label(policy)}, {_describe(conf)}, "
        f"{sum(p.numel() for p in model.parameters())} params, built and "
        f"calibrated in {time.perf_counter() - t0:.1f} s")
    pred = Predictor(model, batch_size=batch, img_size=cfg.img_size,
                     device=dev)

    ops.reset_launch_counts()
    probs = pred.predict(images)
    launches = ops.launch_counts()
    shapes = {**_shapes(ops.fused_qlinear_fwd),
              **_shapes(ops.pallas_statsq_fwd), **_shapes(ops.int8_mm)}
    log(f"[slice] launches in one predict: {launches}; by (M,K,N): {shapes}")
    want = _expected(conf, cfg, train=False, policy=policy)
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    if not (probs.shape == (batch, cfg.num_classes)
            and np.isfinite(probs).all()
            and np.allclose(probs.sum(-1), 1.0, atol=1e-4)):
        raise AssertionError(f"predictions are not finite ({batch}, "
                             f"{cfg.num_classes}) probability rows")

    # the agreement gates (above BLOCK_ROWS): each block alone, then top-1
    # on CMP_BATCHES seeded batches, printed beside the number of images
    # whose probabilities differ at all and each path's agreement with the
    # composed model run in fp64 on the card (how far rounding alone
    # moves top-1)
    blocks = check_blocks(model, images, dev, conf, gate)
    batches = [images] + [rng.normal(size=images.shape).astype(np.float32)
                          for _ in range(CMP_BATCHES - 1)]
    top1 = check_top1(pred, batches, conf, first=probs)
    if int_path(conf):
        top1["same_bits"] = check_same_bits(model, images, dev)
    if conf["matmul_impl"] == "int8":
        top1["top1_vs_composed"] = composed_top1(pred, batches)

    def rate(n_calls=10):
        for _ in range(3):
            pred.predict(images)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n_calls):
            pred.predict(images)
        torch.cuda.synchronize()
        return batch * n_calls / (time.perf_counter() - t)

    if not timed:
        prof = (phase_profile(lambda: pred.predict(images), "predict call")
                if "--profile" in sys.argv else None)
        return dict(config=conf, profile=prof, launches=launches,
                    launch_shapes=shapes, blocks=blocks, **top1)
    torch.cuda.reset_peak_memory_stats()
    img_s = rate()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with plain_path(model):
        img_s_plain = rate()
    log(f"[slice] Predictor.predict, B={batch}: {img_s:.1f} img/s with the "
        f"kernels, {img_s_plain:.1f} img/s through the plain versions; "
        f"peak device memory {peak_gb:.2f} GB with the kernels")
    prof = (phase_profile(lambda: pred.predict(images), "predict call")
            if "--profile" in sys.argv else None)
    return dict(config=conf, profile=prof, launches=launches,
                launch_shapes=shapes, blocks=blocks, **top1,
                img_per_s=img_s, img_per_s_plain=img_s_plain,
                peak_mem_gb=peak_gb)


def build_served(dev, conf, name, policy, batch=BATCH):
    """The W2A2 student `name` under `policy` of the serving phases, from
    seeded
    weights, calibrated on a seeded batch; the seeded images it serves
    first and the generator of the further batches."""
    import numpy as np
    import torch
    from ofq_tpu_torch.calibrate import calibrate
    from ofq_tpu_torch.models import create_model
    model = create_model(
        name, policy=policy, device=dev,
        generator=torch.Generator().manual_seed(0), head_std=0.02, **conf)
    img = model.cfg.img_size
    rng = np.random.default_rng(0)
    calib = rng.normal(size=(batch, img, img, 3)).astype(np.float32)
    images = rng.normal(size=(batch, img, img, 3)).astype(np.float32)
    calibrate(model, calib)
    torch.cuda.synchronize()
    return model, images, rng


def check_top1(pred, batches, conf, first=None):
    """The end-to-end gate on `batches` (`first`: the kernel path's
    probabilities of the first batch, when already computed)."""
    import numpy as np
    model = pred.model
    p_k = np.concatenate(
        ([first] if first is not None else [pred.predict(batches[0])])
        + [pred.predict(b) for b in batches[1:]])
    with plain_path(model):
        p_p = np.concatenate([pred.predict(b) for b in batches])
    p_64 = composed_fp64_probs(model, batches, next(
        model.parameters()).device)
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
    out = dict(compared_images=len(p_k), images_differing=touched,
               top1_agreement=agree, top1_agreement_fp64=agree_64,
               max_prob_diff=max_diff)
    if not np.isfinite(p_k).all():
        raise AssertionError("non-finite probabilities")
    if conf["compute_dtype"] is None:
        if agree < TOP1:
            raise GateTripped(f"top-1 agreement {agree} < {TOP1}")
        return out
    with reference_path(model):
        p_r = np.concatenate([pred.predict(b) for b in batches])
    a_k = top1["kernels"] == p_r.argmax(-1)
    a_p = top1["plain"] == p_r.argmax(-1)
    n01, n10 = int((a_k & ~a_p).sum()), int((a_p & ~a_k).sum())
    margin = TOP1_SIGMAS * (n01 + n10) ** 0.5 / len(a_k)
    log(f"[slice] top-1 agreement with the rounded-once reference: kernels "
        f"{a_k.mean() * 100:.2f} %, plain {a_p.mean() * 100:.2f} % (only "
        f"the kernels agree on {n01} images, only plain on {n10}); gate: "
        f"kernels >= plain - {margin * 100:.2f} %")
    out.update(top1_vs_reference=dict(
        kernels=float(a_k.mean()), plain=float(a_p.mean()), only_kernels=n01,
        only_plain=n10, margin=margin))
    if a_k.mean() < a_p.mean() - margin:
        raise GateTripped(f"top-1 agreement with the reference: kernels "
                          f"{a_k.mean()} < plain {a_p.mean()} - {margin}")
    return out


def _capture_blocks(model, images, dev):
    """(input, output) of every block on one plain-path forward."""
    import torch
    seen = []
    hooks = [getattr(model, n).register_forward_hook(
        lambda mod, args, out: seen.append((args[0], out)))
        for n in model.block_names]
    try:
        with plain_path(model), torch.inference_mode():
            model(torch.from_numpy(images).to(dev))
    finally:
        for h in hooks:
            h.remove()
    return seen


def check_blocks(model, images, dev, conf=FUSED, gate=None):
    """Each block alone on the plain path's input to it, held by `gate`
    (`rows`, `row_floor`; default BLOCK_ROWS, no row term): in fp32 the
    kernel path against the plain path, in bf16 both against the
    rounded-once reference (above BLOCK_ROWS)."""
    import torch
    gate = gate or dict(rows=BLOCK_ROWS, row_floor=0.0)
    fl = gate["row_floor"]
    rows = []
    with torch.inference_mode():
        for name, (x, ref) in zip(model.block_names,
                                  _capture_blocks(model, images, dev)):
            block = getattr(model, name)
            y = block(x)
            if not torch.isfinite(y).all():
                raise GateTripped(f"{name}: non-finite output")
            if conf["compute_dtype"] is None:
                rows.append(_row_shares(y, ref, conf, fl))
                continue
            with reference_path(model):
                r = block(x)
            rows.append((_row_shares(y, r, conf, fl)[0],
                         _row_shares(ref, r, conf, fl)[0],
                         *_row_shares(y, ref, conf, fl)))
    what = "[slice] each block alone on the same input"
    if conf["compute_dtype"] is None:
        return _log_rows(what + ", kernels vs plain", rows, gate["rows"])
    return _block_rows_gate(what, rows, gate["rows"])


def composed_fp64(model):
    """A copy of `model` on the composed path in fp64: no kernels, no bf16
    stream (the same weights and scales)."""
    import copy
    ref = copy.deepcopy(model).double()
    for m in ref.modules():
        for attr in ("matmul_impl", "attn_impl", "compute_dtype",
                     "frozen_int_bits"):
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
# whole-step gradient gate: for every parameter, and for all parameters
# together, the kernel path's relative L2 distance from a reference
# gradient may be at most twice the plain path's (fp32), or twice its
# order spread (bf16: the largest distance over the plain path and the
# plain path summed in ORDER_CHUNKS chunks, `summed_in_chunks`; after a
# whole chaotic W2A2 step a cancelling sum such as an LSQ scale's gradient
# moves by several times its size under any change of summation order),
# plus a floor; the floor is the median over parameters of the plain
# path's distance (how far rounding alone moves a gradient of this
# chaotic random-weight W2A2 model in this run), never below
# GRAD_GATE_MIN_FLOOR.  The reference:
# fp32, the composed model in fp64; bf16, the rounded-once reference
# (`rounded_once`), since the fp64 model has no bf16 stream and sits as
# far from both bf16 paths as they sit from each other (its distances are
# printed beside the gate)
GRAD_GATE_MIN_FLOOR = 1e-3


def _family(name, **recipe):
    """(config, W2A2 policy) of a model name, DeiT or Swin: QKR, or with
    `recipe` (`qk_reparam=False`, `wq_mode="lsq"`) the recipe's variants."""
    from ofq_tpu_torch.models import deit, swin
    from ofq_tpu_torch.quant import w2a2_deit_policy, w2a2_swin_policy
    if name in swin.VARIANTS:
        cfg = swin.VARIANTS[name]
        return cfg, w2a2_swin_policy(cfg.depths, **recipe)
    cfg = deit.VARIANTS[name]
    return cfg, w2a2_deit_policy(cfg.depth, **recipe)


def is_swin(name):
    return hasattr(_family(name)[0], "depths")


# bench.py's Swin-T rows and the recipe train with drop_path 0.0
SWIN_BENCH = dict(drop_path_rate=0.0)


def build_trained(dev, conf, name="deit_small_distilled_patch16_224",
                  batch=BATCH, policy=None, overrides=None):
    """The W2A2 QKR student of the train phases in `conf` (or under
    `policy`; `overrides` replace config fields), calibrated, its float
    teacher (bf16 parameters under the bf16 stream, as bench.py builds it;
    with the student's `qqkkvv` and `return_features`) and bench.py's
    seeded batch, kept on the device."""
    import numpy as np
    import torch
    from ofq_tpu_torch.calibrate import calibrate
    from ofq_tpu_torch.models import create_model
    from ofq_tpu_torch.quant import QuantPolicy
    cfg, default_policy = _family(name)
    cd = conf["compute_dtype"]
    student = create_model(
        name, policy=policy or default_policy, device=dev,
        generator=torch.Generator().manual_seed(0), head_std=0.02, **conf,
        **(overrides or {}))
    telemetry = {k: v for k, v in (overrides or {}).items()
                 if k in ("qqkkvv", "return_features")}
    teacher = create_model(name, policy=QuantPolicy(), device=dev,
                           generator=torch.Generator().manual_seed(1),
                           compute_dtype=cd, **telemetry)
    if cd:
        teacher.to(torch.bfloat16)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(batch, cfg.img_size, cfg.img_size,
                                          3)).astype(np.float32)).to(dev)
    label = torch.from_numpy(rng.integers(0, cfg.num_classes,
                                          size=(batch,))).to(dev)
    calibrate(student, x[:8])
    return student, teacher, {"image": x, "label": label}


def bn_stats(model):
    """Every BatchNorm's running statistics by name (the model's own
    buffers); empty for a LayerNorm model."""
    from ofq_tpu_torch.models import BatchNorm
    return {f"{n}.{k}": getattr(m, k) for n, m in model.named_modules()
            if isinstance(m, BatchNorm) for k in ("mean", "var")}


# `per_layer_grad_norms`: the squares of the per-layer norms sum to the
# total's square within this share of it, with fp32 gradients (fp32
# masters) and with bf16 ones (bf16 masters: each layer's norm and the
# total, as JAX's, are rounded once to bf16 from the per-parameter norms,
# so each square moves by at most 2^-7 of itself, and the two the other
# way)
LAYER_NORMS_FP32, LAYER_NORMS_BF16 = 1e-5, 2.0 ** -6


def check_layer_norms(metrics, bf16):
    """`grad_norm/<name>` of `per_layer_grad_norms`: present, finite, and
    their squares summing to `grad_norm`'s."""
    import math
    layers = {k: float(v) for k, v in metrics.items()
              if k.startswith("grad_norm/")}
    total = float(metrics["grad_norm"]) ** 2
    sq = sum(v * v for v in layers.values())
    rel = abs(sq - total) / total
    limit = LAYER_NORMS_BF16 if bf16 else LAYER_NORMS_FP32
    log(f"[train] per_layer_grad_norms: {len(layers)} layers, sum of "
        f"squares / grad_norm^2 - 1 = {rel:.3e} (limit {limit:.1e}); "
        f"largest {max(layers, key=layers.get)} {max(layers.values()):.4f}")
    if not layers or not all(map(math.isfinite, layers.values())) or (
            rel > limit):
        raise GateTripped(f"per-layer gradient norms: {rel} > {limit}")
    return dict(layers=len(layers), rel=rel)


def phase_train(dev, conf=FUSED, name="deit_small_distilled_patch16_224",
                batch=BATCH, gate=None, overrides=None, policy=None,
                loss_kind="kd_soft_hard", timed=True, step_options=None,
                keep=False, order_spread=False):
    """One QAT train step of the W2A2 student `name` (DeiT-S; Swin-T
    with `gate=SWIN_GATE` and `overrides=SWIN_BENCH`) under `policy` (None:
    QKR) with the float teacher, `loss_kind` (KD soft+hard; the telemetry
    losses with `overrides` `qqkkvv` or `return_features`) and AdamW,
    through the kernels of `conf`: K1 and K2 forward and K3 backward
    (fused, fp32 or the bf16 stream), K4 forward (pallas, bf16) or
    `int8_mm` (int8, bf16); the bf16 stream with fp32 masters and a bf16
    teacher, as bench.py builds it.  `timed=False` skips the img/s
    measurement; `step_options` go to `make_train_step`
    (`per_layer_grad_norms=True`: `check_layer_norms`); `keep` returns the
    student under "model".  A BatchNorm student (`overrides`
    `norm_layer="batchnorm"`): its running statistics must move in the
    step, and `check_step_grads` holds their updates as gradients."""
    import numpy as np
    import torch
    from ofq_tpu_torch import ops
    from ofq_tpu_torch.train import (TrainState, cosine_with_warmup_cooldown,
                                     make_optimizer, make_train_step)

    t0 = time.perf_counter()
    student, teacher, data = build_trained(dev, conf, name, batch,
                                           policy=policy,
                                           overrides=overrides)
    cfg = student.cfg
    opt = make_optimizer(cosine_with_warmup_cooldown(
        5.47e-4, epochs=300, warmup_epochs=5, warmup_lr=1e-6, min_lr=1e-5),
        weight_decay=0.05)
    state = TrainState.create(student, opt)
    step = make_train_step(student, opt, teacher=teacher,
                           loss_kind=loss_kind, device=dev,
                           **(step_options or {}))
    torch.cuda.synchronize()
    log(f"[train] {name} {_policy_label(policy)} student ({_describe(conf)}"
        f", {loss_kind}{', ' + str(overrides) if overrides else ''}) and "
        f"float teacher ({next(teacher.parameters()).dtype}) built, "
        f"calibrated in {time.perf_counter() - t0:.1f} s")

    stats0 = {k: v.clone() for k, v in bn_stats(student).items()}
    ops.reset_launch_counts()
    state, metrics = step(state, data)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    shapes = {**_shapes(ops.fused_qlinear_fwd),
              **_shapes(ops.pallas_statsq_fwd), **_shapes(ops.int8_mm)}
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    log(f"[train] launches in one step: {launches}; by (M,K,N): {shapes}; "
        f"loss {loss:.6f}, grad_norm {gnorm:.6f}")
    want = _expected(conf, cfg, train=True, policy=policy)
    if launches != want:
        raise AssertionError(f"expected launches per step {want}, got "
                             f"{launches}")
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        raise AssertionError(f"loss {loss}, grad_norm {gnorm}")
    extra = {}
    if stats0:
        stats = bn_stats(student)
        still = [k for k, v in stats.items()
                 if torch.equal(v, stats0[k]) or not torch.isfinite(v).all()]
        log(f"[train] BatchNorm: {len(stats)} running statistics, each "
            f"moved by the step and finite ({len(still)} not)")
        if still:
            raise AssertionError(f"running statistics not moved or not "
                                 f"finite: {still[:5]}")
    if (step_options or {}).get("per_layer_grad_norms"):
        extra["layer_norms"] = check_layer_norms(metrics, False)

    blocks = check_blocks_backward(student, teacher, data, conf, gate)
    grads = check_step_grads(student, teacher, data, conf,
                             loss_kind=loss_kind, order_spread=order_spread)
    tables = [r for r in grads["per_param"]
              if r["name"].endswith("relative_position_bias_table")]
    if tables:
        # the tables' gradient: a scatter-add of the gathered bias's
        log(f"[train] relative_position_bias_table gradients, kernels / "
            f"limit (plain, order spread): " + ", ".join(
                f"{r['name'].split('.')[0]} {r['rel_kernels']:.3e}/"
                f"{r['limit']:.3e} ({r['rel_plain']:.3e}, "
                f"{r.get('spread', float('nan')):.3e})" for r in tables))
    if int_path(conf) and grads["kernels_vs_plain_max"] != 0:
        # int8_mm and its plain version are both exact, and nothing else
        # of the step differs between the two paths
        raise GateTripped(f"[train] the whole-step gradients through "
                          f"int8_mm and through its plain version differ "
                          f"({grads['kernels_vs_plain_max']})")
    # K5's captured products: DeiT-S's (phase_k5_captured)
    captured = (capture_dx_products(student, teacher, data)
                if conf["matmul_impl"] == "pallas" and not is_swin(name)
                and policy is None else None)

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

    if keep:
        extra["model"] = student
    if not timed:
        prof = (phase_profile(lambda: float(step(state, data)[1]["loss"]),
                              f"{loss_kind} train step")
                if "--profile" in sys.argv else None)
        return dict(config=conf, loss_kind=loss_kind, profile=prof,
                    launches=launches, launch_shapes=shapes, loss=loss,
                    grad_norm=gnorm, blocks=blocks, grads=grads,
                    captured=None, **extra)
    torch.cuda.reset_peak_memory_stats()
    img_s = rate()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with plain_path(student):
        img_s_plain = rate()
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
                captured=captured, **extra)


# --------------------------------------------------------------- phase 6c
# The CGA finetune, phase 2 of train_scripts/deit_s/w2a2_deit_s.sh
# (`ofq_tpu.cli.cga ... --qk_reparam_type 1 --boundaryRange 0.005`): the
# learning rate pinned at min_lr, the selected kernels' freeze masks
# recomputed every step from the pre-update masters.  The FUSED_BF16 run
# also takes bf16 masters, the EMA and AGC on the card (the dampening loss
# and the norm and value clips run in the CPU tests only).
CGA = dict(bits=2, boundary_range=0.005, qk_reparam=True, model_type="deit")
# Swin-T's (train_scripts/swin_t/w2a2_swin_t.sh: --model_type swin), whose
# selection adds the patch mergings' reductions
CGA_SWIN = dict(CGA, model_type="swin")
CGA_LR = 1e-5
CGA_STEPS = 3
# the eval step's images, the last batch padded by EVAL_PAD rows of label -1
EVAL_IMAGES, EVAL_PAD = 256, 8
# the card's masks against the CPU's from the same fp32 masters: equal but
# where the pre-round image lies within this many fp32 ulps of a band edge
# (the scale's mean is summed in another order)
MASK_EDGE_ULPS = 2


def _bits(t):
    """A tensor's bit pattern, for comparisons that see every bit."""
    import torch
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16,
                   torch.float64: torch.int64}[t.dtype])


def _cga_masks(state, cga=CGA):
    """The port's freeze masks of the selected parameters, from the
    masters' fp32 view, as the step computes them."""
    import torch
    from ofq_tpu_torch.train import freeze_masks
    with torch.no_grad():
        views = {n: p.float() for n, p in state.params.items()}
        return {n: m for n, m in freeze_masks(views, **cga).items()
                if m is not None}


def cga_masks_on_cpu(state, masks):
    """The same fp32 masters taken to the CPU and masked there by the same
    function: the masks equal the card's, but where the pre-round image
    lies within MASK_EDGE_ULPS fp32 ulps of a band edge.  (differing,
    entries within the allowance)"""
    import numpy as np
    import torch
    from ofq_tpu_torch.quant import outer_freeze_mask, statsq_b4_round
    br = CGA["boundary_range"]
    differ = near = 0
    for n, m in masks.items():
        w = state.params[n].detach().float().cpu()
        b4 = statsq_b4_round(w, CGA["bits"])[0].numpy()
        frac = b4 - np.floor(b4)
        dist = np.minimum(np.abs(frac - (0.5 - br)), np.abs(frac - (0.5 + br)))
        edge = dist <= MASK_EDGE_ULPS * np.spacing(np.abs(b4))
        d = (outer_freeze_mask(w, CGA["bits"], br) != m.cpu()).numpy()
        if np.any(d & ~edge):
            raise GateTripped(f"masks: {n}: {int(np.sum(d & ~edge))} entries "
                              f"differ between the card and the CPU away "
                              f"from a band edge")
        differ += int(d.sum())
        near += int(edge.sum())
    return differ, near


def cga_steps(state, step, data, n, *, bf16, conf=None, cfg=None,
              cpu_masks=False, cga=CGA):
    """`n` CGA steps from `state`, each gated: the launches of the plain
    step (when `conf` is given), no frozen entry's bits changed, a
    trainable share in (0, 0.1) for every selected parameter, the masks
    against the CPU's (`cpu_masks`), the masters' and moments' dtypes and
    the EMA recomputed bit for bit (bf16 masters); after the last, the
    entries frozen at every step have zero moments (the state starts with
    zero moments).  Each gate raises GateTripped naming itself."""
    import torch
    from ofq_tpu_torch import ops
    out = dict(frozen_changed=0, moved=[], share=[], cpu_differing=0,
               cpu_near_edge=0, launches=None)
    always = None
    for _ in range(n):
        masks = _cga_masks(state, cga)
        for name, m in masks.items():
            share = float((m == 0).float().mean())
            if not 0.0 < share < 0.1:
                raise GateTripped(f"trainable share: {name} {share}")
            out["share"].append(share)
        always = ({k: m > 0.5 for k, m in masks.items()} if always is None
                  else {k: always[k] & (m > 0.5) for k, m in masks.items()})
        if cpu_masks:
            d, e = cga_masks_on_cpu(state, masks)
            out["cpu_differing"] += d
            out["cpu_near_edge"] += e
        before = {k: state.params[k].detach().clone() for k in masks}
        ema = ({k: e.clone() for k, e in state.ema_params.items()}
               if state.ema_params is not None else None)
        ops.reset_launch_counts()
        state, metrics = step(state, data)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        if conf is not None:
            want = _expected(conf, cfg, train=True)
            if launches != want:
                raise AssertionError(f"[cga] expected launches per step "
                                     f"{want}, got {launches}")
            out["launches"] = launches
        moved = {}
        for k, m in masks.items():
            diff = _bits(state.params[k].detach()) != _bits(before[k])
            out["frozen_changed"] += int((diff & (m > 0.5)).sum())
            moved[k] = int((diff & (m <= 0.5)).sum())
        out["moved"].append(moved)
        if out["frozen_changed"]:
            raise GateTripped(f"frozen bits: {out['frozen_changed']} frozen "
                              f"entries changed")
        if bf16:
            if any(p.dtype != torch.bfloat16 for p in state.params.values()):
                raise AssertionError("[cga] the masters left bf16")
            for k, e in state.ema_params.items():
                want = 0.9999 * ema[k] + (1.0 - 0.9999) * state.params[k].float()
                if e.dtype != torch.float32 or not torch.equal(
                        _bits(e), _bits(want)):
                    raise AssertionError(f"[cga] the EMA of {k} is not "
                                         f"decay * e + (1 - decay) * p")
        moments = (list(state.opt_state.mu.values())
                   + list(state.opt_state.nu.values()))
        if any(t.dtype != torch.float32 for t in moments):
            raise AssertionError("[cga] the moments are not fp32")
        out["loss"] = float(metrics["loss"])
        out["grad_norm"] = float(metrics["grad_norm"])
    nonzero = sum(int((state.opt_state.mu[k][a] != 0).sum()
                      + (state.opt_state.nu[k][a] != 0).sum())
                  for k, a in always.items())
    out["always_frozen"] = sum(int(a.sum()) for a in always.values())
    if nonzero or not out["always_frozen"]:
        raise GateTripped(f"moments: {nonzero} moments nonzero among the "
                          f"{out['always_frozen']} entries frozen at every "
                          f"step")
    return state, out


def check_eval(student, state, dev):
    """`make_eval_step` over EVAL_IMAGES seeded images in batches of
    BATCH, the last padded by EVAL_PAD rows of label -1, against the top-1
    and top-5 hits of `Predictor.predict` on the same images (the padded
    batch through a Predictor of that batch size, so that both run the
    same shapes)."""
    import numpy as np
    from ofq_tpu_torch.serve import Predictor
    from ofq_tpu_torch.train import make_eval_step
    cfg = student.cfg
    rng = np.random.default_rng(7)
    images = rng.normal(size=(EVAL_IMAGES, cfg.img_size, cfg.img_size,
                              3)).astype(np.float32)
    chunks = [images[i:i + BATCH] for i in range(0, EVAL_IMAGES, BATCH)]
    probs = np.concatenate([
        Predictor(student, batch_size=BATCH + (EVAL_PAD if i == len(chunks)
                                               else 0),
                  img_size=cfg.img_size, device=dev).predict(c)
        for i, c in enumerate(chunks, 1)])
    order = np.argsort(-probs, axis=1, kind="stable")[:, :5]
    label = rng.integers(0, cfg.num_classes, size=EVAL_IMAGES)
    # labels that the predictions hit at rank 1 and rank 3
    label[::4], label[1::4] = order[::4, 0], order[1::4, 2]
    want1 = int(np.sum(order[:, 0] == label))
    want5 = int(np.sum(np.any(order == label[:, None], axis=1)))
    # rows whose probabilities tie across rank 1 or rank 5 (both sides rank
    # the lower class first there)
    srt = -np.sort(-probs, axis=1)
    ties = int(np.sum((srt[:, 0] == srt[:, 1]) | (srt[:, 4] == srt[:, 5])))
    step = make_eval_step(student)
    got = dict(correct1=0, correct5=0, count=0, loss_sum=0.0)
    for i in range(0, EVAL_IMAGES, BATCH):
        x, y = images[i:i + BATCH], label[i:i + BATCH]
        if i + BATCH >= EVAL_IMAGES:
            x = np.concatenate([x, np.zeros((EVAL_PAD,) + x.shape[1:],
                                            x.dtype)])
            y = np.concatenate([y, -np.ones(EVAL_PAD, y.dtype)])
        m = step(state.params, {"image": x, "label": y})
        for k in got:
            got[k] += float(m[k])
    if (got["correct1"], got["correct5"], got["count"]) != (
            want1, want5, EVAL_IMAGES):
        raise AssertionError(f"[cga] eval step {got} against the "
                             f"Predictor's top-1 {want1}, top-5 {want5} of "
                             f"{EVAL_IMAGES} ({ties} rows tied at rank 1 "
                             f"or 5)")
    return dict(got, predictor_top1=want1, predictor_top5=want5, ties=ties)


def phase_cga(dev, conf=FUSED, name="deit_small_distilled_patch16_224",
              batch=BATCH, bf16_masters=None, selfchecks=True):
    """The CGA finetune step of the W2A2 QKR student `name` (DeiT-S, or
    Swin-T with `model_type="swin"` and bench.py's drop_path 0.0;
    `qk_reparam_type=1`, boundary range 0.005) with the float teacher, KD
    soft+hard and AdamW
    at the constant learning rate CGA_LR, through the kernels of `conf`
    (fp32 masters; under FUSED_BF16 bf16 masters, EMA 0.9999 and AGC
    0.01): CGA_STEPS gated steps (`cga_steps`), the eval step against the
    Predictor (`check_eval`), the step's wall ms beside the same step
    without CGA (plain, CGA, CGA, plain), with --profile its device time.
    `bf16_masters` (default: whether `conf` runs the bf16 stream) selects
    bf16 masters, the EMA and AGC.  With fp32 masters (and `selfchecks`)
    the gate self-check: `restore_frozen` replaced by "take
    the new value" must trip the frozen-bits gate, `mask_grads` replaced
    by the identity the moments gate, and the unmodified step must pass
    (at CGA_LR in bf16 the weight decay of a frozen entry stays under half
    a bf16 ulp, so the restore fault is seen only with fp32 masters)."""
    import dataclasses

    import numpy as np
    import torch
    from ofq_tpu_torch.train import (TrainState, constant_lr, make_optimizer,
                                     make_train_step)
    from ofq_tpu_torch.train import cga as cga_lib

    bf16 = (conf["compute_dtype"] == "bfloat16" if bf16_masters is None
            else bf16_masters)
    swin = is_swin(name)
    cga = CGA_SWIN if swin else CGA
    t0 = time.perf_counter()
    policy = dataclasses.replace(_family(name)[1], qk_reparam_type=1,
                                 boundary_range=cga["boundary_range"])
    student, teacher, data = build_trained(
        dev, conf, name, batch, policy=policy,
        overrides=SWIN_BENCH if swin else None)
    cfg = student.cfg
    options = (dict(master_dtype="bfloat16", ema_decay=0.9999) if bf16
               else {})
    opt = make_optimizer(constant_lr(CGA_LR), weight_decay=0.05,
                         **(dict(clip_grad=0.01, clip_mode="agc") if bf16
                            else {}))

    def fresh():
        return TrainState.create(student, opt, ema=bf16,
                                 master_dtype=options.get("master_dtype"))

    def make(cga):
        return make_train_step(student, opt, teacher=teacher,
                               loss_kind="kd_soft_hard", device=dev, cga=cga,
                               **options)

    step, plain = make(cga), make(None)
    torch.cuda.synchronize()
    what = (f"{_describe(conf)}, {'bf16 masters, EMA 0.9999, AGC 0.01' if bf16 else 'fp32 masters'}")
    log(f"[cga] {name} W2A2 QKR student (qk_reparam_type=1) and float "
        f"teacher built in {time.perf_counter() - t0:.1f} s; {what}")

    # under fp32 masters a fresh state holds the student's own tensors,
    # so the self-check steps would move the student: they start from a
    # snapshot of it (the image quantizer's sign included) and it is put
    # back after them
    snapshot = {k: v.clone() for k, v in student.state_dict().items()}
    selfcheck = []
    faults = {"restore_frozen": lambda real: (
                  lambda old, new, masks: dict(new)),
              "mask_grads": lambda real: (lambda g, masks: dict(g))}
    if not bf16 and selfchecks:
        for fault, label, gate in (
                ("restore_frozen", "restore_frozen taking the new value",
                 "frozen bits"),
                ("mask_grads", "mask_grads as the identity", "moments"),
                (None, "unmodified step", None)):
            ctx = (injected(cga_lib, fault, faults[fault]) if fault
                   else contextlib.nullcontext())
            with ctx:
                tripped, msg = _tripped(lambda: cga_steps(
                    fresh(), step, data, 1, bf16=bf16))
            ok = (tripped and msg.startswith(gate)) if fault else not tripped
            selfcheck.append(dict(fault=label, gate=gate, tripped=tripped,
                                  ok=ok))
            log(f"[selfcheck] CGA step, {label}: "
                f"{'tripped' if tripped else 'passed'} (required: "
                f"{'the ' + gate + ' gate trips' if fault else 'pass'})"
                f"{' -- ' + msg if msg else ''}")
            if not ok:
                raise AssertionError(f"CGA gate self-check: {label}")
            student.load_state_dict(snapshot)

    state = fresh()
    selected = sorted(_cga_masks(state, cga))
    reductions = [k for k in selected if ".reduction." in k]
    if swin and len(reductions) != len(cfg.depths) - 1:
        raise AssertionError(f"[cga] the Swin selection holds the "
                             f"reductions {reductions}")
    state, gates = cga_steps(state, step, data, CGA_STEPS, bf16=bf16,
                             conf=conf, cfg=cfg, cpu_masks=True, cga=cga)
    never = [k for k in gates["moved"][0]
             if not all(m[k] for m in gates["moved"])]
    if not bf16 and never:
        raise GateTripped(f"trainable moved: no trainable entry of {never} "
                          f"moved at some step")
    moved = [sum(m.values()) for m in gates["moved"]]
    share = gates["share"]
    ev = check_eval(student, state, dev)

    def ms(fn):
        nonlocal state
        for _ in range(TRAIN_STEPS_WARM):
            state, m = fn(state, data)
        float(m["loss"])
        t = time.perf_counter()
        for _ in range(TRAIN_STEPS_TIMED):
            state, m = fn(state, data)
        if not np.isfinite(float(m["loss"])):  # host fetch: the barrier
            raise AssertionError("non-finite loss")
        return (time.perf_counter() - t) * 1e3 / TRAIN_STEPS_TIMED

    times = [ms(f) for f in (plain, step, step, plain)]
    cga_ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
    log(f"[cga] {name}, {_describe(conf)}, "
        f"{'bf16 masters, EMA, AGC' if bf16 else 'fp32 masters'}: "
        f"{len(selected)} kernels selected ({len(reductions)} reductions); "
        f"{CGA_STEPS} steps at lr {CGA_LR}, launches per step "
        f"{gates['launches']}; {gates['frozen_changed']} of the frozen "
        f"entries changed "
        f"({gates['always_frozen']} frozen at every step, their moments 0); "
        f"trainable entries moved per step {moved}; trainable share per "
        f"parameter min {min(share):.5f} mean {np.mean(share):.5f} max "
        f"{max(share):.5f}; masks card vs CPU: {gates['cpu_differing']} "
        f"differing, {gates['cpu_near_edge']} images within "
        f"{MASK_EDGE_ULPS} ulps of a band edge; loss "
        f"{gates['loss']:.6f}, grad_norm {gates['grad_norm']:.6f}; eval "
        f"top-1 {ev['correct1']:.0f} top-5 {ev['correct5']:.0f} of "
        f"{ev['count']:.0f} (Predictor {ev['predictor_top1']} / "
        f"{ev['predictor_top5']}; {ev['ties']} rows tied at rank 1 or 5), "
        f"loss_sum {ev['loss_sum']:.4f}; wall ms "
        f"per step B={batch}: CGA {cga_ms:.2f}, without CGA {plain_ms:.2f} "
        f"(plain, CGA, CGA, plain: {', '.join(f'{t:.2f}' for t in times)})")
    prof = (phase_profile(lambda: float(step(state, data)[1]["loss"]),
                          "CGA train step")
            if "--profile" in sys.argv else None)
    return dict(model=name, config=conf, bf16_masters=bf16, gates=gates,
                eval=ev, selected=len(selected), reductions=reductions,
                selfcheck=selfcheck, cga_ms=cga_ms, plain_ms=plain_ms,
                ms_in_turns=times, profile=prof)


def _kd_loss(model, teacher, x, label, loss_kind="kd_soft_hard"):
    """The step's loss as `make_train_step` forms it (KD soft+hard, or a
    telemetry loss on the models' aux)."""
    import torch
    from ofq_tpu_torch.train import (kd_soft_and_hard, kd_soft_hard_qk,
                                     kl_token_mse)
    if loss_kind == "kd_soft_hard":
        with torch.no_grad():
            t_logits = teacher(x)
        return kd_soft_and_hard(model(x), label, t_logits)
    with torch.no_grad():
        t_logits, t_info = teacher(x, aux=True)
    out, info = model(x, aux=True)
    if loss_kind == "kd_token":
        return kl_token_mse(out[0] if isinstance(out, tuple) else out,
                            info["features"], t_logits, t_info["features"])
    return kd_soft_hard_qk(out, info, label, t_logits, t_info,
                           include_v=loss_kind == "kd_qkv")


def _grad_gate(what, rows, all_params=None):
    """The gradient rule (above GRAD_GATE_MIN_FLOOR) on `rows`, each with
    `rel_kernels` and `rel_plain` (distances from the reference), and on
    `all_params` (`kernels` and `plain`, the same for all parameters
    together).  A row (or `all_params`) that also holds `spread`, its order
    spread (the bf16 whole step), is held to 2 x spread + floor; else to
    2 x plain + floor."""
    rk = sorted(r["rel_kernels"] for r in rows)
    rp = sorted(r["rel_plain"] for r in rows)
    floor = max(GRAD_GATE_MIN_FLOOR, rp[len(rp) // 2])
    by_spread = "spread" in rows[0]

    def limit(r, plain="rel_plain"):
        return 2 * r.get("spread", r[plain]) + floor

    for r in rows:
        r["limit"] = limit(r)
    bad = [r for r in rows if r["rel_kernels"] > limit(r)]
    worst = max(rows, key=lambda r: r["rel_kernels"] / limit(r))
    spread = ""
    if by_spread:
        sp = sorted(r["spread"] for r in rows)
        spread = (f"; order spread median {sp[len(sp) // 2]:.3e} max "
                  f"{sp[-1]:.3e}")
    log(f"{what}, relative L2 per parameter ({len(rows)}): kernels median "
        f"{rk[len(rk) // 2]:.3e} max {rk[-1]:.3e}; plain median "
        f"{rp[len(rp) // 2]:.3e} max {rp[-1]:.3e}{spread}"
        + ("" if all_params is None else
           f"; all parameters together: kernels "
           f"{all_params['kernels']:.3e}, plain {all_params['plain']:.3e}"
           + (f", order spread {all_params['spread']:.3e}"
              if "spread" in all_params else "")
           + f" (limit {limit(all_params, 'plain'):.3e})")
        + f"; gate kernels <= 2 x {'order spread' if by_spread else 'plain'}"
        f" + {floor:.3e}, closest {worst['name']} ({worst['rel_kernels']:.3e}"
        f" against the limit {limit(worst):.3e})")
    if by_spread:
        # what decides a redesigned kernel: the LSQ scales behind the
        # softmax, every parameter refused and the five nearest their limits
        near = sorted(rows, key=lambda r: r["rel_kernels"] / limit(r))[-5:]
        watch = [r for r in rows if "quan_softmax" in r["name"] or r in bad
                 or r in near]
        log(f"{what}: kernels / limit of every quan_softmax scale, every "
            f"refused parameter and the five nearest their limits: "
            + ", ".join(f"{r['name']} {r['rel_kernels']:.3e}/{limit(r):.3e}"
                        for r in watch))
    if bad or (all_params is not None and all_params["kernels"]
               > limit(all_params, "plain")):
        raise GateTripped(f"{what}: gradient gate failed: {bad[:5]}, "
                          f"{all_params}")
    return floor


def _rel(a, ref):
    return float((a - ref).norm()) / max(float(ref.norm()), 1e-30)


def check_blocks_backward(model, teacher, data, conf=FUSED, gate=None):
    """Each block's VJP alone, on the plain path's input to that block and
    its upstream gradient (captured with hooks on one plain backward): in
    fp32 the rows of dx through the kernels against the plain versions; in
    bf16 the rows of dx and the block's parameter gradients of both paths
    against the rounded-once reference (above BLOCK_ROWS).  The blocks are
    `model.block_names` (DeiT's `blocks_*`, Swin's `features_*`: its
    blocks and patch mergings); `gate` (`rows`, `row_floor`: SWIN_GATE)
    replaces BLOCK_ROWS and, where larger, BACKWARD_ROW_FLOOR."""
    import torch
    gate = gate or dict(rows=BLOCK_ROWS, row_floor=0.0)
    seen = {}
    bf16 = conf["compute_dtype"] is not None

    def fwd_hook(name):
        def hook(mod, args, out):
            seen[name] = [args[0].detach()]
            out.register_hook(lambda g: seen[name].append(g.detach()))
        return hook

    hooks = [getattr(model, n).register_forward_hook(fwd_hook(n))
             for n in model.block_names]
    model.train()
    try:
        with plain_path(model):
            _kd_loss(model, teacher, data["image"], data["label"]).backward()
    finally:
        for h in hooks:
            h.remove()
    model.zero_grad(set_to_none=True)
    paths = {"kernels": contextlib.nullcontext,
             "plain": lambda: plain_path(model)}
    if bf16:
        paths["reference"] = lambda: reference_path(model)
    rows, params = [], []
    for name in model.block_names:
        x_in, g_out = seen.pop(name)
        block = getattr(model, name)
        named = dict(block.named_parameters())
        out = {}
        for path, ctx in paths.items():
            with ctx():
                xi = x_in.clone().requires_grad_()
                y = block(xi)
                gs = torch.autograd.grad(
                    y, [xi, *named.values()] if bf16 else [xi], g_out,
                    allow_unused=True)
            out[path] = [gs[0]] + [
                torch.zeros_like(p) if g is None else g.double()
                for p, g in zip(named.values(), gs[1:])]
            del y, xi, gs
        if not torch.isfinite(out["kernels"][0]).all():
            raise GateTripped(f"{name}: non-finite dx")
        dx_k, dx_p = out["kernels"][0], out["plain"][0]
        if not bf16:
            rows.append(_row_shares(dx_k, dx_p, conf))
            continue
        dx_r = out["reference"][0]
        fl = max(BACKWARD_ROW_FLOOR, gate["row_floor"])
        rows.append((_row_shares(dx_k, dx_r, conf, fl)[0],
                     _row_shares(dx_p, dx_r, conf, fl)[0],
                     *_row_shares(dx_k, dx_p, conf)))
        for i, n in enumerate(named, 1):
            ref = out["reference"][i]
            params.append(dict(name=f"{name}.{n}",
                               rel_kernels=_rel(out["kernels"][i], ref),
                               rel_plain=_rel(out["plain"][i], ref)))
    what = "[train] each block's backward alone, on the same input and " \
           "upstream gradient, rows of dx"
    if not bf16:
        return _log_rows(what + ", kernels vs plain", rows)
    res = _block_rows_gate(what, rows, gate["rows"])
    res["param_floor"] = _grad_gate(
        "[train] each block's parameter gradients alone against the "
        "rounded-once reference", params)
    res["params"] = params
    return res


def check_step_grads(model, teacher, data, conf=FUSED, orders=None,
                     loss_kind="kd_soft_hard", order_spread=False):
    """The whole step's parameter gradients through the kernels and through
    the plain versions, each against the reference (above
    GRAD_GATE_MIN_FLOOR) and against the composed model in fp64 on the
    card (the same weights, scales and batch; no bf16 stream; printed, and
    the fp32 gate's reference), and against each other.  In bf16 the gate
    allows each parameter 2 x its order spread: the largest distance from
    the reference over the plain path and the plain path summed in
    ORDER_CHUNKS chunks (`summed_in_chunks`).  `orders`: a dict that keeps
    the chunked paths' gradients between calls on the same model, weights
    and batch (they do not depend on the kernels).  The loss is
    `loss_kind`'s; the three paths' losses are printed, and for a
    telemetry loss in fp32 the kernel path's is held to 2 x the plain
    path's distance from the fp64 model's + 1e-4 of it.  `order_spread`
    holds an fp32 path to the order spread too (against the fp64 model),
    and prints how many parameters 2 x the plain path's distance alone
    would refuse."""
    import torch
    losses = {}
    # a BatchNorm student's running-statistic updates on each path (each
    # path starts from the same statistics)
    updates = {}

    def grads(m, t, x, key=None, tag=None):
        params = dict(m.named_parameters())
        before = {k: v.clone() for k, v in bn_stats(m).items()}
        loss = _kd_loss(m, t, x, data["label"], loss_kind)
        g = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
        if key:
            losses[key] = float(loss.detach())
        if before:
            with torch.no_grad():
                after = bn_stats(m)
                updates[tag or key] = {k: after[k].double() - v.double()
                                       for k, v in before.items()}
                for k, v in before.items():
                    after[k].copy_(v)
        return {n: (torch.zeros_like(p) if gi is None else gi).double()
                for (n, p), gi in zip(params.items(), g)}

    model.train()
    g_k = grads(model, teacher, data["image"], "kernels")
    with plain_path(model):
        g_p = grads(model, teacher, data["image"], "plain")
    ref = composed_fp64(model)
    t64 = composed_fp64(teacher)
    g_64 = grads(ref, t64, data["image"].double(), "fp64")
    del ref, t64
    lim = 2 * abs(losses["plain"] - losses["fp64"]) + 1e-4 * abs(
        losses["fp64"])
    gated = loss_kind != "kd_soft_hard" and conf["compute_dtype"] is None
    log(f"[train] {loss_kind} loss: kernels {losses['kernels']:.8f}, plain "
        f"{losses['plain']:.8f}, composed fp64 {losses['fp64']:.8f}"
        + (f" (gate: |kernels - fp64| <= {lim:.3e})" if gated else ""))
    if gated and abs(losses["kernels"] - losses["fp64"]) > lim:
        raise GateTripped(f"{loss_kind}: the kernel path's loss "
                          f"{losses['kernels']} is farther than {lim} from "
                          f"the fp64 model's {losses['fp64']}")
    bf16 = conf["compute_dtype"] is not None
    if bf16:
        with reference_path(model):
            g_r = grads(model, teacher, data["image"], tag="reference")
    else:
        g_r = g_64

    def rows_against(gref):
        return [dict(name=n, rel_kernels=_rel(g_k[n], g),
                     rel_plain=_rel(g_p[n], g)) for n, g in gref.items()]

    def together(gref, paths=None):
        norm = float(sum(float(g.square().sum()) for g in gref.values())
                     ) ** 0.5

        def dist(g):
            return float(sum(float((g[n] - gref[n]).square().sum())
                             for n in gref)) ** 0.5 / norm
        return {k: dist(g) for k, g in
                (paths or {"kernels": g_k, "plain": g_p}).items()}

    rkp = max(_rel(g_k[n], g_p[n]) for n in g_p)
    log(f"[train] whole-step gradients, kernels vs plain: largest relative "
        f"L2 per parameter {rkp:.3e}")
    rows_64, glob_64 = rows_against(g_64), together(g_64)
    if bf16:
        rk = sorted(r["rel_kernels"] for r in rows_64)
        rp = sorted(r["rel_plain"] for r in rows_64)
        log(f"[train] whole-step gradients vs the composed fp64 model (not "
            f"gated in bf16): kernels median {rk[len(rk) // 2]:.3e}, plain "
            f"median {rp[len(rp) // 2]:.3e}; all parameters together: "
            f"kernels {glob_64['kernels']:.3e}, plain {glob_64['plain']:.3e}")
    rows, glob = rows_against(g_r), together(g_r)
    spread = bf16 or order_spread
    if spread:
        orders = {} if orders is None else orders
        for j in ORDER_CHUNKS:
            if j not in orders:
                with plain_path(model), summed_in_chunks(j):
                    orders[j] = grads(model, teacher, data["image"],
                                      tag=("chunks", j))
                    if ("chunks", j) in updates:
                        orders[("stats", j)] = updates[("chunks", j)]
        paths = [g_p] + [orders[j] for j in ORDER_CHUNKS]
        for r in rows:
            r["spread"] = max(_rel(g[r["name"]], g_r[r["name"]])
                              for g in paths)
        glob["spread"] = max(
            together(g_r, {"kernels": g})["kernels"] for g in paths)
    if spread and not bf16:
        rp = sorted(r["rel_plain"] for r in rows)
        fl = max(GRAD_GATE_MIN_FLOOR, rp[len(rp) // 2])
        past = [r["name"] for r in rows
                if r["rel_kernels"] > 2 * r["rel_plain"] + fl]
        log(f"[train] whole-step gradients, fp32 held to the order spread: "
            f"2 x the plain path's distance + {fl:.3e} alone would refuse "
            f"{len(past)} of {len(rows)} parameters {past[:5]}")
    floor = _grad_gate(
        "[train] whole-step gradients vs the "
        + ("rounded-once reference" if bf16 else "composed fp64 model"),
        rows, glob)
    out = dict(floor=floor, all_params=glob, all_params_fp64=glob_64,
               kernels_vs_plain_max=rkp, per_param=rows,
               per_param_fp64=rows_64, losses=losses)
    if updates:
        # the running statistics held as the gradients are: each
        # BatchNorm's update (new - old) through the kernels against the
        # reference's, within 2 x the plain path's distance (bf16: its
        # order spread) + the floor
        u_r = updates["reference" if bf16 else "fp64"]
        srows = [dict(name=k, rel_kernels=_rel(updates["kernels"][k], r),
                      rel_plain=_rel(updates["plain"][k], r))
                 for k, r in u_r.items()]
        if spread:
            for r in srows:
                r["spread"] = max(_rel(u[r["name"]], u_r[r["name"]])
                                  for u in [updates["plain"]] + [
                                      orders[("stats", j)]
                                      for j in ORDER_CHUNKS])
        out["bn_floor"] = _grad_gate(
            "[train] BatchNorm running-statistic updates vs the "
            + ("rounded-once reference" if bf16 else "composed fp64 model"),
            srows)
        out["bn_stats"] = srows
    return out


# ------------------------------------------------------ dropout, remat
# the rates of phase_dropout's and phase_remat's steps (attention dropout
# 0, so the fused and checkpointed tails run)
DROP = dict(drop_rate=0.1, drop_path_rate=0.1)
# a mask's kept share: within this many binomial standard deviations of
# keep
KEPT_SIGMAS = 5


def _step_grads(model, teacher, data, generator):
    """The KD loss of one train-mode forward of `model` drawing its masks
    from `generator`, and every parameter's gradient."""
    import torch
    from ofq_tpu_torch.train import kd_soft_and_hard
    model.train()
    with torch.no_grad():
        t_logits = teacher(data["image"])
    params = dict(model.named_parameters())
    loss = kd_soft_and_hard(model(data["image"], generator), data["label"],
                            t_logits)
    g = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), {n: gi for n, gi in zip(params, g)
                           if gi is not None}


def _differing(a, b):
    """The names whose loss or gradient bits differ between two
    `_step_grads` results."""
    import torch
    (la, ga), (lb, gb) = a, b
    out = [] if torch.equal(_bits(la), _bits(lb)) else ["loss"]
    if set(ga) != set(gb):
        return out + sorted(set(ga) ^ set(gb))
    return out + [n for n in ga if not torch.equal(_bits(ga[n]),
                                                   _bits(gb[n]))]


@contextlib.contextmanager
def recorded_masks():
    """Every mask `nn.dropout.bernoulli` draws while active, as (shape,
    keep, kept count on the device)."""
    from ofq_tpu_torch.nn import dropout as dmod
    seen = []

    def record(real):
        def rec(shape, keep, generator):
            m = real(shape, keep, generator)
            seen.append((tuple(shape), keep, m.sum()))
            return m
        return rec

    with injected(dmod, "bernoulli", record):
        yield seen


def _kept_shares(masks):
    """Each mask's kept share against keep (binomial: within KEPT_SIGMAS
    standard deviations)."""
    import math
    rows = []
    for shape, keep, kept in masks:
        n = math.prod(shape)
        share = float(kept) / n
        sd = math.sqrt(keep * (1 - keep) / n)
        rows.append(dict(shape=list(shape), keep=keep, share=share,
                         sigmas=abs(share - keep) / sd))
    bad = [r for r in rows if r["sigmas"] > KEPT_SIGMAS]
    if bad:
        raise GateTripped(f"kept shares outside {KEPT_SIGMAS} sigma: "
                          f"{bad[:5]}")
    return rows


def _one_step(dev, student, teacher, data, conf, generator):
    """One `make_train_step` step (lr 1e-5) drawing from `generator`: its
    launches against `_expected`, every mask's kept share, the default
    CUDA generator untouched; the student is put back afterwards."""
    import numpy as np
    import torch
    from ofq_tpu_torch import ops
    from ofq_tpu_torch.train import (TrainState, constant_lr, make_optimizer,
                                     make_train_step)
    snapshot = {k: v.clone() for k, v in student.state_dict().items()}
    opt = make_optimizer(constant_lr(1e-5), weight_decay=0.05)
    step = make_train_step(student, opt, teacher=teacher,
                           loss_kind="kd_soft_hard", device=dev)
    default = torch.cuda.get_rng_state()
    ops.reset_launch_counts()
    with recorded_masks() as masks:
        _, met = step(TrainState.create(student, opt), data, generator)
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = _expected(conf, student.cfg, train=True)
    if launches != want:
        raise AssertionError(f"[dropout] expected launches per step {want}"
                             f", got {launches}")
    if not torch.equal(torch.cuda.get_rng_state(), default):
        raise AssertionError("[dropout] the step drew from the default "
                             "CUDA generator")
    loss, gnorm = float(met["loss"]), float(met["grad_norm"])
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        raise AssertionError(f"[dropout] loss {loss}, grad_norm {gnorm}")
    student.load_state_dict(snapshot)
    return dict(launches=launches, loss=loss, grad_norm=gnorm,
                masks=_kept_shares(masks))


def phase_dropout(dev, name="deit_small_distilled_patch16_224",
                  swin_name="swin_t", batch=BATCH):
    """Dropout and drop-path on the card, masks from CUDA generators: one
    DeiT-S fused fp32 step with drop_rate = drop_path_rate = 0.1 (36 K1,
    12 K2, 12 K3, as the plain step; every mask's kept share within
    KEPT_SIGMAS binomial standard deviations of keep; the default CUDA
    generator untouched); the loss and gradients of two steps from the
    same state with generators seeded alike bit for bit equal, another
    seed's not; attention dropout 0.1: no K2 or K3 in the train step (the
    composition, as in JAX), 12 K2 in an eval forward; one Swin-T pallas
    step at SwinConfig's default drop_path_rate 0.2 (39 K4)."""
    import torch
    from ofq_tpu_torch import ops
    from ofq_tpu_torch.models import create_model

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    from ofq_tpu_torch.models.swin import SwinConfig

    t0 = time.perf_counter()
    student, teacher, data = build_trained(dev, FUSED, name, batch,
                                           overrides=DROP)
    fused = _one_step(dev, student, teacher, data, FUSED, gen(5))
    sites = fused["masks"]
    depth = student.cfg.depth
    # pos_drop, each block's proj_drop and two MLP dropouts, drop-path on
    # both branches of every block but the first (rate 0)
    if len(sites) != 1 + 3 * depth + 2 * (depth - 1):
        raise AssertionError(f"[dropout] {len(sites)} masks drawn")
    a = _step_grads(student, teacher, data, gen(7))
    b = _step_grads(student, teacher, data, gen(7))
    c = _step_grads(student, teacher, data, gen(8))
    same, other = _differing(a, b), _differing(a, c)
    n_grads = len(a[1])
    del a, b, c
    if same or len(other) < n_grads // 4:
        raise AssertionError(f"[dropout] same seed: {same[:5]} differ; "
                             f"other seed: {len(other)} differ")
    cfg = student.cfg
    attn = create_model(name, policy=student.policy, device=dev, **FUSED,
                        **DROP, attn_drop_rate=0.1)
    attn.load_state_dict(student.state_dict())
    del student
    torch.cuda.empty_cache()
    train_attn = _one_step(dev, attn, teacher, data,
                           dict(FUSED, attn_impl=None), gen(6))
    attn.eval()
    ops.reset_launch_counts()
    with torch.no_grad():
        attn(data["image"])
    torch.cuda.synchronize()
    eval_attn = ops.launch_counts()
    want = _expected(FUSED, cfg, train=False)
    if eval_attn != want:
        raise AssertionError(f"[dropout] eval with attention dropout: "
                             f"expected {want}, got {eval_attn}")
    del attn, teacher, data
    torch.cuda.empty_cache()
    s_student, s_teacher, s_data = build_trained(
        dev, PALLAS, swin_name, batch,
        overrides=dict(drop_path_rate=SwinConfig().drop_path_rate))
    if s_student.cfg.drop_path_rate != 0.2:
        raise AssertionError("[dropout] SwinConfig's default drop_path_rate")
    swin = _one_step(dev, s_student, s_teacher, s_data, PALLAS, gen(9))
    n_blocks = sum(s_student.cfg.depths)
    if len(swin["masks"]) != 2 * (n_blocks - 1):
        raise AssertionError(f"[dropout] Swin-T: {len(swin['masks'])} "
                             f"masks drawn")
    del s_student, s_teacher, s_data
    torch.cuda.empty_cache()

    def worst(rows):
        return max(r["sigmas"] for r in rows)

    def nz(launches):
        return {k: v for k, v in launches.items() if v}

    log(f"[dropout] DeiT-S fused fp32, drop_rate = drop_path_rate = 0.1: "
        f"launches {fused['launches']}, {len(sites)} masks, kept shares "
        f"within {worst(sites):.2f} sigma (drop-path: "
        f"{[round(r['share'], 4) for r in sites if len(r['shape']) == 3 and r['shape'][1] == 1]}"
        f"), the default CUDA generator untouched; same seed: 0 of the "
        f"loss and gradients differ, another seed: {len(other)}; "
        f"attn_drop_rate 0.1: train step launches "
        f"{nz(train_attn['launches'])}, eval forward {nz(eval_attn)}; "
        f"Swin-T pallas bf16 at drop_path_rate 0.2: launches "
        f"{nz(swin['launches'])}, {len(swin['masks'])} drop-path "
        f"masks within {worst(swin['masks']):.2f} sigma, loss "
        f"{swin['loss']:.6f} ({time.perf_counter() - t0:.1f} s)")
    return dict(fused=fused, other_seed_differing=len(other),
                attn_train=train_attn, attn_eval_launches=eval_attn,
                swin=swin)


def phase_remat(dev, names=("deit_small_distilled_patch16_224", "swin_t"),
                batch=BATCH):
    """Block and attention-tail remat with dropout on (DROP): DeiT-S fused
    fp32 with `remat=True` and with `attn_impl='remat'`, Swin-T pallas
    bf16 with `remat_stages=(0, 1, 2, 3)` and with `attn_impl='remat'`.
    Each one's loss and gradients bit for bit equal to the same step
    without remat from a CUDA generator seeded alike (the block forms
    against the model without them, the tail against the same tail with
    the checkpoint a direct call); peak memory of both; the launches of
    the remat step (a checkpointed block's kernels run again in the
    recompute).  Also two plain steps alike, the witness that the step is
    deterministic on the card."""
    import torch
    from ofq_tpu_torch import ops
    from ofq_tpu_torch.models import create_model
    from ofq_tpu_torch.nn import attention as tattn

    def direct(real):
        return lambda fn, *args, **kw: fn(*args)

    def measured(model, teacher, data, ctx=contextlib.nullcontext):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with ctx():
            r = _step_grads(model, teacher, data,
                            torch.Generator(device=dev).manual_seed(11))
        torch.cuda.synchronize()
        return r, torch.cuda.max_memory_allocated() / 1e9, {
            k: v for k, v in ops.launch_counts().items() if v}

    out = []
    for name in names:
        conf, overrides = (PALLAS if is_swin(name) else FUSED), DROP
        t0 = time.perf_counter()
        student, teacher, data = build_trained(dev, conf, name, batch,
                                               overrides=overrides)
        plain, plain_gb, plain_launches = measured(student, teacher, data)
        again = _differing(plain, measured(student, teacher, data)[0])
        block = (dict(remat=True) if not is_swin(name)
                 else dict(remat_stages=(0, 1, 2, 3)))
        for form, extra in (("block", block),
                            ("attention tail", dict(attn_impl="remat"))):
            m = create_model(name, policy=student.policy, device=dev,
                             **dict(conf, **extra), **overrides)
            m.load_state_dict(student.state_dict())
            if form == "block":
                ref, ref_gb = plain, plain_gb
            else:
                ref, ref_gb, _ = measured(
                    m, teacher, data,
                    lambda: injected(tattn, "checkpoint", direct))
            got, gb, launches = measured(m, teacher, data)
            differ = _differing(ref, got)
            row = dict(model=name, form=form, config=extra,
                       differing=differ, peak_gb=gb, without_gb=ref_gb,
                       launches=launches, plain_launches=plain_launches,
                       plain_twice_differing=again)
            out.append(row)
            log(f"[remat] {name} {_describe(conf)}, {form} remat {extra}, "
                f"dropout {overrides}: {len(differ)} of the loss and "
                f"{len(got[1])} gradients differ from the step without it "
                f"{differ[:5]}; peak memory {gb:.2f} GB against "
                f"{ref_gb:.2f}; launches {launches} (without remat "
                f"{plain_launches}); two plain steps alike: {len(again)} "
                f"differ {again[:3]}")
            del m, got, ref
            if differ:
                raise GateTripped(f"[remat] {name} {form}: {differ[:5]}")
        del student, teacher, data, plain
        torch.cuda.empty_cache()
        log(f"[remat] {name}: {time.perf_counter() - t0:.1f} s")
    out.append(bn_remat_step(dev, batch=batch))
    return out


def bn_remat_step(dev, name="deit_small_distilled_patch16_224",
                  batch=BATCH):
    """A BatchNorm DeiT-S (fused fp32, dropout on: DROP) and the same with
    `remat=True`: one `make_train_step` step each from the same state,
    batch and CUDA generator seed.  Every parameter and every running
    statistic bit-equal between the two (the recompute leaves the
    statistics alone: they move once per step), and every statistic
    moved."""
    import torch
    from ofq_tpu_torch.models import create_model
    from ofq_tpu_torch.train import (TrainState, constant_lr, make_optimizer,
                                     make_train_step)
    t0 = time.perf_counter()
    over = dict(DROP, **BN)
    student, teacher, data = build_trained(dev, FUSED, name, batch,
                                           overrides=over)
    start = {k: v.clone() for k, v in student.state_dict().items()}
    remat = create_model(name, policy=student.policy, device=dev, **FUSED,
                         **over, remat=True)
    after = []
    for m in (student, remat):
        m.load_state_dict(start)
        opt = make_optimizer(constant_lr(1e-5), weight_decay=0.05)
        step = make_train_step(m, opt, teacher=teacher,
                               loss_kind="kd_soft_hard", device=dev)
        step(TrainState.create(m, opt), data,
             torch.Generator(device=dev).manual_seed(11))
        torch.cuda.synchronize()
        after.append({k: v.clone() for k, v in m.state_dict().items()})
    differ = [k for k, v in after[0].items()
              if not torch.equal(_bits(v), _bits(after[1][k]))]
    stats = list(bn_stats(student))
    still = [k for k in stats if torch.equal(after[1][k], start[k])]
    log(f"[remat] BatchNorm {name} {_describe(FUSED)}, dropout {DROP}: one "
        f"step with and without remat=True, {len(differ)} of "
        f"{len(after[0])} parameters and buffers differ {differ[:5]} "
        f"({len(stats)} running statistics, {len(still)} not moved) "
        f"({time.perf_counter() - t0:.1f} s)")
    del student, remat, teacher, data
    torch.cuda.empty_cache()
    if differ or still:
        raise GateTripped(f"[remat] BatchNorm: {differ[:5]} differ, "
                          f"{still[:5]} not moved")
    return dict(model=name, form="block, BatchNorm step", differing=differ,
                stats=len(stats))


# ------------------------------------------------- the LN->BN swap, acts
BN = dict(norm_layer="batchnorm")
# The fp32 steps of the LN->BN swap and of the prelu / rprelu MLPs are held
# to the whole-step rule with the order spread (bf16's form, against the
# composed fp64 model): their K1 is exact and K2 / K3 differ from the plain
# path only in fp32 summation order, which is what the spread measures.
# 2 x the plain path's distance alone refuses LSQ-scale gradients there
# that the plain path's own chunked orders move as far (BN DeiT-S: 5 of
# 419, blocks_5.attn.proj.input_quant.s 3.828 from the fp64 model, plain
# 0.073, its order spread 1.62; rprelu: 1 of 455), while every block's
# backward agrees to 1e-4 (PERF.md, section 6).


def phase_bn(dev, batch=BATCH):
    """The LN->BN swap (--replace-ln-by-bn): DeiT-S W2A2 QKR with
    `norm_layer="batchnorm"`, fused fp32: one train step (36 K1, 12 K2,
    12 K3, `per_layer_grad_norms` on: `check_layer_norms`) under
    phase_train's gates, the whole step and the running statistics'
    updates held to 2 x the order spread + the floor against the
    composed fp64 model's (`check_step_grads(order_spread=True)`),
    then the trained student served in eval mode through its running
    statistics (`phase_slice`: 36 K1, 12 K2 a forward, the block and
    top-1 gates); Swin-T W2A2 QKR with the swap, pallas bf16: one train
    step (39 K4) under SWIN_GATE, the statistics' updates against the
    rounded-once reference (2 x the order spread + the floor)."""
    import numpy as np
    from ofq_tpu_torch.quant import w2a2_qkr_policy
    deit = "deit_small_distilled_patch16_224"
    out = {}
    tr = out["train"] = phase_train(
        dev, FUSED, deit, batch, overrides=BN, timed=False, keep=True,
        step_options=dict(per_layer_grad_norms=True), order_spread=True)
    student = tr.pop("model")
    rng = np.random.default_rng(3)
    images = rng.normal(size=(batch, 224, 224, 3)).astype(np.float32)
    out["serve"] = phase_slice(dev, FUSED, deit, w2a2_qkr_policy(12), batch,
                               built=(student, images, rng), timed=False)
    del student
    out["swin_train"] = phase_train(
        dev, PALLAS, "swin_t", batch, gate=SWIN_GATE,
        overrides=dict(SWIN_BENCH, **BN), timed=False)
    return out


# the oscillation hook of the JAX package's tests (tests/test_oscillation.py)
# on the QKR selection; the step's constant learning rate, large enough to
# move bf16 masters (a bf16 ulp of a 2-bit DeiT-S kernel entry is ~2e-4)
OSC = dict(bits=2, momentum=0.5, freeze_threshold=0.4, qk_reparam=True)
OSC_LR = 5e-4
OSC_STEPS = 3


def seeded_tracking(params, generator):
    """The hook's state at `params` with half the entries already past a
    switch (up or down) at EMA 0.35, so that a switch back freezes them
    in the first steps (a fresh state needs two switches)."""
    import torch
    from ofq_tpu_torch.train.oscillation_hook import init_oscillation_states
    out = {}
    for n, st in init_oscillation_states(params, bits=OSC["bits"],
                                         qk_reparam=True).items():
        x = st.prev_x_int
        u = torch.rand((2,) + tuple(x.shape), generator=generator,
                       device=x.device)
        half = u[0] < 0.5
        direction = torch.where(u[1] < 0.5, -1.0, 1.0).to(x.dtype)
        zero = torch.zeros_like(x)
        out[n] = st._replace(
            prev_switch_dir=torch.where(half, direction, zero),
            ema_oscillation=torch.where(half, torch.full_like(x, 0.35),
                                        zero))
    return out


def hook_on_cpu(rec):
    """The hook's update of one step (the masters it read and the states
    it started from, recorded on the card) run again on the CPU: the new
    images, frozen masks and frozen integers equal the card's but where
    the pre-round image lies within MASK_EDGE_ULPS fp32 ulps of a rounding
    edge (the scale's mean summed in another order); `oscillation/
    ema_mean` within momentum / entries per such entry + 1e-6 of it.
    (differing, entries within the allowance)"""
    import numpy as np
    from ofq_tpu_torch.quant import statsq_b4_round
    from ofq_tpu_torch.train import oscillation_hook as osc
    params, states, (new, met) = rec
    cpu = {n: p.cpu() for n, p in params.items()}
    c_states = {n: type(st)(*[t.cpu() for t in st])
                for n, st in states.items()}
    c_new, c_met = osc.update_oscillation_states(
        cpu, c_states, **{k: v for k, v in OSC.items()})
    differ = near = count = 0
    for n, st in c_new.items():
        b4 = statsq_b4_round(cpu[n].float(), OSC["bits"])[0].numpy()
        frac = b4 - np.floor(b4)
        # (the clip's lower end sits on an edge whatever the scale)
        edge = (np.abs(frac - 0.5) <= MASK_EDGE_ULPS * np.spacing(np.abs(b4))
                ) & (b4 > -(2 ** (OSC["bits"] - 1)) - 0.5)
        d = np.zeros(b4.shape, bool)
        for f in ("prev_x_int", "frozen", "frozen_x_int"):
            d |= (getattr(st, f) != getattr(new[n], f).cpu()).numpy()
        if np.any(d & ~edge):
            raise GateTripped(f"oscillation: {n}: {int(np.sum(d & ~edge))} "
                              f"entries differ between the card and the "
                              f"CPU away from a rounding edge")
        differ += int(d.sum())
        near += int(edge.sum())
        count += d.size
    a, b = float(met["oscillation/ema_mean"]), float(
        c_met["oscillation/ema_mean"])
    if abs(a - b) > OSC["momentum"] * differ / count + 1e-6 * abs(b):
        raise GateTripped(f"oscillation/ema_mean: card {a}, CPU {b}")
    return differ, near


def phase_oscillation(dev, name="deit_small_distilled_patch16_224",
                      batch=BATCH):
    """The oscillation hook on the card: DeiT-S W2A2 QKR fused bf16 with
    bf16 masters and EMA 0.9999, constant lr OSC_LR, OSC (momentum 0.5,
    threshold 0.4) from `seeded_tracking`, `per_layer_grad_norms` on;
    OSC_STEPS steps, each with the plain step's launches (36 K1, 12 K2,
    12 K3), every frozen entry's StatsQ image its frozen integer, the
    hook's update against the same update on the CPU from the masters it
    read (`hook_on_cpu`), the working parameters the masters,
    `check_layer_norms` (bf16); entries frozen from the first step on;
    wall ms beside the step without the hook (plain, hook, hook,
    plain)."""
    import numpy as np
    import torch
    from ofq_tpu_torch import ops
    from ofq_tpu_torch.quant import statsq_b4_round
    from ofq_tpu_torch.train import (TrainState, constant_lr, make_optimizer,
                                     make_train_step)
    from ofq_tpu_torch.train import oscillation_hook as osc_lib
    t0 = time.perf_counter()
    student, teacher, data = build_trained(dev, FUSED_BF16, name, batch)
    cfg = student.cfg
    opt = make_optimizer(constant_lr(OSC_LR), weight_decay=0.05)
    state = TrainState.create(student, opt, ema=True,
                              master_dtype="bfloat16")
    state.extra = {"oscillation": seeded_tracking(
        state.params, torch.Generator(device=dev).manual_seed(3))}
    kw = dict(teacher=teacher, loss_kind="kd_soft_hard", device=dev,
              ema_decay=0.9999, master_dtype="bfloat16")
    step = make_train_step(student, opt, oscillation=OSC,
                           per_layer_grad_norms=True, **kw)
    plain = make_train_step(student, opt, **kw)
    tracked = sorted(state.extra["oscillation"])
    log(f"[oscillation] {name} W2A2 QKR, {_describe(FUSED_BF16)}, bf16 "
        f"masters, EMA, lr {OSC_LR}, {OSC}: {len(tracked)} kernels "
        f"tracked; built in {time.perf_counter() - t0:.1f} s")
    recs = []

    def record(real):
        def update(params, states, **k):
            got = real(params, states, **k)
            recs.append(({n: params[n].detach().clone() for n in states},
                         states, got))
            return got
        return update

    rows = []
    for i in range(OSC_STEPS):
        recs.clear()
        ops.reset_launch_counts()
        with injected(osc_lib, "update_oscillation_states", record):
            state, met = step(state, data)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        want = _expected(FUSED_BF16, cfg, train=True)
        if launches != want:
            raise AssertionError(f"[oscillation] expected launches per "
                                 f"step {want}, got {launches}")
        frozen = bad = 0
        for n, st in state.extra["oscillation"].items():
            img = torch.round(statsq_b4_round(state.params[n],
                                              OSC["bits"])[0])
            bad += int((img[st.frozen] != st.frozen_x_int[st.frozen]).sum())
            frozen += int(st.frozen.sum())
        if bad:
            raise GateTripped(f"oscillation: {bad} frozen entries' images "
                              f"are not their frozen integers")
        work = dict(student.named_parameters())
        if not all(torch.equal(work[n], p.float())
                   for n, p in state.params.items()):
            raise AssertionError("[oscillation] the working parameters are "
                                 "not the masters")
        differ, near = hook_on_cpu(recs[0])
        norms = check_layer_norms(met, True)
        rows.append(dict(launches=launches, frozen=frozen,
                         cpu_differing=differ, cpu_near_edge=near,
                         ema_mean=float(met["oscillation/ema_mean"]),
                         loss=float(met["loss"]), layer_norms=norms))
    if not 0 < rows[0]["frozen"] <= rows[-1]["frozen"]:
        raise GateTripped(f"oscillation: frozen entries per step "
                          f"{[r['frozen'] for r in rows]}")

    def ms(fn):
        nonlocal state
        for _ in range(TRAIN_STEPS_WARM):
            state, m = fn(state, data)
        float(m["loss"])
        t = time.perf_counter()
        for _ in range(TRAIN_STEPS_TIMED):
            state, m = fn(state, data)
        if not np.isfinite(float(m["loss"])):  # host fetch: the barrier
            raise AssertionError("non-finite loss")
        return (time.perf_counter() - t) * 1e3 / TRAIN_STEPS_TIMED

    times = [ms(f) for f in (plain, step, step, plain)]
    hook_ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
    log(f"[oscillation] {OSC_STEPS} steps: launches {rows[0]['launches']}; "
        f"frozen entries {[r['frozen'] for r in rows]}, each at its frozen "
        f"integer's level; oscillation/ema_mean "
        f"{[round(r['ema_mean'], 6) for r in rows]}; the hook on the CPU "
        f"from the same masters: {[r['cpu_differing'] for r in rows]} "
        f"entries differing, {[r['cpu_near_edge'] for r in rows]} within "
        f"{MASK_EDGE_ULPS} ulps of a rounding edge; wall ms per step "
        f"B={batch}: hook {hook_ms:.2f}, without {plain_ms:.2f} (plain, "
        f"hook, hook, plain: {', '.join(f'{t:.2f}' for t in times)})")
    prof = (phase_profile(lambda: float(step(state, data)[1]["loss"]),
                          "oscillation train step")
            if "--profile" in sys.argv else None)
    return dict(model=name, steps=rows, tracked=len(tracked),
                hook_ms=hook_ms, plain_ms=plain_ms, ms_in_turns=times,
                profile=prof)


# ------------------------------------------------------ gate self-check
@contextlib.contextmanager
def injected(module, name, fault):
    """`module.name` (a kernel wrapper as a module of the port calls it)
    replaced by `fault(real)` while active."""
    real = getattr(module, name)
    setattr(module, name, fault(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def k4_column_fault(real):
    """K4 with one output column moved by one weight level: weight (0, 0)
    one StatsQ level (s / n) up."""
    def k4(x2, w, s, n_levels):
        y = real(x2, w, s, n_levels)
        y[:, 0] = (y[:, 0].float() + x2[:, 0].float()
                   * float(s[0, 0] / n_levels)).to(y.dtype)
        return y
    return k4


# the one stage of K4's Swin-T fault: stage 2's fc1 (6 blocks)
SWIN_FAULT_SHAPE = (384, 1536)


def k4_stage_fault(real):
    """K4 with one output column moved by one weight level in one stage of
    Swin-T only: the products whose weight is SWIN_FAULT_SHAPE."""
    fault = k4_column_fault(real)

    def k4(x2, w, s, n_levels):
        if tuple(w.shape) == SWIN_FAULT_SHAPE:
            return fault(x2, w, s, n_levels)
        return real(x2, w, s, n_levels)
    return k4


def k2_scale_row_fault(real):
    """K2 reading the scale of the next query row, s[n + 1]."""
    def k2(lhs, rhs, v, s, *args):
        return real(lhs, rhs, v, s.roll(-1).contiguous(), *args)
    return k2


def k3_ds_fault(real):
    """K3 with ds doubled."""
    def k3(*args):
        dlhs, drhs, dv, ds = real(*args)
        return dlhs, drhs, dv, 2 * ds
    return k3


def k3_dlhs_fault(real):
    """K3 with dlhs doubled (what the rows of a block's dx see)."""
    def k3(*args):
        dlhs, drhs, dv, ds = real(*args)
        return 2 * dlhs, drhs, dv, ds
    return k3


# the slice the tiling faults hit: one 16-deep k16 step of a tensor-core
# product (K4's contraction; K3's keys of one head)
FAULT_K0, FAULT_HEAD = 16, 1


def k4_slice_fault(real):
    """K4 with one 16-deep slice of the contraction left out, the size of a
    tiling bug on the tensor cores: y - x[:, k0:k0+16] @ Q(W)[k0:k0+16],
    the slice from the plain version."""
    from ofq_tpu_torch.ops import pallas_statsq as ps

    def k4(x2, w, s, n_levels):
        y = real(x2, w, s, n_levels)
        sl = slice(FAULT_K0, FAULT_K0 + 16)
        part = ps.pallas_statsq_fwd_reference(
            x2[:, sl].contiguous(), w[sl].contiguous(), s, n_levels)
        return (y.float() - part.float()).to(y.dtype)
    return k4


def k2_slice_fault(real):
    """K2 with one 16-deep slice of the scores' contraction left out (lhs
    zero there), the size of a tiling bug on the tensor cores."""
    def k2(lhs, rhs, v, s, *args):
        lhs = lhs.clone()
        lhs[..., FAULT_K0:FAULT_K0 + 16] = 0
        return real(lhs, rhs, v, s, *args)
    return k2


def k2_head_fault(real):
    """K2 in its per-head form reading head h + 1's q (lhs rolled along the
    head axis)."""
    def k2(lhs, rhs, v, s, *args):
        if lhs.ndim == 4:
            lhs = lhs.roll(-1, dims=2).contiguous()
        return real(lhs, rhs, v, s, *args)
    return k2


def k3_dv_slice_fault(real):
    """K3 with dv zeroed over one 16-key slice of one head, the size of a
    tiling bug on the tensor cores."""
    def k3(*args):
        dlhs, drhs, dv, ds = real(*args)
        dv = dv.clone()
        dv[:, FAULT_K0:FAULT_K0 + 16, FAULT_HEAD] = 0
        return dlhs, drhs, dv, ds
    return k3


def _tripped(check, *args):
    """Whether the gate `check(*args)` trips, and its message."""
    try:
        check(*args)
    except GateTripped as e:
        return True, str(e).splitlines()[0][:300]
    return False, ""




def phase_gate_selfcheck(dev, name="deit_small_distilled_patch16_224",
                         batch=BATCH, swin_name="swin_t"):
    """The bf16 agreement gates shown to fail: deliberate faults injected
    into the kernel path (wrappers around the real kernels, patched where
    the port's modules look them up), each of which must trip its gates,
    then the unmodified kernels, which must pass every gate.  DeiT-S
    pallas serving (K4) for the K4 faults, Swin-T pallas serving
    (`swin_name`; None skips it) for K4's fault in one stage under
    SWIN_GATE; DeiT-S fused bf16 (K2 and K3) for the others.  Each fault
    has to trip the gates it is listed with; a gate listed as None is
    reported only."""
    import numpy as np
    import torch
    from ofq_tpu_torch.models.deit import VARIANTS
    from ofq_tpu_torch.nn import attention as nn_attention
    from ofq_tpu_torch.nn import linear as nn_linear
    from ofq_tpu_torch.quant import w2a2_qkr_policy
    from ofq_tpu_torch.serve import Predictor
    policy = w2a2_qkr_policy(VARIANTS[name].depth)
    results, failed = [], []

    def record(fault, gate, tripped, msg, must):
        """`must`: True, the gate has to trip; False, it has to pass;
        None, reported only."""
        ok = must is None or tripped == must
        results.append(dict(fault=fault, gate=gate, tripped=tripped,
                            required=must, ok=ok))
        need = {True: "trip", False: "pass", None: "reported only"}[must]
        log(f"[selfcheck] {fault}: {gate} "
            f"{'tripped' if tripped else 'passed'} (required: {need})"
            f"{' -- ' + msg if msg else ''}")
        if not ok:
            failed.append((fault, gate))

    def serving(conf, fault_site, faults, pol=policy, model_name=name,
                gate=None):
        """`faults`: (fault, label, gates) each, injected at `fault_site`
        of one model `model_name` of `conf` under `pol`; the gates each
        fault lists run (the block gate under `gate`)."""
        model, images, rng = build_served(dev, conf, model_name, pol, batch)
        pred = Predictor(model, batch_size=batch,
                         img_size=model.cfg.img_size, device=dev)
        batches = [images] + [rng.normal(size=images.shape).astype(
            np.float32) for _ in range(CMP_BATCHES - 1)]
        checks = {"block gate": (functools.partial(check_blocks, gate=gate),
                                 model, images, dev, conf),
                  "top-1 gate": (check_top1, pred, batches, conf)}
        used = [g for g in checks if any(g in f[2] for f in faults)]
        for fault, label, gates in faults:
            for gate in gates:
                with injected(*fault_site, fault):
                    record(label, gate, *_tripped(*checks[gate]),
                           must=gates[gate])
        for gate in used:
            record("unmodified kernels", f"{gate} ({_describe(conf)}, "
                   f"{_policy_label(pol)})", *_tripped(*checks[gate]),
                   must=False)

    serving(PALLAS, (nn_linear, "pallas_statsq_fwd"), [
        (k4_column_fault,
         "K4 with one output column moved by one weight level",
         {"block gate": True, "top-1 gate": True}),
        (k4_slice_fault,
         f"K4 with the contraction's slice {FAULT_K0}:{FAULT_K0 + 16} left "
         f"out", {"block gate": True, "top-1 gate": None})])
    serving(FUSED_BF16, (nn_attention, "qkr_attention_fwd"), [
        (k2_scale_row_fault, "K2 reading the scale of row n + 1",
         {"block gate": True, "top-1 gate": True}),
        (k2_slice_fault,
         f"K2 with the scores' contraction slice {FAULT_K0}:{FAULT_K0 + 16} "
         f"left out", {"block gate": True, "top-1 gate": None})])
    # the per-head form of the non-QKR student (fp32)
    serving(FUSED, (nn_attention, "qkr_attention_fwd"), [
        (k2_head_fault, "K2 (per-head lhs) reading head h + 1's q",
         {"block gate": True})],
        pol=_family(name, qk_reparam=False)[1])
    # a Swin-T path: pallas bf16 serving under SWIN_GATE
    if swin_name is not None:
        serving(PALLAS, (nn_linear, "pallas_statsq_fwd"), [
            (k4_stage_fault, f"Swin-T K4 with one output column moved by "
             f"one weight level in stage 2's fc1 {SWIN_FAULT_SHAPE}",
             {"block gate": True})],
            pol=_family(swin_name)[1], model_name=swin_name,
            gate=SWIN_GATE)
    # phase_k2's gate on its main-path case (bf16, shared lhs, LSQ on) at 4
    # batch rows, with the slice fault and unmodified
    from ofq_tpu_torch.ops import fused_attention as fa
    for dtype, shared, _, (lhs, rhs, v, s) in _attn_cases(
            dev, 2, 198, 4, False):
        if dtype != torch.bfloat16 or not shared:
            continue
        args = (lhs, rhs, v, s, 2, 64 ** -0.5, True)
        ref = fa.qkr_attention_fwd_reference(*args)
        for label, fwd, must in (
                (f"K2 with the scores' contraction slice {FAULT_K0}:"
                 f"{FAULT_K0 + 16} left out", k2_slice_fault(
                     fa.qkr_attention_fwd), True),
                ("unmodified kernels", fa.qkr_attention_fwd, False)):
            record(label, "K2 gate (phase_k2, bf16)", *_tripped(
                lambda: k2_gate("K2", fwd(*args), ref, s, v)), must=must)
    student, teacher, data = build_trained(dev, FUSED_BF16, name, batch)
    # the chunked plain paths' gradients, computed once for this student
    orders = {}
    checks = {"block backward gate": check_blocks_backward,
              "whole-step gradient gate": lambda *a: check_step_grads(
                  *a, orders=orders)}
    for fault, label, gates in (
            (k3_ds_fault, "K3 with ds doubled",
             {"block backward gate": True, "whole-step gradient gate": True}),
            (k3_dlhs_fault, "K3 with dlhs doubled",
             {"block backward gate": True,
              "whole-step gradient gate": None}),
            (k3_dv_slice_fault,
             f"K3 with dv zeroed over keys {FAULT_K0}:{FAULT_K0 + 16} of "
             f"head {FAULT_HEAD}",
             {"block backward gate": True,
              "whole-step gradient gate": None})):
        for gate, check in checks.items():
            with injected(nn_attention, "qkr_attention_bwd", fault):
                record(label, gate,
                       *_tripped(check, student, teacher, data, FUSED_BF16),
                       must=gates[gate])
    for gate, check in checks.items():
        record("unmodified kernels", f"{gate} ({_describe(FUSED_BF16)})",
               *_tripped(check, student, teacher, data, FUSED_BF16),
               must=False)
    if failed:
        raise AssertionError(f"gate self-check: {failed}")
    return results


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
# K6's ablation forms (the lab's units16_<form>, WB 16) and their switches
K6_FORMS = {"nodots": dict(do_scores=False, do_out=False),
            "nosm": dict(do_softmax=False),
            "scoresonly": dict(do_softmax=False, do_out=False)}


def _tail_gate(y, ref, q, k, v, softmax=True):
    """K6-K8 against their plain version: every element within one bf16
    ulp of itself, 2^-7 max(|y|, |ref|), plus 2^-8 sum_m |p_m| |v_m| (a
    probability that rounds to bf16 the other way moves its output row by
    up to 2^-8 |p_m v_m|), and at most TAIL_DIFFERING of the elements
    differing at all; `softmax=False` (K6's nosm form, whose p is s) takes
    the scores for p.  Returns (max |diff|, worst |diff| / limit, share
    differing)."""
    import torch
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * (
        q.shape[-1] ** -0.5)
    p = torch.softmax(s, dim=-1) if softmax else s.abs()
    pv = torch.einsum("bhnm,bmhd->bnhd", p, v.float().abs())
    del s, p
    y32, r32 = y.float(), ref.float()
    d = (y32 - r32).abs()
    lim = 2 ** -7 * torch.maximum(y32.abs(), r32.abs()) + 2 ** -8 * pv
    return (float(d.max()), float((d / lim.clamp_min(1e-30)).max()),
            float((d > 0).float().mean()))


def _scores_gate(y, ref, q, k):
    """K6's scoresonly form (out[b, i, h, j] = bf16(s[b, h, i, j]), j < 32)
    against its plain version: both round to bf16 an fp32 sum of the same
    32 exact products, taken in other orders, so every element within one
    bf16 ulp, 2^-7 max(|y|, |ref|), plus twice the fp32 summation bound
    32 * 2^-24 * d^-1/2 * sum_d |q_d k_d|, and at most TAIL_DIFFERING of
    the elements differing.  Returns (max |diff|, worst |diff| / limit,
    share differing)."""
    import torch
    dd = q.shape[-1]
    qk = torch.einsum("bnhd,bmhd->bnhm", q.float().abs(),
                      k.float().abs())[..., :dd]
    y32, r32 = y.float(), ref.float()
    d = (y32 - r32).abs()
    lim = (2 ** -7 * torch.maximum(y32.abs(), r32.abs())
           + 2 * dd * 2 ** -24 * dd ** -0.5 * qk)
    return (float(d.max()), float((d / lim.clamp_min(1e-30)).max()),
            float((d > 0).float().mean()))


def form_gate(form, y, ref, q, k, v):
    """The gate of K6's form `form` ("full" or one of K6_FORMS): the tail
    gate (nosm: with p := s), the scores gate (scoresonly), bit-exact
    (nodots: exp(0) = 1, a sum of 49 ones and 1/49 are exact in every
    order).  Returns (max |diff|, worst |diff| / limit, share differing)."""
    if form == "nodots":
        d = (y.float() - ref.float()).abs()
        err = float(d.max())
        return err, float("inf") if err > 0 else 0.0, float(
            (d > 0).float().mean())
    if form == "scoresonly":
        return _scores_gate(y, ref, q, k)
    return _tail_gate(y, ref, q, k, v, softmax=form != "nosm")


def _check_tail(what, y, ref, q, k, v, form="full"):
    import torch
    err, worst, share = form_gate(form, y, ref, q, k, v)
    if not (torch.isfinite(y.float()).all() and worst <= 1.0
            and share <= TAIL_DIFFERING):
        raise AssertionError(
            f"{what}: max|diff| {err}, worst |diff|/limit {worst:.3f}, "
            f"{share:.2e} of the elements differ (limit {TAIL_DIFFERING})")
    return err, worst, share


def mma_sum(a, b):
    """fp32 sums over the last axis of the exact products a * b (bf16
    operands, broadcast against each other) as the H100's `mma.sync`
    m16n8k16 forms them with fp32 accumulation, 16 products a step: the
    step's products and the running sum are aligned to the largest of their
    exponents, a product's taken unnormalized (floor log2 |a| + floor log2
    |b|, its significand in [1, 4)), each term cut toward zero below 2^(top
    - 25) (two bits below the fp32 significand), their exact sum cut to
    fp32 toward zero.  `phase_k6_emulated` holds it to the card's bits."""
    import torch

    def exponent(x):  # floor(log2 |x|); -300 for 0
        return torch.where(x == 0, -300, torch.frexp(x).exponent - 1)

    acc = None
    for k0 in range(0, a.shape[-1], 16):
        x, y = a[..., k0:k0 + 16].double(), b[..., k0:k0 + 16].double()
        terms = x * y
        e = torch.where(terms == 0, -300, exponent(x) + exponent(y))
        if acc is not None:
            terms = torch.cat([acc.double().unsqueeze(-1), terms], dim=-1)
            e = torch.cat([exponent(acc.double()).unsqueeze(-1), e], dim=-1)
        scale = torch.exp2((25 - e.amax(-1, keepdim=True)).double())
        total = (torch.trunc(terms * scale).sum(-1, keepdim=True)
                 / scale).squeeze(-1)
        acc = total.float()
        acc = torch.where(acc.double().abs() > total.abs(),
                          torch.nextafter(acc, torch.zeros_like(acc)), acc)
    return acc


def emulate_tc_tile(q, k, v, form="full"):
    """K6-K8's tile (`unit_tile`) in K6's form `form` (K7, K8: "full"), its
    sums by `mma_sum`: S in two k16 steps, s = acc * sm in
    fp32 (nodots: s = q[i, 0] for every key, no product); with the softmax
    (full, nodots) key columns >= 49 at -inf, exp, each row's sum over the
    16 values a lane holds (columns 8t + 2c + e, in order of t then e) and
    then across the quad ((l0 + l1) + (l2 + l3)), p = e / sum; without it
    (nosm, scoresonly) p = s, 0 on the padded key columns from K's zero
    rows; with p v (full, nosm) p rounded to bf16 and O = P V in four k16
    steps over 64 keys (49-63 zero), else out = p's first 32 columns;
    rounded to bf16.  exp is the device's own, so the full and nodots forms
    are the kernel's only up to expf's rounding."""
    import torch
    Bn, n, H, d = q.shape
    switches = K6_FORMS.get(form, {})
    pad = torch.zeros(Bn, 64 - n, H, d, dtype=q.dtype, device=q.device)
    qp, kp, vp = (torch.cat([t, pad], dim=1) for t in (q, k, v))
    qu, ku = (t.permute(0, 2, 1, 3) for t in (qp, kp))   # (B, H, 64, d)
    vu = vp.permute(0, 2, 3, 1)                          # (B, H, d, 64)
    if switches.get("do_scores", True):
        s = mma_sum(qu.unsqueeze(3), ku.unsqueeze(2)) * torch.tensor(
            d ** -0.5, dtype=torch.float32, device=q.device)
    else:
        s = qu[..., :1].float().expand(Bn, H, 64, 64).clone()
    if switches.get("do_softmax", True):
        s[..., n:] = -torch.inf
        e = torch.exp(s - s.amax(-1, keepdim=True))
        lanes = e.reshape(Bn, H, 64, 8, 4, 2).permute(
            0, 1, 2, 4, 3, 5).reshape(Bn, H, 64, 4, 16)
        part = torch.zeros(Bn, H, 64, 4, dtype=torch.float32,
                           device=q.device)
        for i in range(16):
            part = part + lanes[..., i]
        total = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
        p = e / total[..., None]
    else:
        p = s
    if switches.get("do_out", True):
        o = mma_sum(p.to(torch.bfloat16).unsqueeze(3), vu.unsqueeze(2))
    else:
        o = p[..., :d]
    return o[:, :, :n].permute(0, 2, 1, 3).to(torch.bfloat16)


# the seeds of the card tests' K6 data (tests/test_torch_port_cuda.py:
# `_tail_args`)
K6_SEEDS = (4, 5, 6, 7, 8)


def phase_k6_seeds(dev):
    """K6's nosm and scoresonly forms (WB 16) under their unchanged gates
    on data of the lab's shape drawn as the card tests draw theirs
    (torch.randn from each of K6_SEEDS, to bf16): the worst |diff| / limit
    and the share differing of each; a gate missed fails."""
    import torch
    from ofq_tpu_torch.ops import window_attention as wa
    rows = []
    for seed in K6_SEEDS:
        g = torch.Generator().manual_seed(seed)
        q, k, v = (torch.randn(LAB_BN, LAB_N, LAB_H, LAB_D, generator=g).to(
            dev, torch.bfloat16) for _ in range(3))
        for form in ("nosm", "scoresonly"):
            y = wa.window_attn_units(q, k, v, WB=16, **K6_FORMS[form])
            want = wa.window_attn_units_reference(q, k, v, **K6_FORMS[form])
            err, worst, share = _check_tail(f"K6 {form} seed {seed}", y,
                                            want, q, k, v, form=form)
            rows.append(dict(seed=seed, form=form, max_abs_err=err,
                             worst_ratio=worst, differing=share))
            log(f"[K6 seed {seed}] {form}: max|diff| {err:.3e}, worst "
                f"|diff|/limit {worst:.4f}, {share:.2e} of the elements "
                f"differ")
    return rows


def phase_k6_emulated(dev, chunk=512):
    """K6 in every form (WB 16) on the lab's data against `emulate_tc_tile`
    on the same device, in chunks of windows: the elements whose bits
    differ, which must be 0 in the forms without exp (nodots, nosm,
    scoresonly: the CPU tests' emulation is then the card's arithmetic;
    the full form's exp is torch's on the device, not required to be the
    kernel's expf), and the emulation's worst
    |diff| / limit under the form's gate against the plain version, beside
    the kernel's."""
    import torch
    from ofq_tpu_torch.benchmarks import window_attn_lab as lab
    from ofq_tpu_torch.ops import window_attention as wa
    q, k, v = lab._data(dev)
    rows = []
    for form in ("full", *K6_FORMS):
        switches = K6_FORMS.get(form, {})
        y = wa.window_attn_units(q, k, v, WB=16, **switches)
        differing, worst_e, worst_k = 0, 0.0, 0.0
        for b0 in range(0, LAB_BN, chunk):
            sl = slice(b0, b0 + chunk)
            qc, kc, vc = q[sl], k[sl], v[sl]
            emu = emulate_tc_tile(qc, kc, vc, form)
            want = wa.window_attn_units_reference(qc, kc, vc, **switches)
            differing += int((emu.view(torch.int16)
                              != y[sl].view(torch.int16)).sum())
            worst_e = max(worst_e, form_gate(form, emu, want, qc, kc, vc)[1])
            worst_k = max(worst_k, form_gate(form, y[sl], want, qc, kc,
                                             vc)[1])
        rows.append(dict(form=form, differing_from_kernel=differing,
                         emulated_worst=worst_e, kernel_worst=worst_k))
        log(f"[K6 emulated] {form}: the emulated tile (mma_sum) differs "
            f"from the kernel in {differing} of {y.numel()} elements; worst "
            f"|diff|/limit emulated {worst_e:.4f}, kernel {worst_k:.4f}")
        if differing and form != "full":
            raise AssertionError(
                f"K6 {form}: the emulated tile differs from the kernel in "
                f"{differing} elements: mma_sum is not the card's "
                f"accumulator")
    return rows


def form_work(do_scores=True, do_softmax=True, do_out=True):
    """The bytes and operations of the tail in K6's form with these
    switches (all on: the tail of K6-K8) at the lab's shapes, counted from
    what its function needs: q whole for q k^T, else only its column 0
    (nodots' scores); k's first 32 keys when only those score columns
    reach the output (do_out off), else all 49; v for p v only; the output
    always.  Operations: q k^T over the key columns kept, and p v."""
    unit = LAB_BN * LAB_H * LAB_N * LAB_D  # elements of q, k, v or out
    keys = LAB_N if do_out else LAB_D
    elems = unit + (unit if do_scores else unit // LAB_D)
    elems += unit * keys // LAB_N if do_scores else 0
    elems += unit if do_out else 0
    flops = (2 * LAB_BN * LAB_H * LAB_N * keys * LAB_D * do_scores
             + 2 * LAB_BN * LAB_H * LAB_N * LAB_N * LAB_D * do_out)
    return 2 * elems, flops


def raw_k78(lib, fn_name, q, k, v, WB, P):
    """K7's or K8's C launcher in `lib` (the current tree's or an earlier
    one's: the same C signature) called straight on q, k, v into an output
    allocated once (--baseline)."""
    import ctypes
    import torch
    out = torch.empty_like(q)
    fn = getattr(lib, f"ofq_{fn_name}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    Bn, _, H, d = q.shape
    call = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), Bn, H,
            WB, P, d ** -0.5, torch.cuda.current_stream().cuda_stream]

    def run():
        err = fn(*call)
        if err:
            raise RuntimeError(f"{fn_name} launcher: CUDA error {err}")
        return out
    return run


def raw_k6(lib, q, k, v, WB, flags):
    """K6's C launcher in `lib` (the current tree's or an earlier one's: the
    same C signature) in form `flags` (do_scores | do_softmax << 1 | do_out
    << 2) called straight on q, k, v into an output allocated once."""
    import ctypes
    import torch
    out = torch.empty_like(q)
    fn = lib.ofq_window_attn_units
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    Bn, _, H, d = q.shape
    call = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), Bn, H,
            WB, d ** -0.5, flags, torch.cuda.current_stream().cuda_stream]

    def run():
        err = fn(*call)
        if err:
            raise RuntimeError(f"K6 launcher: CUDA error {err}")
        return out
    return run


def _k678_design(fn_name, H, P, flags=7):
    from ofq_tpu_torch.ops import window_attention as wa
    smem, stages, warps, blocks = wa.launch_config(fn_name, H, P, flags)
    shape = (f"{smem} B shared, {warps} warps, {blocks} blocks per SM (the "
             f"CUDA runtime's occupancy)")
    if fn_name == "window_attn_units":
        return (f"tensor cores (mma.sync m16n8k16), TMA loads of one unit "
                f"a box (64-byte swizzle) on {stages} mbarrier stages, TMA "
                f"stores, {shape}")
    layout = ("64-byte rows, swizzled chunks" if fn_name ==
              "window_attn_packed" else "80-byte row slots")
    return (f"tensor cores (mma.sync m16n8k16), {layout}, "
            f"{stages}-stage cp.async ring, {shape}")


def phase_k678(dev, base=None):
    """K6-K8 against their plain version at the lab's shapes, on the lab's
    seeded data (`window_attn_lab._data`), each at each lab parameter set,
    and K6's three ablation forms against theirs, with times, the plain
    version's, SDPA's on the same q, k, v (the tail's function) and the
    bound; with `base` (--baseline), every K6 form's, K7's and K8's launchers
    beside the earlier tree's on the same inputs."""
    import torch
    import torch.nn.functional as F
    from ofq_tpu_torch.benchmarks import window_attn_lab as lab
    from ofq_tpu_torch.ops import _build
    from ofq_tpu_torch.ops import window_attention as wa

    def versus_earlier(fn_name, kw, flags=None):
        """(--baseline) the launcher alone now and in the earlier tree."""
        if base is None:
            return {}
        lib = _build.load("window_attention")
        if flags is None:
            cur, old = (raw_k78(lb, fn_name, q, k, v, kw["WB"], kw["P"])
                        for lb in (lib, base["window_attention"]))
        else:
            cur, old = (raw_k6(lb, q, k, v, kw["WB"], flags)
                        for lb in (lib, base["window_attention"]))
        raw_ms, base_ms, differing = against_earlier(cur, old)
        return dict(raw_ms=raw_ms, baseline_raw_ms=base_ms,
                    baseline_differing=differing)

    q, k, v = lab._data(dev)
    ref = wa.window_attn_tail_reference(q, k, v)
    plain_ms = median_ms(lambda: wa.window_attn_tail_reference(q, k, v),
                         reps=10)
    qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    sdpa_ms = median_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    del qh, kh, vh
    nbytes, flops = form_work()
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    results = []
    for key, fn_name, kw in K678_CASES:
        fn = getattr(wa, fn_name)
        y = fn(q, k, v, **kw)
        torch.cuda.synchronize()
        err, worst, share = _check_tail(f"{key} {kw}", y, ref, q, k, v)
        ms = median_ms(lambda: fn(q, k, v, **kw))
        design = _k678_design(fn_name, LAB_H, kw.get("P", LAB_H))
        versus = versus_earlier(fn_name, kw,
                                wa.form_flags() if key == "K6" else None)
        log(f"[{key}] {fn_name} {kw} (Bn={LAB_BN}, n={LAB_N}, H={LAB_H}, "
            f"d={LAB_D}; {design}): max|diff| {err:.3e}, worst |diff|/limit "
            f"{worst:.3f}, {share:.2e} of the elements differ; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {sdpa_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)"
            + _versus(versus.get("raw_ms"), versus.get("baseline_raw_ms"),
                      versus.get("baseline_differing")))
        results.append(dict(kernel=key, name=fn_name, form="full",
                            params=kw, default=kw == K678_DEFAULT[key],
                            design=design, max_abs_err=err,
                            worst_ratio=worst, differing=share, ms=ms,
                            plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                            flops=flops, **versus))
        del y
    for form, switches in K6_FORMS.items():
        versus = versus_earlier("window_attn_units", dict(WB=16),
                                wa.form_flags(**switches))
        y = wa.window_attn_units(q, k, v, WB=16, **switches)
        want = wa.window_attn_units_reference(q, k, v, **switches)
        torch.cuda.synchronize()
        err, worst, share = _check_tail(f"K6 {form}", y, want, q, k, v,
                                        form=form)
        ms = median_ms(lambda: wa.window_attn_units(q, k, v, WB=16,
                                                    **switches))
        form_plain_ms = median_ms(lambda: wa.window_attn_units_reference(
            q, k, v, **switches), reps=10)
        f_bytes, f_flops = form_work(**switches)
        f_ms, f_by = bound(f_bytes, f_flops, PEAK_BF16_FLOPS)
        log(f"[K6 {form}] window_attn_units(WB=16, {switches}): max|diff| "
            f"{err:.3e}, worst |diff|/limit {worst:.3f}, {share:.2e} of the "
            f"elements differ; kernel {ms:.4f} ms, plain {form_plain_ms:.4f}"
            f" ms, bound {f_ms:.4f} ms ({f_by}; {f_flops / 1e9:.2f} GFLOP, "
            f"{f_bytes / 1e6:.1f} MB)"
            + _versus(versus.get("raw_ms"), versus.get("baseline_raw_ms"),
                      versus.get("baseline_differing")))
        results.append(dict(kernel="K6", name="window_attn_units", form=form,
                            params=dict(WB=16, **switches), default=False,
                            design=_k678_design(
                                "window_attn_units", LAB_H, LAB_H,
                                wa.form_flags(**switches)),
                            max_abs_err=err, worst_ratio=worst,
                            differing=share, ms=ms, plain_ms=form_plain_ms,
                            sdpa_ms=None, bound_ms=f_ms, bound_by=f_by,
                            bytes=f_bytes, flops=f_flops, **versus))
        del y, want
    return results


def phase_lab(dev):
    """The port's lab entry point (`ofq_tpu_torch.benchmarks.
    window_attn_lab`), all 17 of the lab's variants once at the lab's
    shapes with its check: no variant may raise or miss the check, and
    every K6-K8 kernel and K6 form must launch (counts set to 0 just
    before, read just after)."""
    from ofq_tpu_torch import ops
    from ofq_tpu_torch.benchmarks import window_attn_lab as lab
    q, k, v = lab._data(dev)
    ops.reset_launch_counts()
    out, raised, bad = lab.run(q, k, v, list(lab.VARIANTS), check=True,
                               emit=lambda obj: log(f"[lab] "
                                                    f"{json.dumps(obj)}"))
    launches = {name: n for name, n in ops.launch_counts().items()
                if name.startswith("window_attn")}
    if raised or bad:
        raise AssertionError(f"the lab's entry point: variants raised "
                             f"{raised}, checks failed {bad}")
    if not all(launches.values()):
        raise AssertionError(f"the lab's run left a kernel unlaunched: "
                             f"{launches}")
    log(f"[lab] launches {launches}")
    return dict(results=out, launches=launches)


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
    counts = ops.launch_counts()
    k678_launches = {fn.__name__: counts[fn.__name__]
                     for fn in (wa.window_attn_units, wa.window_attn_packed,
                                wa.window_attn_packed_aligned)}
    forms = {k: v for k, v in counts.items()
             if k.startswith("window_attn") and k not in k678_launches}
    if set(k678_launches.values()) != {2} or any(forms.values()):
        raise AssertionError(f"K6-K8 launches {k678_launches}, want 2 each "
                             f"(and no ablation form: {forms})")
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
# ------------------------------------------------------------ the int8 path
# bench.py's int8 configuration (bench.py:256-260): every quantized product
# on the integer codes (`int8_mm`: torch._int_mm, a library call; the JAX
# package hands it to XLA, no Pallas kernel), the composed attention tail,
# the bf16 stream
INT8 = dict(matmul_impl="int8", attn_impl=None, compute_dtype="bfloat16")
# a frozen packed artifact (bench.py's serving_rate, :166-204: export_packed,
# restore_packed(int_core=True), weight_frozen=True, frozen_int_bits=2)
# served through the integer core, and once through its fp products
FROZEN_INT = dict(matmul_impl=None, attn_impl=None,
                  compute_dtype="bfloat16", frozen_int_bits=2)
# bench.py's serving_rate batch
FROZEN_BATCH = 256
# bench.py's Swin-T family row: the int8 step at B = 48 (bench.py:303)
SWIN_INT8_TRAIN_BATCH = 48
# H100 SXM data sheet (dense): int8 tensor-core operations per second
PEAK_INT8_OPS = 1979e12
# the int products of the DeiT-S student without QKR at B = 64
NONQKR_INT8_ROWS = "DeiT-S without QKR B=64"


def _int8_cases():
    """(path, name, M, K, N, launches per forward) of every int product of
    the int8 paths: DeiT-S at B = 64 and, frozen, at bench.py's B = 256
    (QKR's v and qkx, proj, fc1, fc2 of each block); Swin-T at B = 64 and
    at bench.py's int8 train batch, 48 (the same five per block on the
    window tokens, and each patch merging's reduction)."""
    from ofq_tpu_torch.models.deit import DEIT_SMALL as d
    from ofq_tpu_torch.models.swin import SWIN_TINY as sw
    cases = []

    def block(path, prefix, M, C, H, hid, per):
        for name, K, N in (("v", C, C), ("qkx", C, H * C), ("proj", C, C),
                           ("fc1", C, hid), ("fc2", hid, C)):
            cases.append((path, prefix + name, M, K, N, per))

    for path, B in (("DeiT-S B=64", BATCH),
                    (f"DeiT-S B={FROZEN_BATCH}", FROZEN_BATCH)):
        block(path, "", B * d.n_tokens, d.embed_dim, d.num_heads,
              int(d.embed_dim * d.mlp_ratio), d.depth)
    # without QKR (and full-LSQ's frozen integer core): qkv, proj, fc1, fc2
    M, C = BATCH * d.n_tokens, d.embed_dim
    for name, K, N in (("qkv", C, 3 * C), ("proj", C, C),
                       ("fc1", C, 4 * C), ("fc2", 4 * C, C)):
        cases.append((NONQKR_INT8_ROWS, name, M, K, N, d.depth))
    for B in (BATCH, SWIN_INT8_TRAIN_BATCH):
        path = f"Swin-T B={B}"
        side, C = sw.img_size // sw.patch_size, sw.embed_dim
        for stage, depth in enumerate(sw.depths):
            # 56, 28, 14, 7: whole windows of 7 x 7, so the window tokens
            # are the map's
            block(path, f"s{stage} ", B * side * side, C,
                  sw.num_heads[stage], int(C * sw.mlp_ratio), depth)
            if stage < len(sw.depths) - 1:
                side = (side + 1) // 2
                cases.append((path, f"s{stage} reduction",
                              B * side * side, 4 * C, 2 * C, 1))
                C *= 2
    return cases


def phase_int8_mm(dev):
    """`int8_mm` (torch._int_mm) against its plain version at every shape
    of the int8 paths, with codes at the ends of the W2A2 and W4A8 ranges
    (0 elements may differ), and, on the W2A2 codes, the median of 20
    calls of each, of torch._int_mm alone with B row-major (the layout the
    wrapper does not use), of the bf16 torch.matmul of the dequantized
    operands, and the bound (int32 out: bytes)."""
    import torch
    from ofq_tpu_torch.ops import int8_qlinear as iq
    g = torch.Generator(device=dev).manual_seed(12)
    ranges = (("W2A2", (-2, 1), 3), ("W4A8", (-128, 127), 15))
    rows = []
    for path, name, M, K, N, per in _int8_cases():
        differing = {}
        for label, (lo, hi), wmax in ranges:
            a = torch.where(torch.rand(M, K, generator=g, device=dev) < 0.5,
                            lo, hi).to(torch.int8)
            # the weight codes column-major, as the int8 path hands them
            b = torch.where(torch.rand(N, K, generator=g, device=dev) < 0.5,
                            -wmax, wmax).to(torch.int8).t()
            y = iq.int8_mm(a, b)
            differing[label] = int((y != iq.int8_mm_reference(a, b)).sum())
            if label == "W2A2":
                ms = median_ms(lambda: iq.int8_mm(a, b))
                b_rows = b.contiguous()
                row_ms = median_ms(lambda: torch._int_mm(a, b_rows))
                del b_rows
                plain_ms = median_ms(lambda: iq.int8_mm_reference(a, b),
                                     reps=10)
                af = (a.float() * 0.25).bfloat16()
                bf = (b.float() * 0.125).bfloat16().contiguous()
                mm_ms = median_ms(lambda: torch.matmul(af, bf))
                del af, bf
            del y
        if any(differing.values()):
            raise AssertionError(f"int8_mm {path} {name} ({M}x{K}x{N}): "
                                 f"elements differing from the plain "
                                 f"version {differing}")
        nbytes = M * K + K * N + 4 * M * N
        ops = 2 * M * K * N
        b_ms, b_by = bound(nbytes, ops, PEAK_INT8_OPS)
        log(f"[int8_mm] {path} {name} M={M} K={K} N={N}: 0 elements "
            f"differing ({', '.join(differing)} codes); torch._int_mm "
            f"{ms:.4f} ms (B row-major, torch._int_mm alone: {row_ms:.4f} "
            f"ms), plain (fp64 product) {plain_ms:.4f} ms, bf16 "
            f"torch.matmul of the dequantized operands {mm_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.2f} GOP); {per} a forward")
        rows.append(dict(path=path, name=name, M=M, K=K, N=N,
                         per_forward=per, differing=differing,
                         max_abs_err=0.0, ms=ms, row_major_b_ms=row_ms,
                         plain_ms=plain_ms,
                         bf16_matmul_ms=mm_ms, bound_ms=b_ms, bound_by=b_by,
                         bytes=nbytes, ops=ops))
        del a, b
    torch.cuda.empty_cache()
    return rows


def check_int8_shapes(rows, path, shapes):
    """The int products a path launched, by (M, K, N), against
    `_int8_cases`' count for it (the counts read from the code)."""
    want = {}
    for r in rows:
        if r["path"] == path:
            key = str((r["M"], r["K"], r["N"]))
            want[key] = want.get(key, 0) + r["per_forward"]
    if shapes != want:
        raise AssertionError(f"{path}: int8_mm launches by (M,K,N) {shapes}"
                             f", expected {want}")


def check_same_bits(model, images, dev):
    """The int path through `int8_mm` and through its plain version: the
    same bits in every block's output (on the plain path's input to it)
    and in the logits."""
    import torch
    differing = []
    with torch.inference_mode():
        for name, (x, ref) in zip(model.block_names,
                                  _capture_blocks(model, images, dev)):
            differing.append(int((getattr(model, name)(x) != ref).sum()))
        xt = torch.from_numpy(images).to(dev)
        logits = model(xt)
        with plain_path(model):
            logits_plain = model(xt)
    n_logits = int((logits != logits_plain).sum())
    log(f"[slice] int8_mm against its plain version: elements differing in "
        f"each block's output {differing}, in the logits {n_logits}")
    if any(differing) or n_logits:
        raise GateTripped(f"int8_mm and its plain version give other bits: "
                          f"blocks {differing}, logits {n_logits}")
    return dict(blocks=differing, logits=n_logits)


def composed_top1(pred, batches):
    """Top-1 agreement of the int8 path with the same model on the
    composed products in the same stream (matmul_impl=None), printed."""
    import copy
    import numpy as np
    from ofq_tpu_torch.serve import Predictor
    ref = copy.deepcopy(pred.model)
    for m in ref.modules():
        if hasattr(m, "matmul_impl"):
            m.matmul_impl = None
    other = Predictor(ref, batch_size=pred.batch_size,
                      img_size=pred.img_size, device=pred.device)
    a = np.concatenate([pred.predict(b) for b in batches]).argmax(-1)
    c = np.concatenate([other.predict(b) for b in batches]).argmax(-1)
    del ref, other
    agree = float((a == c).mean())
    log(f"[slice] top-1 agreement of the int8 path with the composed "
        f"products in the same stream (matmul_impl=None): "
        f"{agree * 100:.2f} % of {len(a)} images")
    return agree


def frozen_codes(model, exported, live):
    """Per StatsQ entry of the artifact, its codes against those that
    `frozen_weight_int` rebuilds from the frozen model's dequantized
    weights and stored scales (the integer core's), and against the live
    student's own int8-path codes (`_weight_int` on its kernels; W_qk
    formed by `nn/attention.py`): the elements differing."""
    import math
    import torch
    from ofq_tpu_torch.deploy import artifact_meta, unpack_codes
    from ofq_tpu_torch.nn.attention import _w_qk
    from ofq_tpu_torch.ops.int8_qlinear import (_weight_int,
                                                frozen_weight_int)
    params = dict(model.named_parameters())
    dev = next(model.parameters()).device
    out = {}
    for key, info in artifact_meta(exported)["entries"].items():
        if info["kind"] != "statsq":
            continue
        bits, shape = info["bits"], info["enc_shape"]
        n = 2 ** (bits - 1)
        codes = torch.from_numpy(unpack_codes(
            exported[key + ".codes"], bits, math.prod(shape)).reshape(
                shape)).to(dev, torch.float32)
        name = key.replace("/", ".")
        if name.endswith("w_qk_frozen"):
            owner = name[:-len(".w_qk_frozen")]
            scale = params[owner + ".w_qk_scale"]
            attn = live.get_submodule(owner)
            H, C = attn.num_heads, shape[1]
            live_w = _w_qk(attn, H, C, C // H, True).reshape(H * C, C)
            live_int, _ = _weight_int(live_w.float(), bits, reduce_axis=-1)
        else:
            scale = params[name + "_scale"]
            live_int, _ = _weight_int(
                live.get_parameter(name).float(), bits)
        w_int, _ = frozen_weight_int(params[name].reshape(shape), scale,
                                     bits)
        out[key] = (int(((w_int - 1) / 2 + n != codes).sum()),
                    int(((live_int - 1) / 2 + n != codes).sum()))
    return out


def phase_frozen(dev, name, policy, built, export_kw, gate=None,
                 rate_batch=None):
    """A frozen packed artifact of the calibrated student `built` (its
    model, images, rng): exported on the card (`deploy.export_packed` of
    `model_tree`), its codes against the integer core's and the live
    student's, served through `Predictor.from_packed(int_core=True)` under
    phase_slice's gates against this path's own plain version (and at
    `rate_batch`, img/s), then once through its fp products."""
    import numpy as np
    import torch
    from ofq_tpu_torch import ops
    from ofq_tpu_torch.deploy import (artifact_nbytes, export_packed,
                                      model_tree)
    from ofq_tpu_torch.serve import Predictor
    student, images, rng = built
    t0 = time.perf_counter()
    exported = export_packed(model_tree(student), weight_bits=2,
                             qk_reparam=True, **export_kw)
    nbytes = artifact_nbytes(exported)
    fp32 = sum(p.numel() * 4 for p in student.parameters())
    kw = dict(model_name=name, policy=policy, compute_dtype="bfloat16",
              batch_size=len(images), device=dev)
    pred = Predictor.from_packed(exported, int_core=True, **kw)
    codes = frozen_codes(pred.model, exported, student)
    n_int = sum(a for a, _ in codes.values())
    n_live = sum(b for _, b in codes.values())
    log(f"[frozen] {name}: artifact {nbytes / 1e6:.2f} MB against "
        f"{fp32 / 1e6:.2f} MB of fp32 parameters ({fp32 / nbytes:.2f}x), "
        f"exported and restored in {time.perf_counter() - t0:.1f} s; "
        f"{len(codes)} StatsQ entries, codes differing from the integer "
        f"core's {n_int}, from the live student's int8 codes {n_live}")
    if n_int or n_live:
        raise AssertionError(f"[frozen] codes differing: {codes}")
    res = phase_slice(dev, FROZEN_INT, name, policy, batch=len(images),
                      gate=gate, built=(pred.model, images, rng))
    res.update(artifact_bytes=nbytes, fp32_bytes=fp32,
               codes_differing=dict(integer_core=n_int, live=n_live))
    if rate_batch:
        big = Predictor(pred.model, batch_size=rate_batch,
                        img_size=pred.img_size, device=dev)
        x = rng.normal(size=(rate_batch,) + images.shape[1:]).astype(
            np.float32)
        ops.reset_launch_counts()
        big.predict(x)
        res["rate_batch_shapes"] = _shapes(ops.int8_mm)
        for _ in range(2):
            big.predict(x)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            big.predict(x)
        torch.cuda.synchronize()
        res["img_per_s_rate_batch"] = rate_batch * 5 / (
            time.perf_counter() - t)
        log(f"[frozen] {name} integer core, B={rate_batch} (bench.py's "
            f"serving_rate batch): {res['img_per_s_rate_batch']:.1f} img/s "
            f"(5 calls after 2 warm-ups)")
        del big, x
    del pred
    torch.cuda.empty_cache()
    fp = Predictor.from_packed(exported, int_core=False, **kw)
    ops.reset_launch_counts()
    p_fp = fp.predict(images)
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    int_model = Predictor.from_packed(exported, int_core=True, **kw)
    p_int = int_model.predict(images)
    agree = float((p_fp.argmax(-1) == p_int.argmax(-1)).mean())
    log(f"[frozen] {name} fp products (int_core=False), B={len(images)}: kernel "
        f"launches {launches or 'none'}, finite "
        f"{bool(np.isfinite(p_fp).all())}, top-1 agreement with the "
        f"integer core {agree * 100:.2f} %")
    if launches or not np.isfinite(p_fp).all():
        raise AssertionError(f"[frozen] the fp path launched {launches} or "
                             f"gave non-finite probabilities")
    res["fp_path"] = dict(top1_vs_int_core=agree)
    del fp, int_model
    torch.cuda.empty_cache()
    return res


def phase_frozen_lsq(dev, name, policy, batch=BATCH):
    """A frozen packed artifact of the calibrated full-LSQ student
    (`--wq-mode lsq`, no QKR): exported on the card (`export_packed(...,
    wq_mode="lsq")`), every block kernel's codes against those the integer
    core rebuilds from the restored `weight_quant.s`
    (`frozen_lsq_weight_int`) and against the live student's LSQ codes
    (round(clip(w / max(s, 1e-5), -2, 1))), then served through
    `Predictor.from_packed(int_core=True)` under phase_slice's gates."""
    import math
    import torch
    from ofq_tpu_torch.deploy import (artifact_meta, export_packed,
                                      model_tree, unpack_codes)
    from ofq_tpu_torch.ops.int8_qlinear import frozen_lsq_weight_int
    from ofq_tpu_torch.serve import Predictor
    t0 = time.perf_counter()
    student, images, rng = build_served(dev, FUSED, name, policy, batch)
    exported = export_packed(model_tree(student), weight_bits=2,
                             qk_reparam=False, wq_mode="lsq")
    pred = Predictor.from_packed(exported, model_name=name, policy=policy,
                                 int_core=True, compute_dtype="bfloat16",
                                 batch_size=batch, device=dev)
    params = dict(pred.model.named_parameters())
    codes = {}
    for key, info in artifact_meta(exported)["entries"].items():
        if info["kind"] != "lsq" or info["bits"] != 2:
            continue  # the W8 heads and patch embedding
        shape = info["enc_shape"]
        got = torch.from_numpy(unpack_codes(
            exported[key + ".codes"], 2, math.prod(shape)).reshape(
                shape)).to(dev, torch.float32) - 2
        name_ = key.replace("/", ".")
        owner = name_[:-len(".kernel")]
        core, _ = frozen_lsq_weight_int(params[name_],
                                        params[owner + ".weight_quant.s"])
        s = torch.clamp_min(student.get_parameter(
            owner + ".weight_quant.s").float(), 1e-5)
        live = torch.round(torch.clamp(
            student.get_parameter(name_).float() / s, -2, 1))
        codes[key] = (int((core != got).sum()), int((live != got).sum()))
    n_core = sum(a for a, _ in codes.values())
    n_live = sum(b for _, b in codes.values())
    log(f"[frozen] {name} full-LSQ: {len(codes)} W2 LSQ entries exported "
        f"and restored in {time.perf_counter() - t0:.1f} s; codes differing "
        f"from the integer core's {n_core}, from the live student's "
        f"{n_live}")
    if n_core or n_live or len(codes) != 4 * student.cfg.depth:
        raise AssertionError(f"[frozen] full-LSQ codes: {codes}")
    res = phase_slice(dev, FROZEN_INT, name, policy, batch=batch,
                      built=(pred.model, images, rng))
    res.update(codes_differing=dict(integer_core=n_core, live=n_live))
    del pred, student
    torch.cuda.empty_cache()
    return res


def int8_column_fault(real):
    """int8_mm with one output column's sum moved by one code step: weight
    code (0, 0) one level (2) up."""
    def mm(a8, b8):
        y = real(a8, b8)
        y[:, 0] += 2 * a8[:, 0].to(y.dtype)
        return y
    return mm


def phase_int8_selfcheck(dev, built):
    """The int8 gates shown to fail: `int8_column_fault` around the real
    `int8_mm` must trip the 0-differing gate (at DeiT-S's fc1 shape) and the
    block gate of the int8 DeiT-S serving path; the unmodified product must
    pass both."""
    import torch
    from ofq_tpu_torch.nn import linear as nn_linear
    from ofq_tpu_torch.ops import int8_qlinear as iq
    model, images, _ = built
    g = torch.Generator(device=dev).manual_seed(13)
    M = BATCH * model.cfg.n_tokens
    a = torch.randint(-2, 2, (M, 384), generator=g, device=dev,
                      dtype=torch.int8)
    b = (torch.randint(-2, 2, (1536, 384), generator=g, device=dev) * 2
         + 1).to(torch.int8).t()
    ref = iq.int8_mm_reference(a, b)

    def zero_gate():
        d = int((nn_linear.int8_mm(a, b) != ref).sum())
        if d:
            raise GateTripped(f"int8_mm: {d} elements differing")

    checks = {"0-differing gate": (zero_gate,),
              "block gate": (check_blocks, model, images, dev, INT8)}
    results, failed = [], []
    for label, fault, must in (
            ("int8_mm with one output column moved by one code step",
             int8_column_fault, True),
            ("unmodified int8_mm", None, False)):
        for gate, args in checks.items():
            ctx = (injected(nn_linear, "int8_mm", fault) if fault
                   else contextlib.nullcontext())
            with ctx:
                tripped, msg = _tripped(*args)
            ok = tripped == must
            results.append(dict(fault=label, gate=gate, tripped=tripped,
                                required=must, ok=ok))
            log(f"[selfcheck] {label}: {gate} "
                f"{'tripped' if tripped else 'passed'} (required: "
                f"{'trip' if must else 'pass'}){' -- ' + msg if msg else ''}")
            if not ok:
                failed.append((label, gate))
    if failed:
        raise AssertionError(f"int8 gate self-check: {failed}")
    return results


def int8_rows(rows, launches):
    """The int product's entries of the result (a library call, not one of
    the port's kernels): its launches on each path beside its times."""
    out = []
    for r in rows:
        key = str((r["M"], r["K"], r["N"]))
        out.append(dict(
            name=f"int8_mm {r['path']} {r['name']} ({r['M']}x{r['K']}x"
                 f"{r['N']})", route="library (torch._int_mm)",
            source="ofq_tpu_torch/ops/int8_qlinear.py",
            replaces="ofq_tpu/ops/int8_qlinear.py:77 (XLA's int8 "
                     "dot_general; no pallas_call)",
            launches={p: s[key] for p, s in launches.items()
                      if s.get(key)},
            max_abs_err=0.0, ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, row_major_b_ms=r["row_major_b_ms"],
            yardstick_bf16_matmul_ms=r["bf16_matmul_ms"]))
    return out


# ---------------------------------------------------------------- the CLI
DEIT_RECIPE = "train_scripts/deit_s/w2a2_deit_s.sh"
SWIN_RECIPE = "train_scripts/swin_t/w2a2_swin_t.sh"
# the recipe's warm-start flags (dropped for the Swin-T run, which trains
# from the seeded initialisation with a seeded teacher)
WARM_START = ("--pretrained_initialized", "--initial-checkpoint",
              "--teacher_pretrained", "--teacher_checkpoint")


def recipe_argvs(script, data_dir, fp_ckpt):
    """The argv of each `python3 -m ofq_tpu.cli.*` command of a recipe in
    train_scripts/, with its data directory and float checkpoint given and
    its config path made absolute."""
    import re
    import shlex
    with open(os.path.join(HERE, script)) as f:
        text = f.read().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        m = re.match(r"\s*python3 -m ofq_tpu\.cli\.\w+ (.*)", line)
        if m:
            argv = m.group(1).replace('"$DATA_DIR"', data_dir).replace(
                '"$FP_CKPT"', fp_ckpt)
            out.append([os.path.join(HERE, a) if a.startswith("configs/")
                        else a for a in shlex.split(argv)])
    return out


def _drop_flags(argv, flags):
    """`argv` without `flags` (and the value of those that take one)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in flags:
            skip = a in ("--initial-checkpoint", "--teacher_checkpoint")
        else:
            out.append(a)
    return out


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class CliSpy:
    """Wraps the runner's `make_train_step`, `save_epoch` and
    `restore_latest` for the duration of the phase: each train step's
    launches (counts around the call), learning rate and, under CGA, the
    bits of its frozen entries before and after; the student's state when
    the step is built (the loaded start); each save's and restore's wall
    time and bytes; the runners."""

    def __init__(self):
        self.steps, self.starts, self.saves, self.restores = [], [], [], []
        self.runners = []

    @contextlib.contextmanager
    def active(self):
        from ofq_tpu_torch.cli import runner as cli_runner
        names = ("make_train_step", "save_epoch", "restore_latest")
        real = {n: getattr(cli_runner, n) for n in names}
        real_init = cli_runner.Runner.__init__
        spy = self

        def init(runner, *a, **kw):
            real_init(runner, *a, **kw)
            spy.runners.append(runner)

        cli_runner.make_train_step = self._make_train_step(
            real["make_train_step"])
        cli_runner.save_epoch = self._save_epoch(real["save_epoch"])
        cli_runner.restore_latest = self._restore_latest(
            real["restore_latest"])
        cli_runner.Runner.__init__ = init
        try:
            yield self
        finally:
            for n, fn in real.items():
                setattr(cli_runner, n, fn)
            cli_runner.Runner.__init__ = real_init

    def _make_train_step(self, real):
        from ofq_tpu_torch import ops
        from ofq_tpu_torch.train import freeze_masks
        spy = self

        def make(model, optimizer, **kw):
            spy.starts.append({k: v.detach().clone()
                               for k, v in model.state_dict().items()})
            step = real(model, optimizer, **kw)
            cga = kw.get("cga")

            def wrapped(state, batch, generator=None):
                lr = optimizer.lr_schedule(state.opt_state.count)
                frozen = {}
                if cga is not None:
                    masks = freeze_masks(state.params, **cga)
                    frozen = {n: (m > 0.5, state.params[n].detach().clone())
                              for n, m in masks.items() if m is not None}
                before = ops.launch_counts()
                state, metrics = step(state, batch, generator)
                after = ops.launch_counts()
                changed = sum(int((state.params[n][m] != old[m]).sum())
                              for n, (m, old) in frozen.items())
                spy.steps.append(dict(
                    launches={k: after[k] - before[k] for k in after},
                    lr=lr, frozen=sum(int(m.sum()) for m, _ in
                                      frozen.values()),
                    frozen_changed=changed,
                    loss=metrics["loss"]))
                return state, metrics

            return wrapped

        return make

    def _save_epoch(self, real):
        spy = self

        def save(mgr, epoch, state, metrics=None, **kw):
            _sync()
            t0 = time.perf_counter()
            real(mgr, epoch, state, metrics, **kw)
            dt = time.perf_counter() - t0
            path = mgr._path(epoch)
            nbytes = os.path.getsize(path) if os.path.exists(path) else 0
            spy.saves.append(dict(seconds=dt, bytes=nbytes))

        return save

    def _restore_latest(self, real):
        from ofq_tpu_torch.train.checkpoint import load
        spy = self

        def restore(mgr, state, model=None):
            _sync()
            t0 = time.perf_counter()
            out, nxt = real(mgr, state, model)
            _sync()
            dt = time.perf_counter() - t0
            if out is not None:
                step = mgr.latest_step()
                saved = load(mgr, step)
                differing = sum(
                    int((state.params[n].cpu() != t).sum())
                    for n, t in saved["params"].items())
                differing += sum(
                    int((b.cpu() != saved["buffers"][n]).sum())
                    for n, b in model.named_buffers())
                spy.restores.append(dict(
                    seconds=dt, bytes=os.path.getsize(mgr._path(step)),
                    next_epoch=nxt, differing=differing))
            return out, nxt

        return restore

    def take(self):
        """Everything recorded so far, and reset."""
        out = dict(steps=self.steps, starts=self.starts, saves=self.saves,
                   restores=self.restores, runners=self.runners)
        self.__init__()
        return out


def _summary_epochs(exp_dir):
    import csv
    with open(os.path.join(exp_dir, "summary.csv")) as f:
        return [int(r["epoch"]) for r in csv.DictReader(f)]


def _gb_per_s(recs):
    s = sum(r["seconds"] for r in recs)
    b = sum(r["bytes"] for r in recs)
    return (b / s / 1e9 if s else float("nan")), b


def _cli_line(what, t0, rec, launches):
    save_rate, save_bytes = _gb_per_s(rec["saves"])
    rest_rate, rest_bytes = _gb_per_s(rec["restores"])
    nz = {k: v for k, v in launches.items() if v}
    log(f"[cli] {what}: wall {time.perf_counter() - t0:.1f} s, "
        f"{len(rec['steps'])} steps, launches {nz}, checkpoints "
        f"{len(rec['saves'])} x {save_bytes / max(len(rec['saves']), 1)/1e6:.1f}"
        f" MB saved at {save_rate:.2f} GB/s, {len(rec['restores'])} "
        f"restored ({rest_bytes / 1e6:.1f} MB) at {rest_rate:.2f} GB/s")
    return dict(seconds=time.perf_counter() - t0, steps=len(rec["steps"]),
                launches=launches, saves=rec["saves"],
                restores=rec["restores"], save_gb_per_s=save_rate,
                restore_gb_per_s=rest_rate)


def _check_steps(what, steps, want, n):
    if len(steps) != n:
        raise AssertionError(f"{what}: {len(steps)} train steps, expected "
                             f"{n}")
    for i, s in enumerate(steps):
        if s["launches"] != want:
            raise AssertionError(f"{what}: step {i} launched "
                                 f"{s['launches']}, expected {want}")


def _check_warm_start(start, teacher, fp_path, depth):
    """The loaded student (its state when the first step was built) and
    the teacher against the `.pth.tar`: every student entry the converted
    tree holds bit for bit, q/k/v the thirds of the file's qkv (v's bias
    the last third), every teacher parameter the file's."""
    import numpy as np
    import torch
    from ofq_tpu_torch.convert import (convert_deit, flatten_flax_tree,
                                       load_torch_state_dict,
                                       split_qkv_for_qkr)
    sd = load_torch_state_dict(fp_path)
    tree = convert_deit(sd, depth=12, img_size=224)
    flat_t = {k.replace("/", "."): v for k, v in
              flatten_flax_tree(tree).items()}
    flat_s = {k.replace("/", "."): v for k, v in flatten_flax_tree(
        split_qkv_for_qkr(convert_deit(sd, depth=depth))).items()}
    compared = differing = 0
    for n, t in start.items():
        if n in flat_s and tuple(t.shape) == flat_s[n].shape:
            compared += 1
            differing += int((t.cpu() != torch.from_numpy(
                np.asarray(flat_s[n]))).sum())
    kernels = [n for n in start if n.endswith("kernel")
               and not n.startswith(("head", "patch_embed"))]
    missing = [n for n in kernels if n not in flat_s]
    qkv = 0
    for i in range(depth):
        w = sd[f"blocks.{i}.attn.qkv.weight"].T
        b = sd[f"blocks.{i}.attn.qkv.bias"]
        C = w.shape[0]
        for j, part in enumerate("qkv"):
            got = start[f"blocks_{i}.attn.{part}_kernel"].cpu().numpy()
            qkv += int((got != w[:, j * C:(j + 1) * C]).sum())
        qkv += int((start[f"blocks_{i}.attn.v_bias"].cpu().numpy()
                    != b[2 * C:]).sum())
    t_diff = sum(int((p.detach().cpu() != torch.from_numpy(
        np.asarray(flat_t[n]))).sum()) for n, p in teacher.named_parameters())
    t_missing = [n for n, _ in teacher.named_parameters() if n not in flat_t]
    log(f"[cli] warm start: {compared} student entries from the file, "
        f"{differing} elements differing; q/k/v against the file's qkv "
        f"thirds: {qkv} differing; teacher: "
        f"{sum(1 for _ in teacher.parameters())} parameters, {t_diff} "
        f"elements differing")
    if differing or missing or qkv or t_diff or t_missing or not compared:
        raise AssertionError(f"warm start: student {differing} differing, "
                             f"missing {missing[:5]}, qkv {qkv}, teacher "
                             f"{t_diff} differing, missing {t_missing[:5]}")
    return dict(student_entries=compared, teacher_entries=len(flat_t))


def _composed_steps(dev, runner, start, n):
    """`n` steps of `make_train_step` composed from the runner's loaded
    start, its optimizer, `synthetic_batches` and the step's generator:
    (student, state)."""
    import torch
    from ofq_tpu_torch.cli.runner import build_model
    from ofq_tpu_torch.data import synthetic_batches
    from ofq_tpu_torch.train import TrainState, make_train_step
    args = runner.args
    student = build_model(args, runner.policy, device=dev)
    student.load_state_dict(start)
    tx, _ = runner.build_optimizer(args.steps_per_epoch)
    state = TrainState.create(student, tx, master_dtype="float32")
    step = make_train_step(student, tx, teacher=runner.teacher,
                           loss_kind=runner.loss_kind,
                           label_smoothing=args.smoothing, device=dev,
                           token_kd_alpha=args.kd_alpha,
                           token_kd_type=args.kd_type,
                           master_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stream = synthetic_batches(runner.data_cfg, train=True)
    for _ in range(n):
        b = next(stream)
        state, _ = step(state, {k: torch.from_numpy(v).to(dev)
                                for k, v in b.items()}, gen)
    return student, state


def _same_as_checkpoint(exp_dir, epoch, student, state):
    """Elements differing between checkpoint `epoch` and the state."""
    from ofq_tpu_torch.train.checkpoint import load, make_manager
    saved = load(make_manager(exp_dir), epoch)
    out = {}
    for what, got, want in (
            ("params", saved["params"], dict(student.named_parameters())),
            ("mu", saved["opt_state"]["mu"], state.opt_state.mu),
            ("nu", saved["opt_state"]["nu"], state.opt_state.nu),
            ("buffers", saved["buffers"], dict(student.named_buffers()))):
        if sorted(got) != sorted(want):
            raise AssertionError(f"checkpoint {what}: other names")
        out[what] = sum(int((got[k] != w.detach().cpu()).sum())
                        for k, w in want.items())
    return out


def _eval_counts(model, data_cfg, dev):
    """top-1 and top-5 (percent) of `model` over the runner's synthetic
    validation batches, by `make_eval_step`'s ranking."""
    import torch
    from ofq_tpu_torch.data import synthetic_batches
    from ofq_tpu_torch.train import make_eval_step
    step = make_eval_step(model)
    tot = None
    for b in synthetic_batches(data_cfg, train=False):
        out = step(None, {k: torch.from_numpy(v).to(dev)
                          for k, v in b.items()})
        row = torch.stack([out[k].double() for k in
                           ("correct1", "correct5", "count")])
        tot = row if tot is None else tot + row
    c1, c5, n = tot.tolist()
    return {"top1": 100.0 * c1 / n, "top5": 100.0 * c5 / n}


def phase_cli(dev, deit="deit_small_distilled_patch16_224", swin="swin_t",
              batch=BATCH, steps=2, extra=()):
    """The recipe's runs through the port's entry points
    (`cli.train.main`, `cli.cga.main`, `cli.eval.main`, `serve.main`) at
    full width, synthetic data, in a temporary directory (`extra`: more
    flags for every run, e.g. a test model's `--img-size`):

      (a) the float `deit` from seed 0 written as the original layout's
          `.pth.tar` (`convert.torch_export`): the recipe's
          `--initial-checkpoint` and `--teacher_checkpoint`; the loaded
          student and teacher held to the file bit for bit;
      (b) phase 1, train_scripts/deit_s/w2a2_deit_s.sh's first command
          with `--batch-size`, `--steps-per-epoch`, `--epochs 2`, no
          warmup or cooldown, `--matmul-impl fused --attn-impl fused`:
          36 K1 + 12 K2 + 12 K3 each step; the epoch-0 checkpoint the
          same bits as `steps` steps of `make_train_step` composed from
          the loaded start; summary epochs 0, 1;
      (c) auto-resume with `--epochs 3`: continues at epoch 2 from the
          saved state bit for bit; summary 0, 1, 2;
      (d) the recipe's CGA command from phase 1 (`--resume`, type 1,
          boundary 0.005, one epoch): no frozen entry's bits change, the
          rate is `--min-lr` at every step, the launches of (b);
      (e) `cli.eval.main --resume <cga>`: top-1 / top-5 equal to
          `Predictor.from_experiment`'s model on the same batches;
      (f) `serve.main <cga> --bench-iters 5`, `--export`, `--artifact
          --int-core`: the artifact's codes those the integer core
          rebuilds and the live student's, 60 int8_mm a forward;
      (g) `swin` through the Swin-T recipe's first command without its
          warm-start flags, one epoch of `steps` steps, `--matmul-impl
          pallas --compute-dtype bfloat16`: 39 K4 a step and a forward.
    One `[cli]` line each: wall s, steps, launches, checkpoint bytes, the
    GB/s of save and restore (host copy and file, synchronous)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from ofq_tpu_torch import ops, serve
    from ofq_tpu_torch.cli import cga as cli_cga
    from ofq_tpu_torch.cli import eval as cli_eval
    from ofq_tpu_torch.cli import train as cli_train
    from ofq_tpu_torch.convert import (model_variables, save_pth_tar,
                                       torch_export)
    from ofq_tpu_torch.models import create_model
    from ofq_tpu_torch.quant import QuantPolicy
    out = {}
    tmp = tempfile.mkdtemp(prefix="ofq_cli_")
    spy = CliSpy()
    try:
        # (a) the warm-start file (12 blocks: the runner converts a
        # teacher file at convert_deit's default depth, as JAX's does)
        t0 = time.perf_counter()
        fp = create_model(deit, policy=QuantPolicy(), device=dev,
                          generator=torch.Generator().manual_seed(0),
                          depth=12)
        fp_path = save_pth_tar(
            torch_export.export_deit(model_variables(fp)["params"]),
            os.path.join(tmp, "fp.pth.tar"), arch=deit)
        del fp
        log(f"[cli] (a) float {deit} written as {os.path.getsize(fp_path)}"
            f" bytes of .pth.tar in {time.perf_counter() - t0:.1f} s")
        p1, c1 = recipe_argvs(DEIT_RECIPE, "synthetic", fp_path)
        common = ["--batch-size", str(batch), "--steps-per-epoch",
                  str(steps), "--warmup-epochs", "0", "--cooldown-epochs",
                  "0", "--matmul-impl", "fused", "--attn-impl", "fused",
                  "--output", tmp, "--log-interval", "1", "--model", deit,
                  "--teacher", deit, *extra]
        phase1 = os.path.join(tmp, "phase1")

        # (b) phase 1
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        with spy.active():
            cli_train.main(p1 + common + ["--epochs", "2", "--experiment",
                                          "phase1"], device=dev)
        launches = ops.launch_counts()
        k1_shapes = _shapes(ops.fused_qlinear_fwd)
        rec = spy.take()
        r = rec["runners"][0]
        cfg = r.model.cfg
        want = _expected(FUSED, cfg, train=True)
        _check_steps("(b) phase 1", rec["steps"], want, 2 * steps)
        out["warm_start"] = _check_warm_start(rec["starts"][0], r.teacher,
                                              fp_path, cfg.depth)
        student, state = _composed_steps(dev, r, rec["starts"][0], steps)
        diff = _same_as_checkpoint(phase1, 0, student, state)
        del student, state
        log(f"[cli] (b) epoch-0 checkpoint against {steps} composed steps "
            f"from the same start: elements differing {diff}")
        if any(diff.values()):
            raise AssertionError(f"the runner's checkpoint is not the "
                                 f"composed steps': {diff}")
        if _summary_epochs(phase1) != [0, 1]:
            raise AssertionError(f"summary epochs {_summary_epochs(phase1)}")
        out["phase1"] = _cli_line("(b) phase 1", t0, rec, launches)
        out["phase1"].update(composed_differing=diff,
                             k1_launch_shapes=k1_shapes,
                             per_step=rec["steps"][0]["launches"])

        # (c) auto-resume
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        with spy.active():
            cli_train.main(p1 + common + ["--epochs", "3", "--experiment",
                                          "phase1"], device=dev)
        launches = ops.launch_counts()
        rec = spy.take()
        _check_steps("(c) resume", rec["steps"], want, steps)
        res = rec["restores"]
        if len(res) != 1 or res[0]["next_epoch"] != 2 or res[0]["differing"]:
            raise AssertionError(f"(c) resume: {res}")
        if _summary_epochs(phase1) != [0, 1, 2]:
            raise AssertionError(f"summary epochs {_summary_epochs(phase1)}")
        out["resume"] = _cli_line("(c) auto-resume", t0, rec, launches)

        # (d) CGA
        t0 = time.perf_counter()
        cga_dir = os.path.join(tmp, "cga")
        cga_argv = c1 + common + [
            "--resume", phase1, "--qk_reparam_type", "1", "--boundaryRange",
            "0.005", "--freeze_for_n_epochs", "1", "--experiment", "cga"]
        ops.reset_launch_counts()
        with spy.active():
            cli_cga.main(cga_argv, device=dev)
        launches = ops.launch_counts()
        rec = spy.take()
        _check_steps("(d) CGA", rec["steps"], want, steps)
        min_lr = float(np.float32(rec["runners"][0].args.min_lr))
        lrs = [s["lr"] for s in rec["steps"]]
        changed = [s["frozen_changed"] for s in rec["steps"]]
        log(f"[cli] (d) CGA: frozen entries per step "
            f"{[s['frozen'] for s in rec['steps']]}, their elements changed "
            f"{changed}; learning rates {lrs}")
        if any(changed) or any(lr != min_lr for lr in lrs) or not all(
                s["frozen"] for s in rec["steps"]):
            raise AssertionError(f"(d) CGA: frozen changed {changed}, "
                                 f"rates {lrs} (min_lr {min_lr})")
        out["cga"] = _cli_line("(d) CGA", t0, rec, launches)

        # (e) eval
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        with spy.active():
            got = cli_eval.main(cga_argv[:-2] + ["--experiment", "eval",
                                                 "--resume", cga_dir],
                                device=dev)
        rec = spy.take()
        pred = serve.Predictor.from_experiment(cga_dir, batch_size=batch,
                                               device=dev)
        ref = _eval_counts(pred.model, rec["runners"][0].data_cfg, dev)
        log(f"[cli] (e) eval: top1 {got['top1']:.3f} top5 "
            f"{got['top5']:.3f}; Predictor.from_experiment on the same "
            f"batches: {ref}")
        if (got["top1"], got["top5"]) != (ref["top1"], ref["top5"]):
            raise AssertionError(f"(e) eval {got} != predictor {ref}")
        out["eval"] = _cli_line("(e) eval", t0, rec, ops.launch_counts())
        out["eval"].update(top1=got["top1"], top5=got["top5"])
        del pred

        # (f) serving
        t0 = time.perf_counter()
        bs = ["--batch-size", str(batch)]
        live = serve.main([cga_dir, "--bench-iters", "5", *bs], device=dev)
        x = np.random.default_rng(0).normal(
            size=(batch, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
        ops.reset_launch_counts()
        live.predict(x)
        served = ops.launch_counts()
        want_fwd = _expected(FUSED, cfg, train=False)
        if served != want_fwd:
            raise AssertionError(f"(f) served {served}, expected {want_fwd}")
        art = os.path.join(tmp, "art.npz")
        serve.main([cga_dir, "--export", art, *bs], device=dev)
        frozen = serve.main([cga_dir, "--artifact", art, "--int-core", *bs],
                            device=dev)
        ops.reset_launch_counts()
        frozen.predict(x)
        int_launches = ops.launch_counts()
        int_shapes = _shapes(ops.int8_mm)
        exported = dict(np.load(art))
        codes = frozen_codes(frozen.model, exported, live.model)
        bad = {k: v for k, v in codes.items() if any(v)}
        n_int = _path_counts(cfg)[0] + 2 * cfg.depth
        log(f"[cli] (f) serving: {served} a forward; the artifact "
            f"({os.path.getsize(art)} bytes): {len(codes)} StatsQ entries, "
            f"codes differing from the integer core's and the live "
            f"student's {bad or 0}; --int-core {int_launches} a forward")
        if bad or int_launches["int8_mm"] != n_int or int_launches[
                "fused_qlinear_fwd"]:
            raise AssertionError(f"(f) codes {bad}, int core launches "
                                 f"{int_launches} (int8_mm {n_int})")
        out["serve"] = dict(seconds=time.perf_counter() - t0,
                            launches=served, int_core_launches=int_launches,
                            int8_launch_shapes=int_shapes,
                            artifact_bytes=os.path.getsize(art))
        log(f"[cli] (f) serving: wall {out['serve']['seconds']:.1f} s")
        del live, frozen
        shutil.rmtree(phase1)
        torch.cuda.empty_cache()

        # (g) Swin-T, pallas bf16
        t0 = time.perf_counter()
        s1 = _drop_flags(recipe_argvs(SWIN_RECIPE, "synthetic", "-")[0],
                         WARM_START)
        ops.reset_launch_counts()
        with spy.active():
            cli_train.main(s1 + [
                "--batch-size", str(batch), "--steps-per-epoch", str(steps),
                "--epochs", "1", "--warmup-epochs", "0", "--cooldown-epochs",
                "0", "--matmul-impl", "pallas", "--compute-dtype",
                "bfloat16", "--output", tmp, "--experiment", "swin",
                "--log-interval", "1", "--model", swin, "--teacher", swin,
                *extra], device=dev)
        launches = ops.launch_counts()
        k4_shapes = _shapes(ops.pallas_statsq_fwd)
        rec = spy.take()
        scfg = rec["runners"][0].model.cfg
        want_swin = _expected(PALLAS, scfg, train=True)
        _check_steps("(g) Swin-T", rec["steps"], want_swin, steps)
        # the calibration forward launches K4 too (calibrating bypasses
        # only the fused branch), then every step and eval batch
        n_eval = len(list(_eval_batches(rec["runners"][0].data_cfg)))
        per = want_swin["pallas_statsq_fwd"]
        if launches["pallas_statsq_fwd"] != per * (1 + steps + n_eval):
            raise AssertionError(
                f"(g) K4 {launches}, expected {per} x (the calibration "
                f"forward, {steps} steps, {n_eval} eval batches)")
        out["swin"] = _cli_line("(g) Swin-T pallas bf16", t0, rec, launches)
        out["swin"].update(k4_launch_shapes=k4_shapes,
                           per_step=rec["steps"][0]["launches"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _eval_batches(data_cfg):
    from ofq_tpu_torch.data import synthetic_batches
    return synthetic_batches(data_cfg, train=False)


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
    """The redesigned kernels' times summed over their launches on a path,
    the current launchers' and the earlier tree's (--baseline), each
    launcher alone into preallocated outputs, and the ratio: K1 over a
    fused step's 36, K2 and K3 over a fused step's 12 each (fp32) and a
    fused bf16 step's 12 each, K4 over a pallas step's 36 and a Swin-T
    forward's 39, K5 over the 36 captured dx products, K6 in every form
    and at both WB, K7 and K8 at their defaults per launch."""
    def on_path(rows, shapes):
        return [(shapes.get(str((r["M"], r["K"], r["N"])), 0), r)
                for r in rows if r["main_path"]]
    sums = {
        "K1, fused DeiT-S train step": on_path(
            full["k1"], full["train"]["launch_shapes"]),
        "K4 bfloat16, pallas DeiT-S train step": on_path(
            full["k4"], full["train_pallas"]["launch_shapes"]),
        "K4 bfloat16, Swin-T W2A2 QKR serving forward": on_path(
            full["k4_swin"], full["swin_pallas"]["launch_shapes"]),
        "K5 bfloat16, the dx products captured from one pallas step": [
            (1, r) for r in full["k5_captured"]["versus_baseline"]]}
    for dt, train in (("float32", "train"), ("bfloat16", "train_fused_bf16")):
        for key, fn in (("k2", "qkr_attention_fwd"),
                        ("k3", "qkr_attention_bwd")):
            launches = full[train]["launches"][fn]
            sums[f"{key.upper()} {dt}, fused {dt} DeiT-S train step"] = [
                (launches, r) for r in full[key]
                if r["main_path"] and r["dtype"] == dt]
    for r in full["k678"]:
        if "raw_ms" in r and (r["default"] or r["kernel"] == "K6"):
            sums[f"{r['kernel']} {r['name']} {r['form']} {r['params']}, one "
                 f"launch at the lab's shapes"] = [(1, r)]
    out = {}
    for what, pairs in sums.items():
        n = sum(c for c, _ in pairs)
        cur = sum(c * r["raw_ms"] for c, r in pairs)
        old = sum(c * r["baseline_raw_ms"] for c, r in pairs)
        out[what] = dict(launches=n, ms=cur, baseline_ms=old,
                         speedup=old / cur if cur else None)
        log(f"[versus earlier] {what}, {n} launches: {cur:.3f} ms now, "
            f"{old:.3f} ms earlier (launchers alone), "
            f"{old / cur if cur else float('nan'):.2f}x")
    return out


def _kernel_row(name, src, launches, r, library_ms=None, **extra):
    """A kernel's entry in the result line; `library_ms`: the time of one
    PyTorch call that computes the same function, where there is one."""
    return dict(name=name, route="cuda", source=src[0], replaces=src[1],
                launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=library_ms, **extra)


def main() -> int:
    import dataclasses
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
    from ofq_tpu_torch.quant import (w2a2_deit_policy, w2a2_qkr_policy,
                                     w2a2_qkr_swin_policy, w2a2_swin_policy)
    n_tok = DEIT_SMALL.n_tokens  # 14 * 14 patches + cls + dist = 198
    deit = "deit_small_distilled_patch16_224"
    full = dict(card=card, build_s=build["seconds"], build=build)
    full["k1"] = phase_k1(dev, n_tok, base=base)
    full["k2"] = phase_k2(dev, n_tok, base=base)
    full["k3"] = phase_k3(dev, n_tok, base=base)
    full["slice"] = phase_slice(dev, FUSED, deit, w2a2_qkr_policy(12))
    torch.cuda.empty_cache()
    full["train"] = phase_train(dev, FUSED)
    torch.cuda.empty_cache()
    full["slice_fused_bf16"] = phase_slice(dev, FUSED_BF16, deit,
                                           w2a2_qkr_policy(12))
    torch.cuda.empty_cache()
    full["train_fused_bf16"] = phase_train(dev, FUSED_BF16)
    torch.cuda.empty_cache()
    full["cga"] = phase_cga(dev, FUSED)
    torch.cuda.empty_cache()
    full["cga_fused_bf16"] = phase_cga(dev, FUSED_BF16)
    torch.cuda.empty_cache()
    full["k4"] = phase_k45(dev, "K4", _k45_cases(BATCH * n_tok, qkv=True),
                           base=base)
    full["k5"] = phase_k45(dev, "K5", _k45_cases(BATCH * n_tok), base=base)
    torch.cuda.empty_cache()
    full["slice_pallas"] = phase_slice(dev, PALLAS, deit, w2a2_qkr_policy(12))
    torch.cuda.empty_cache()
    tp = full["train_pallas"] = phase_train(dev, PALLAS)
    full["k5_captured"] = phase_k5_captured(tp.pop("captured"), base=base)
    torch.cuda.empty_cache()
    full["gate_selfcheck"] = phase_gate_selfcheck(dev)
    torch.cuda.empty_cache()
    full["k678"] = phase_k678(dev, base=base)
    full["k6_seeds"] = phase_k6_seeds(dev)
    full["k6_emulated"] = phase_k6_emulated(dev)
    torch.cuda.empty_cache()
    full["lab"] = phase_lab(dev)
    torch.cuda.empty_cache()
    full["swin_float"] = phase_swin_float(dev)
    torch.cuda.empty_cache()
    # the path's stream; with --baseline both streams, and K5 at the same
    # shapes, against the earlier launchers
    swin_dtypes = ((torch.float32, torch.bfloat16) if base
                   else (torch.bfloat16,))
    full["k4_swin"] = phase_k45(dev, "K4", _swin_k4_cases(),
                                dtypes=swin_dtypes, base=base)
    if base:
        full["k5_swin"] = phase_k45(dev, "K5", _swin_k4_cases(),
                                    dtypes=swin_dtypes, base=base)
    torch.cuda.empty_cache()
    sp = full["swin_pallas"] = phase_slice(dev, PALLAS, "swin_t",
                                           w2a2_qkr_swin_policy(),
                                           gate=SWIN_GATE)
    torch.cuda.empty_cache()
    st = full["train_swin_pallas"] = phase_train(
        dev, PALLAS, "swin_t", gate=SWIN_GATE, overrides=SWIN_BENCH)
    torch.cuda.empty_cache()
    full["cga_swin"] = phase_cga(dev, PALLAS, "swin_t", bf16_masters=False,
                                 selfchecks=False)
    torch.cuda.empty_cache()
    full["dropout"] = phase_dropout(dev)
    torch.cuda.empty_cache()
    full["remat"] = phase_remat(dev)
    torch.cuda.empty_cache()
    # the LN->BN swap, the oscillation hook and per-layer gradient norms,
    # the MLP activations besides GELU (DeiT-S and Swin-T at full width)
    full["bn"] = phase_bn(dev)
    torch.cuda.empty_cache()
    full["oscillation"] = phase_oscillation(dev)
    torch.cuda.empty_cache()
    for act in ("prelu", "rprelu"):
        full[f"train_{act}"] = phase_train(
            dev, FUSED, policy=dataclasses.replace(w2a2_qkr_policy(12),
                                                   act_layer=act),
            timed=False, order_spread=True)
        torch.cuda.empty_cache()
    for act in ("relu", "None"):
        full[f"slice_{act}"] = phase_slice(
            dev, FUSED, deit, dataclasses.replace(w2a2_qkr_policy(12),
                                                  act_layer=act),
            timed=False)
        torch.cuda.empty_cache()
    # the non-QKR and full-LSQ DeiT-S students, the telemetry losses, and
    # the non-QKR Swin-T (this slice's paths, at full depth)
    nonqkr = w2a2_deit_policy(12, qk_reparam=False)
    full["slice_nonqkr"] = phase_slice(dev, FUSED, deit, nonqkr)
    torch.cuda.empty_cache()
    full["train_nonqkr"] = phase_train(dev, FUSED, policy=nonqkr)
    torch.cuda.empty_cache()
    full["train_nonqkr_bf16"] = phase_train(dev, FUSED_BF16, policy=nonqkr)
    torch.cuda.empty_cache()
    full["train_nonqkr_pallas"] = phase_train(dev, PALLAS, policy=nonqkr)
    torch.cuda.empty_cache()
    lsq = w2a2_deit_policy(12, qk_reparam=False, wq_mode="lsq")
    full["train_lsq"] = phase_train(dev, FUSED, policy=lsq)
    torch.cuda.empty_cache()
    for kind, over in (("kd_qk", dict(qqkkvv=True)),
                       ("kd_qkv", dict(qqkkvv=True)),
                       ("kd_token", dict(return_features=True))):
        full[f"train_{kind}"] = phase_train(dev, FUSED, loss_kind=kind,
                                            overrides=over, timed=False)
        torch.cuda.empty_cache()
    swin_nonqkr = w2a2_swin_policy(qk_reparam=False)
    snq = full["swin_nonqkr"] = phase_slice(dev, PALLAS, "swin_t",
                                            swin_nonqkr, gate=SWIN_GATE)
    torch.cuda.empty_cache()
    stq = full["train_swin_nonqkr"] = phase_train(
        dev, PALLAS, "swin_t", gate=SWIN_GATE, overrides=SWIN_BENCH,
        policy=swin_nonqkr)
    torch.cuda.empty_cache()
    full["int8_mm"] = phase_int8_mm(dev)
    full["slice_nonqkr_int8"] = phase_slice(dev, INT8, deit, nonqkr)
    torch.cuda.empty_cache()
    full["frozen_lsq"] = phase_frozen_lsq(dev, deit, lsq)
    torch.cuda.empty_cache()
    built = build_served(dev, INT8, deit, w2a2_qkr_policy(12))
    full["slice_int8"] = phase_slice(dev, INT8, deit, w2a2_qkr_policy(12),
                                     built=built)
    full["int8_selfcheck"] = phase_int8_selfcheck(dev, built)
    full["frozen_deit"] = phase_frozen(
        dev, deit, w2a2_qkr_policy(12), built, dict(num_heads=6),
        rate_batch=FROZEN_BATCH)
    del built
    torch.cuda.empty_cache()
    full["train_int8"] = phase_train(dev, INT8)
    torch.cuda.empty_cache()
    built = build_served(dev, INT8, "swin_t", w2a2_qkr_swin_policy())
    full["swin_int8"] = phase_slice(dev, INT8, "swin_t",
                                    w2a2_qkr_swin_policy(), gate=SWIN_GATE,
                                    built=built)
    full["frozen_swin"] = phase_frozen(
        dev, "swin_t", w2a2_qkr_swin_policy(), built, dict(head_dim=32),
        gate=SWIN_GATE)
    del built
    torch.cuda.empty_cache()
    full["train_swin_int8"] = phase_train(
        dev, INT8, "swin_t", batch=SWIN_INT8_TRAIN_BATCH, gate=SWIN_GATE,
        overrides=SWIN_BENCH)
    torch.cuda.empty_cache()
    # the recipe through the training CLI, the checkpoints and serving
    cli = full["cli"] = phase_cli(dev)
    torch.cuda.empty_cache()
    int8_launches = {
        "DeiT-S without QKR int8 serving":
            full["slice_nonqkr_int8"]["launch_shapes"],
        "DeiT-S full-LSQ frozen integer core":
            full["frozen_lsq"]["launch_shapes"],
        "DeiT-S int8 serving": full["slice_int8"]["launch_shapes"],
        "DeiT-S int8 train step": full["train_int8"]["launch_shapes"],
        "DeiT-S frozen integer core, B=64":
            full["frozen_deit"]["launch_shapes"],
        f"DeiT-S frozen integer core, B={FROZEN_BATCH}":
            full["frozen_deit"]["rate_batch_shapes"],
        "Swin-T int8 serving": full["swin_int8"]["launch_shapes"],
        "Swin-T frozen integer core": full["frozen_swin"]["launch_shapes"],
        f"Swin-T int8 train step, B={SWIN_INT8_TRAIN_BATCH}":
            full["train_swin_int8"]["launch_shapes"],
        "DeiT-S CLI serve.main --artifact --int-core, B=64":
            cli["serve"]["int8_launch_shapes"]}
    for what, shapes in int8_launches.items():
        rows_of = (f"Swin-T B={SWIN_INT8_TRAIN_BATCH}" if "train step" in what
                   and what.startswith("Swin")
                   else "Swin-T B=64" if what.startswith("Swin")
                   else f"DeiT-S B={FROZEN_BATCH}" if str(FROZEN_BATCH)
                   in what else NONQKR_INT8_ROWS if "QKR" in what
                   or "LSQ" in what else "DeiT-S B=64")
        check_int8_shapes(full["int8_mm"], rows_of, shapes)

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
    tr_nq = full["train_nonqkr"]
    for r in full["k1"]:
        if r["main_path"]:
            # qkv: the linear of the student without QKR only
            qkv = r["name"] == "qkv"
            kernels.append(_kernel_row(
                f"fused_qlinear_fwd {r['name']} "
                f"({r['M']}x{r['K']}x{r['N']}) [{r['design']['label']}]",
                srcs["K1"],
                (tr_nq if qkv else tr)["launch_shapes"].get(
                    str((r["M"], r["K"], r["N"])), 0),
                r, path=("fused train step without QKR" if qkv
                         else "fused train step"),
                design=r["design"]["label"],
                # over the CLI's phase 1 (its steps and eval forwards)
                cli_launches=cli["phase1"]["k1_launch_shapes"].get(
                    str((r["M"], r["K"], r["N"])), 0)))
    tr_bf16 = full["train_fused_bf16"]
    tr_nq_bf16 = full["train_nonqkr_bf16"]
    for key, fn in (("k2", "qkr_attention_fwd"),
                    ("k3", "qkr_attention_bwd")):
        for r in full[key]:
            if not r["quantize"]:
                continue
            bf16 = r["dtype"] == "bfloat16"
            # the shared lhs runs on the QKR steps, the per-head lhs on the
            # steps without QKR
            steps = ((tr_bf16, tr) if r["shared"] else (tr_nq_bf16, tr_nq))
            kernels.append(_kernel_row(
                f"{fn} {'bf16' if bf16 else 'fp32'} ("
                f"{'shared' if r['shared'] else 'per-head'} lhs, LSQ on, "
                f"{r['B']}x{r['N']}x{r['H']}x{r['K']}, d={r['d']})",
                srcs[key.upper()], steps[0 if bf16 else 1]["launches"][fn],
                r, path=f"fused {'bf16' if bf16 else 'fp32'} train step"
                + ("" if r["shared"] else " without QKR"),
                design=r["design"],
                yardstick_sdpa_ms=r["sdpa_ms" if key == "k2"
                                    else "sdpa_bwd_ms"],
                cli_launches=(cli["phase1"]["launches"][fn]
                              if r["shared"] and not bf16 else 0)))
    tp_nq = full["train_nonqkr_pallas"]
    for r in full["k4"]:
        if r["main_path"]:
            qkv = r["name"] == "qkv"
            kernels.append(_kernel_row(
                f"pallas_statsq_fwd {r['name']} bf16 "
                f"({r['M']}x{r['K']}x{r['N']})", srcs["K4"],
                (tp_nq if qkv else tp)["launch_shapes"].get(
                    str((r["M"], r["K"], r["N"])), 0), r,
                path=("pallas bf16 train step without QKR" if qkv
                      else "pallas bf16 train step"), design=r["design"]))
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
    for serving, (res, res_nq) in ((True, (sp, snq)), (False, (st, stq))):
        for r in filter(lambda r: r["main_path"], full["k4_swin"]):
            qkv = r["name"].endswith("qkv")
            kernels.append(_kernel_row(
                f"pallas_statsq_fwd Swin-T {r['name']} bf16 "
                f"({r['M']}x{r['K']}x{r['N']})", srcs["K4"],
                (res_nq if qkv else res)["launch_shapes"].get(
                    str((r["M"], r["K"], r["N"])), 0), r,
                path=f"Swin-T W2A2 {'without QKR' if qkv else 'QKR'} pallas "
                     f"bf16 {'serving forward' if serving else 'train step'}",
                design=r["design"],
                cli_launches=cli["swin"]["k4_launch_shapes"].get(
                    str((r["M"], r["K"], r["N"])), 0)))
    captured = full["swin_float"]["captured"]
    lab_launches = full["lab"]["launches"]
    for r in full["k678"]:
        if r["form"] != "full":
            kernels.append(_kernel_row(
                f"{r['name']} {r['form']} {r['params']} ({LAB_BN}x{LAB_N}x"
                f"{LAB_H}x{LAB_D} bf16)", srcs["K6"],
                lab_launches[f"{r['name']}_{r['form']}"], r,
                path="the port's lab entry point (units16_"
                     f"{r['form']})", design=r["design"]))
        elif r["default"]:
            kernels.append(_kernel_row(
                f"{r['name']} {r['params']} ({LAB_BN}x{LAB_N}x{LAB_H}x"
                f"{LAB_D} bf16)", srcs[r["kernel"]],
                lab_launches[r["name"]],
                dict(r, max_abs_err=max([r["max_abs_err"]] + [
                    c["max_abs_err"] for c in captured
                    if c["name"] == r["name"]])),
                path="the port's lab entry point, and the q, k, v of the "
                     "float Swin-T's two stage-0 blocks, captured with hooks",
                captured_launches=full["swin_float"]["k678_launches"][
                    r["name"]],
                # softmax(q k^T d^-1/2) v: SDPA computes the same function
                library_ms=r["sdpa_ms"], design=r["design"]))
    if any(k["launches"] <= 0 for k in kernels if k["path"] is not None):
        raise AssertionError(f"a kernel of the path was not launched: "
                             f"{kernels}")
    if base:
        full["versus_baseline"] = compare_baseline(full)
    full["seconds"] = time.perf_counter() - t_start
    int8 = int8_rows(full["int8_mm"], int8_launches)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(full, f, indent=1)
    log(f"[done] {full['seconds']:.1f} s")
    # the int8 paths' integer product, a library call (no TPU kernel lies
    # on those paths), on a line of its own
    log(json.dumps({"int8_mm": int8}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
