"""Fused quantized attention core: scores -> softmax -> LSQ -> @ v, forward
and backward (port of `ofq_tpu/ops/fused_attention.py`).

    scores = lhs @ rhs^T * sm_scale
    p      = softmax(scores, axis=-1)
    pq     = round(clip(p / s_n, 0, 2^bits - 1)) * s_n   (per query row n,
                                                        s_n floored at 1e-5)
    out    = pq @ v

every sum in fp32, as in the TPU kernels.

lhs is the QKR input shared across heads, (B, N, K), or per head,
(B, N, H, K); rhs (B, N, H, K); v (B, N, H, d); s (N,); out (B, N, H, d),
all in the JAX package's natural layout.

The stream dtype of lhs, rhs, v (and the cotangent g) is fp32 or bf16, as
the TPU kernels are generic over it.  In bf16 they round where the TPU
kernels round: operands widen exactly, products and the softmax are fp32,
pq is rounded to bf16 before `@ v`, out comes back in bf16; in the
backward pq is rounded before dv, dscores * sm_scale once before drhs and
dlhs, and dlhs, drhs, dv come back in bf16 (a shared dlhs after its fp32
sum over heads); s and ds stay fp32.

Two kernels, each with its plain PyTorch version beside it:
  * `qkr_attention_fwd` (K2, `csrc/fused_attention.cu`);
  * `qkr_attention_bwd` (K3, `csrc/fused_attention_bwd.cu`), the custom VJP:
    it recomputes the scores from the residuals (lhs, rhs, v, s), so the
    (B, H, N, N) probabilities are never kept for the backward; in bf16
    its products other than the score tile run on the tensor cores
    (`mma.sync`, exact bf16 operands, fp32 sums); in fp32 on the CUDA
    cores, register-tiled, each output one FMA chain in ascending
    contraction order.
K2 and K3 form the scores with one device function, register-tiled on
the CUDA cores in both streams (`csrc/qkr_scores.cuh`), so K3's
probabilities are K2's bit for bit.
A wrapper launches its kernel on CUDA tensors and runs the plain version on
CPU tensors.  `quantized_attention_core` reaches both through `_AttnCore`,
a `torch.autograd.Function`; a wrapper called directly on a tensor that
requires grad, with grad mode on, raises instead of cutting the graph.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..quant.ste import at_least_f32, needs_grad
from . import _build

_S_EPS = 1e-5
# the card's per-block shared memory limit (H100: 227 KB)
_MAX_SMEM = 232448
# an H100 SM: 228 KB of shared memory (1 KB of each block's reserved by
# the system) and 2048 threads
_SM_SMEM, _SM_THREADS = 233472, 2048


def blocks_per_sm(smem, threads):
    """Blocks of `threads` threads and `smem` bytes of dynamic shared
    memory that one H100 SM holds as shared memory and threads allow: at
    least the CUDA runtime's occupancy, which the launch exports report and
    which counts registers too."""
    return min(_SM_SMEM // (smem + 1024), _SM_THREADS // threads)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """exp(x - max) / sum, the division form of jax.nn.softmax.  In bf16 as
    XLA compiles it: the numerator is the bf16 exp, the denominator the
    fp32 sum of the unrounded fp32 exps, rounded once (PERF.md); in fp32
    and fp64 the casts are no-ops."""
    e = torch.exp((x - torch.amax(x, dim=dim, keepdim=True)).to(
        at_least_f32(x.dtype)))
    return e.to(x.dtype) / torch.sum(e, dim=dim, keepdim=True).to(x.dtype)


def refuse_graph_cut(what: str, *tensors: torch.Tensor) -> None:
    """A kernel's output has no autograd history: calling a raw wrapper on
    a tensor that requires grad, with grad mode on, would silently give no
    gradient to anything upstream.  The autograd Functions call the
    wrappers with grad mode off."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what}: called on a tensor that requires grad with grad mode "
            "on; go through the op's autograd Function (the `ops` glue), "
            "or call it under torch.no_grad()")


def on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper launches its CUDA kernel for `t` (else it runs the
    plain version)."""
    return t.is_cuda


def _units_spec(lhs) -> str:
    return "bnk" if lhs.ndim == 3 else "bnhk"


def _f32(*tensors):
    """Exact widening of the stream's operands: a bf16 x bf16 product is
    exact in fp32, so fp32 einsums on them are `dot(...,
    preferred_element_type=float32)`; fp32 and fp64 stay as they are."""
    return [t.to(at_least_f32(t.dtype)) for t in tensors]


def _rounded(x, dtype):
    """x rounded to the stream dtype and widened back: the value a product
    of operands in that dtype reads (the identity in fp32 and fp64)."""
    return x.to(dtype).to(x.dtype)


def qkr_attention_fwd_reference(lhs, rhs, v, s, bits, sm_scale, quantize):
    """Plain PyTorch version of the forward kernel, with fp32 sums as in
    `ofq_tpu.ops.fused_attention._fwd_kernel`, in the stream dtype of v
    (fp32 or bf16): pq rounded to it before `@ v`, the output returned in
    it."""
    dt = v.dtype
    lhs, rhs, v = _f32(lhs, rhs, v)
    p = softmax(torch.einsum(f"{_units_spec(lhs)},bmhk->bhnm", lhs, rhs)
                * sm_scale)
    if quantize:
        s_row = torch.clamp_min(s, _S_EPS)[None, None, :, None]
        p = torch.round(torch.clamp(p / s_row, 0.0, 2 ** bits - 1)) * s_row
    return torch.einsum("bhnm,bmhd->bnhd", _rounded(p, dt), v).to(dt)


def qkr_attention_bwd_reference(lhs, rhs, v, s, g, bits, sm_scale,
                                quantize):
    """Plain PyTorch version of the backward kernel: the arithmetic of
    `ofq_tpu.ops.fused_attention._bwd_kernel`, fp32 sums, in the stream
    dtype of v (fp32 or bf16).  Returns (dlhs, drhs, dv, ds) in the shapes
    of (lhs, rhs, v, s): the first three in the stream dtype, ds in s's."""
    dt = v.dtype
    spec = _units_spec(lhs)
    lhs, rhs, v, g = _f32(lhs, rhs, v, g)
    p = softmax(torch.einsum(f"{spec},bmhk->bhnm", lhs, rhs) * sm_scale)
    dpq = torch.einsum("bnhd,bmhd->bhnm", g, v)
    if quantize:
        thd = float(2 ** bits - 1)
        s_row = torch.clamp_min(s, _S_EPS)[None, None, :, None]
        u = p / s_row
        in_range = u <= thd
        uq = torch.round(torch.clamp(u, 0.0, thd))
        pq = uq * s_row
        dp = torch.where(in_range, dpq, torch.zeros_like(dpq))
        t = torch.where(in_range, uq - u, torch.full_like(u, thd))
        ds = torch.sum(t * dpq, dim=(0, 1, 3))
    else:
        pq, dp = p, dpq
        ds = torch.zeros_like(s)
    dv = torch.einsum("bhnm,bnhd->bmhd", _rounded(pq, dt), g)
    dscores = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dscores = _rounded(dscores * sm_scale, dt)
    drhs = torch.einsum(f"bhnm,{spec}->bmhk", dscores, lhs)
    dlhs = torch.einsum(f"bhnm,bmhk->{spec}", dscores, rhs)
    return dlhs.to(dt), drhs.to(dt), dv.to(dt), ds


def check_args(what, ref, **args):
    """Every argument a contiguous tensor of its shape on ref's device, of
    the dtype given (`name=(t, shape)` or `name=(t, shape, dtype)`; fp32
    when none is given)."""
    for name, (t, shape, *dtype) in args.items():
        dt = dtype[0] if dtype else torch.float32
        if (t.device != ref.device or t.dtype != dt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{what}: {name} must be a contiguous "
                f"{str(dt).replace('torch.', '')} tensor of "
                f"shape {shape} on {ref.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _shapes(lhs, rhs, v):
    B, N, H, K = rhs.shape
    d = v.shape[-1]
    lhs_shape = (B, N, K) if lhs.ndim == 3 else (B, N, H, K)
    return B, N, H, K, d, lhs_shape


# the stream dtypes the kernels take for their activations and outputs
# (K2, K3 and K4: fp32 and bf16), and the suffix of K2's and K3's launcher
# for each
_LAUNCHERS = {torch.float32: "", torch.bfloat16: "_bf16"}


def stream_dtype(t):
    """The dtype `check_args` asks of a kernel's activations: t's where the
    kernels take it, else fp32 (so that check_args refuses t)."""
    return t.dtype if t.dtype in _LAUNCHERS else torch.float32


@functools.lru_cache(maxsize=None)
def fwd_launch_config(N, bf16):
    """(dynamic shared memory in bytes, blocks per SM) of K2 at N keys in
    fp32 or (bf16=True) the bf16 stream, as the built library reports them
    (`ofq_qkr_attention_fwd_launch`; blocks per SM: the CUDA runtime's
    occupancy, registers counted, 0 where the shared memory does not fit
    a block)."""
    blocks = ctypes.c_int()
    fn = _build.load("fused_attention").ofq_qkr_attention_fwd_launch
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    smem = fn(N, int(bf16), ctypes.byref(blocks))
    return smem, blocks.value


def _smem_check(smem, N, what):
    if smem > _MAX_SMEM:
        raise ValueError(
            f"{what}: N={N} keys need {smem} bytes of shared memory per "
            f"block, more than the card's {_MAX_SMEM}")


def _launch(lhs, rhs, v, s, bits, sm_scale, quantize):
    B, N, H, K, d, lhs_shape = _shapes(lhs, rhs, v)
    dt = stream_dtype(v)
    check_args("qkr_attention_fwd", rhs, lhs=(lhs, lhs_shape, dt),
               rhs=(rhs, (B, N, H, K), dt), v=(v, (B, N, H, d), dt),
               s=(s, (N,)))
    lib = _build.load("fused_attention")
    _smem_check(fwd_launch_config(N, dt == torch.bfloat16)[0], N,
                "qkr_attention_fwd")
    fn = getattr(lib, "ofq_qkr_attention_fwd" + _LAUNCHERS[dt])
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    out = torch.empty((B, N, H, d), dtype=dt, device=rhs.device)
    with torch.cuda.device(rhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(lhs.data_ptr(), int(lhs.ndim == 4), rhs.data_ptr(),
                 v.data_ptr(), s.data_ptr(), out.data_ptr(), B, N, H, K, d,
                 float(2 ** bits - 1), float(sm_scale), int(bool(quantize)),
                 stream)
    _build.check(lib, err, "qkr_attention_fwd")
    qkr_attention_fwd.launches += 1
    return out


def qkr_attention_fwd(lhs, rhs, v, s, bits, sm_scale, quantize):
    """The forward kernel's wrapper: a CUDA tensor goes to the CUDA kernel
    (which raises if it cannot build or launch), a CPU tensor to the plain
    version."""
    refuse_graph_cut("qkr_attention_fwd", lhs, rhs, v, s)
    if on_card(rhs):
        return _launch(lhs, rhs, v, s, bits, sm_scale, quantize)
    return qkr_attention_fwd_reference(lhs, rhs, v, s, bits, sm_scale,
                                       quantize)


def bwd_launch_plan(N, bf16):
    """(pass A's dynamic shared memory in bytes, the scratch's row stride,
    pass A's ring stages, pass A's blocks per SM as shared memory and
    threads allow) of K3 at N keys in fp32 or (bf16=True) the bf16 stream:
    the arithmetic of `csrc/fused_attention_bwd.cu` (rows_smem_bytes,
    scratch_ld, the launch export) in Python, for the tests on the CPU;
    `bwd_launch_config` asks the built library, and a card test holds the
    first three equal and the runtime's blocks per SM at most the
    fourth."""
    tq, threads = 64, 256
    # the score tile's ring (csrc/qkr_scores.cuh): 3 stages of 48-byte
    # rows, the 64 query rows and a sweep of 224 keys
    stages, keys, row_bytes = 3, 224, 48

    def ring(rows):
        return stages * (rows + keys) * row_bytes

    if bf16:
        ld_s = -(-N // 32) * 32 + 1
        half = 4 * (tq // 2) * ld_s + 2 * (tq // 2 + 128) * 40
        ldp = -(-N // 8) * 8
    else:
        ld_s = -(-N // 4) * 4
        half = 4 * (tq // 2) * ld_s + ring(tq // 2)
        ldp = ld_s
    smem = 4 * tq * ld_s + max(ring(tq), half)
    return smem, ldp, stages, blocks_per_sm(smem, threads)


@functools.lru_cache(maxsize=None)
def bwd_launch_config(N, bf16):
    """`bwd_launch_plan`'s tuple as the built library reports it
    (`ofq_qkr_attention_bwd_launch`), with pass A's blocks per SM from the
    CUDA runtime's occupancy (registers counted; 0 where its shared memory
    does not fit a block)."""
    ldp, stages, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    fn = _build.load("fused_attention_bwd").ofq_qkr_attention_bwd_launch
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    smem = fn(N, int(bf16), ctypes.byref(ldp), ctypes.byref(stages),
              ctypes.byref(blocks))
    return smem, ldp.value, stages.value, blocks.value


def _launch_bwd(lhs, rhs, v, s, g, bits, sm_scale, quantize):
    B, N, H, K, d, lhs_shape = _shapes(lhs, rhs, v)
    dt = stream_dtype(v)
    check_args("qkr_attention_bwd", rhs, lhs=(lhs, lhs_shape, dt),
               rhs=(rhs, (B, N, H, K), dt), v=(v, (B, N, H, d), dt),
               s=(s, (N,)), g=(g, (B, N, H, d), dt))
    lib = _build.load("fused_attention_bwd")
    smem, ldp = bwd_launch_config(N, dt == torch.bfloat16)[:2]
    _smem_check(smem, N, "qkr_attention_bwd")
    fn = getattr(lib, "ofq_qkr_attention_bwd" + _LAUNCHERS[dt])
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    # the cotangents and the scratch (pq and dscores, exactly the values
    # the products read) in the stream dtype; ds and its partials fp32
    st = dict(dtype=dt, device=rhs.device)
    f32 = dict(dtype=torch.float32, device=rhs.device)
    dlhs = torch.empty(lhs_shape, **st)
    drhs = torch.empty((B, N, H, K), **st)
    dv = torch.empty((B, N, H, d), **st)
    ds = torch.empty((N,), **f32)
    # rows ldp apart: 16-byte rows for the passes' 16-byte copies
    pq_scratch = torch.empty((B, H, N, ldp), **st)
    dsc_scratch = torch.empty((B, H, N, ldp), **st)
    ds_part = torch.empty((B, H, N), **f32)
    with torch.cuda.device(rhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(lhs.data_ptr(), int(lhs.ndim == 4), rhs.data_ptr(),
                 v.data_ptr(), s.data_ptr(), g.data_ptr(), dlhs.data_ptr(),
                 drhs.data_ptr(), dv.data_ptr(), ds.data_ptr(),
                 pq_scratch.data_ptr(), dsc_scratch.data_ptr(),
                 ds_part.data_ptr(), B, N, H, K, d, float(2 ** bits - 1),
                 float(sm_scale), int(bool(quantize)), stream)
    _build.check(lib, err, "qkr_attention_bwd")
    qkr_attention_bwd.launches += 1
    return dlhs, drhs, dv, ds


def qkr_attention_bwd(lhs, rhs, v, s, g, bits, sm_scale, quantize):
    """The backward kernel's wrapper: a CUDA tensor goes to the CUDA kernel
    (which raises if it cannot build or launch), a CPU tensor to the plain
    version.  Returns (dlhs, drhs, dv, ds)."""
    refuse_graph_cut("qkr_attention_bwd", lhs, rhs, v, s, g)
    if on_card(rhs):
        return _launch_bwd(lhs, rhs, v, s, g, bits, sm_scale, quantize)
    return qkr_attention_bwd_reference(lhs, rhs, v, s, g, bits, sm_scale,
                                       quantize)


# launches of the CUDA kernels; the CPU and comparison paths do not count
qkr_attention_fwd.launches = 0
qkr_attention_bwd.launches = 0


class _AttnCore(torch.autograd.Function):
    """The custom VJP of `ofq_tpu.ops.fused_attention._attn_core`: the
    forward kernel, with (lhs, rhs, v, s) kept as residuals, and the
    backward kernel.  `fwd`/`bwd` are the wrappers or their plain
    versions."""

    @staticmethod
    def forward(ctx, lhs, rhs, v, s, bits, sm_scale, quantize, fwd, bwd):
        ctx.save_for_backward(lhs, rhs, v, s)
        ctx.cfg = (bits, sm_scale, quantize, bwd)
        return fwd(lhs, rhs, v, s, bits, sm_scale, quantize)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, v, s = ctx.saved_tensors
        bits, sm_scale, quantize, bwd = ctx.cfg
        dlhs, drhs, dv, ds = bwd(lhs, rhs, v, s, g.contiguous(), bits,
                                 sm_scale, quantize)
        return dlhs, drhs, dv, ds, None, None, None, None, None


def quantized_attention_core(lhs, rhs, v, s, *, bits: int, sm_scale: float,
                             quantize_softmax: bool = True,
                             fwd=qkr_attention_fwd, bwd=qkr_attention_bwd):
    """Port of `ofq_tpu.ops.fused_attention.quantized_attention_core`,
    (B, N, H, d), differentiable in lhs, rhs, v and s (pass s with the
    grad-scale factor already applied).  In the bf16 stream (v bf16) lhs,
    rhs and v go to the kernels in bf16, which round as JAX's bf16 kernels
    do, and the output and the cotangents of lhs, rhs, v are bf16; any
    other v is computed in fp32 and returned in v's dtype.  s is fp32.
    `fwd`/`bwd` are the kernels' wrappers, or their plain versions for
    comparison on the card."""
    dt = torch.bfloat16 if v.dtype == torch.bfloat16 else torch.float32
    args = [t.to(dt).contiguous() for t in (lhs, rhs, v)]
    args.append(s.to(torch.float32).contiguous())
    if needs_grad(*args):
        out = _AttnCore.apply(*args, bits, sm_scale, quantize_softmax, fwd,
                              bwd)
    else:
        out = fwd(*args, bits, sm_scale, quantize_softmax)
    return out.to(v.dtype)
