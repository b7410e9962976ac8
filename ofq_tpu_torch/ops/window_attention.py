"""The Swin window-attention tail per (window, head) unit (port of the
three Pallas kernels of `benchmarks/window_attn_lab.py`, the lab bench of
this tail at Swin-T stage 0).

    s   = (q k^T with fp32 sums) * d^-1/2          (fp32)
    p   = e / sum(e), e = exp(s - max s)          (fp32), rounded to bf16
    out = p v with fp32 sums, rounded to bf16

for every window b and head h, on q, k, v, out of shape (Bn, 49, H, 32),
bf16, in the natural layout of the Swin attention.  Three kernels compute
this one function (`csrc/window_attention.cu`), each with its lab
parameters:

    K6  window_attn_units(q, k, v, WB=16)                 `pallas_units`
    K7  window_attn_packed(q, k, v, WB=16, P=None)        `pallas_packed`
    K8  window_attn_packed_aligned(q, k, v, WB=16, P=4)   `pallas_packed_aligned`

WB windows per thread block (Bn % WB == 0), P units per pass through
shared memory (K7: H when None; (WB * H) % P == 0).  The wrappers check
these constraints, and bf16, n = 49, d = 32, on every device; then a CUDA
tensor goes to the kernel and a CPU tensor to the plain version
`window_attn_tail_reference`.  They have no backward (the lab kernels
have none): called on a tensor that requires grad, with grad mode on,
they raise.  The Swin models do not call them: their tail also adds the
relative-position bias and the shift mask.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_attention import _MAX_SMEM, on_card, refuse_graph_cut

N_TOKENS, HEAD_DIM = 49, 32
_VARIANT = {"window_attn_units": 0, "window_attn_packed": 1,
            "window_attn_packed_aligned": 2}


def window_attn_tail_reference(q, k, v):
    """Plain PyTorch version of K6-K8: fp32 einsum, times d^-1/2 in fp32,
    fp32 softmax (e / sum e), p rounded to bf16, fp32 einsum with v, the
    output rounded to bf16."""
    scale = float(torch.tensor(q.shape[-1] ** -0.5, dtype=torch.float32))
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = (e / torch.sum(e, dim=-1, keepdim=True)).to(torch.bfloat16)
    out = torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float())
    return out.to(torch.bfloat16)


def _check(what, q, k, v, WB, P):
    """The lab's constraints; raise ValueError on anything else."""
    refuse_graph_cut(what, q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dtype != torch.bfloat16 or t.ndim != 4
                or t.shape != q.shape or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(
                f"{what}: {name} must be a contiguous bfloat16 tensor "
                f"(Bn, {N_TOKENS}, H, {HEAD_DIM}) like q {tuple(q.shape)} on "
                f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    Bn, n, H, d = q.shape
    if n != N_TOKENS or d != HEAD_DIM:
        raise ValueError(f"{what}: the kernels take windows of {N_TOKENS} "
                         f"tokens and heads of {HEAD_DIM}, got n={n}, d={d}")
    if WB < 1 or Bn % WB:
        raise ValueError(f"{what}: WB={WB} must divide Bn={Bn}")
    if P < 1 or (WB * H) % P:
        raise ValueError(f"{what}: P={P} must divide WB*H={WB * H}")


def _launch(what, q, k, v, WB, P):
    lib = _build.load("window_attention")
    smem_fn = lib.ofq_window_attn_smem
    smem_fn.restype = ctypes.c_longlong
    smem_fn.argtypes = [ctypes.c_int] * 3
    Bn, _, H, d = q.shape
    smem = smem_fn(_VARIANT[what], H, P)
    if smem > _MAX_SMEM:
        raise ValueError(f"{what}: H={H}, P={P} needs {smem} bytes of shared "
                         f"memory per block, more than the card's {_MAX_SMEM}")
    for t in (q, k, v):
        # 16-byte vector accesses (K8) and 4-byte rows (all)
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be 16-byte aligned")
    fn = getattr(lib, f"ofq_{what}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 Bn, H, WB, P, d ** -0.5, stream)
    _build.check(lib, err, what)
    return out


def _run(fn, q, k, v, WB, P):
    what = fn.__name__
    _check(what, q, k, v, WB, P)
    if not on_card(q):
        return window_attn_tail_reference(q, k, v)
    out = _launch(what, q, k, v, WB, P)
    fn.launches += 1
    return out


def window_attn_units(q, k, v, WB=16):
    """K6: WB windows per block, one window's H units per pass."""
    return _run(window_attn_units, q, k, v, WB, q.shape[2])


def window_attn_packed(q, k, v, WB=16, P=None):
    """K7: P units per pass (H when None), padded to 64 tokens, packed."""
    return _run(window_attn_packed, q, k, v, WB, P or q.shape[2])


def window_attn_packed_aligned(q, k, v, WB=16, P=4):
    """K8: as K7, each unit's operands in their own aligned tile."""
    return _run(window_attn_packed_aligned, q, k, v, WB, P)


# launches of the CUDA kernels; the CPU and comparison paths do not count
for _fn in (window_attn_units, window_attn_packed,
            window_attn_packed_aligned):
    _fn.launches = 0
