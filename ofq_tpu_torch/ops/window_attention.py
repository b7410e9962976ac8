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
shared memory (K7: H when None; (WB * H) % P == 0).  K6 also takes the
lab's ablation switches (`do_scores`, `do_softmax`, `do_out`) in the three
forms the lab runs, timing probes that replace the q k^T product, the
softmax or the p v product (`window_attn_units_reference`); each form
counts its own launches.  All three run on the tensor cores; K6 loads its
units by TMA.  The wrappers check these constraints, and bf16, n = 49,
d = 32 and 16-byte aligned operands, on every device; then a CUDA tensor
goes to the kernel and a CPU tensor to the plain version.  They have no backward (the lab kernels
have none): called on a tensor that requires grad, with grad mode on,
they raise.  The Swin models do not call them: their tail also adds the
relative-position bias and the shift mask.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .fused_attention import (_MAX_SMEM, blocks_per_sm, on_card,
                              refuse_graph_cut)

N_TOKENS, HEAD_DIM = 49, 32
_VARIANT = {"window_attn_units": 0, "window_attn_packed": 1,
            "window_attn_packed_aligned": 2}
# K6's forms, (do_scores, do_softmax, do_out) -> the name of an ablation in
# the lab's VARIANTS (`units16_<name>`; the full tail: None)
_FORMS = {(True, True, True): None,
          (False, True, False): "nodots",
          (True, False, True): "nosm",
          (True, False, False): "scoresonly"}
ABLATIONS = tuple(name for name in _FORMS.values() if name)


def form_flags(do_scores=True, do_softmax=True, do_out=True):
    """K6's launcher flags of a form: do_scores | do_softmax << 1 | do_out
    << 2 (the full tail 7, nodots 2, nosm 5, scoresonly 1)."""
    return int(do_scores) | int(do_softmax) << 1 | int(do_out) << 2


def window_attn_units_reference(q, k, v, do_scores=True, do_softmax=True,
                                do_out=True):
    """Plain PyTorch version of K6 in each form; with the three switches on,
    the tail of K6-K8: fp32 einsum, times d^-1/2 in fp32, fp32 softmax
    (e / sum e), p rounded to bf16, fp32 einsum with v, the output rounded
    to bf16.  The lab's ablations (`_mk_kernel`): without do_scores,
    s[b, h, i, j] = q[b, i, h, 0] for every key j, not scaled; without
    do_softmax, p = s in fp32; without do_out, out[b, i, h, c] = p[b, h, i,
    c] for c < d, rounded to bf16."""
    Bn, n, H, d = q.shape
    if do_scores:
        scale = float(torch.tensor(d ** -0.5, dtype=torch.float32))
        s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    else:
        s = q[..., 0].float().transpose(1, 2)[..., None].expand(Bn, H, n, n)
    if do_softmax:
        e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
        p = e / torch.sum(e, dim=-1, keepdim=True)
    else:
        p = s
    if do_out:
        out = torch.einsum("bhnm,bmhd->bnhd",
                           p.to(torch.bfloat16).float(), v.float())
    else:
        out = p[..., :d].transpose(1, 2)
    return out.to(torch.bfloat16)


def window_attn_tail_reference(q, k, v):
    """Plain PyTorch version of K6-K8 (`window_attn_units_reference` with
    every switch on)."""
    return window_attn_units_reference(q, k, v)


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
    for t in (q, k, v):
        # 16-byte copies: K6's TMA boxes, K7's and K8's cp.async
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be 16-byte aligned")


# the library's C functions with their ctypes signatures, set once
_FNS: dict = {}


def _lib_fn(name, restype, argtypes):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("window_attention"), name)
        fn.restype, fn.argtypes = restype, argtypes
        _FNS[name] = fn
    return fn


def launch_plan(what, H, P):
    """(dynamic shared memory in bytes, ring stages, warps, blocks per SM as
    shared memory and threads allow) of one block of kernel `what` (a
    wrapper's name) at H heads and P units per pass (K6: H): the arithmetic
    of `csrc/window_attention.cu` (units_launch, tc_launch) in Python, for
    the tests on the CPU; `launch_config` asks the built library, and a card
    test holds the first three equal and the runtime's blocks per SM at
    most the fourth."""
    max_warps = 16
    if what == "window_attn_units":
        # two stages of 3 H swizzled 4096-byte unit buffers, 1024 bytes to
        # align them (the barriers inside)
        stages, units = 2, H
        smem = stages * 3 * H * 64 * 32 * 2 + 1024
    else:
        units = P
        stage = 3 * P * 64 * (32 if what == "window_attn_packed" else 40) * 2
        stages = 2 if 2 * 2 * stage <= _MAX_SMEM else 1
        smem = stages * stage
    warps = min(4 * units, max_warps)
    return smem, stages, warps, blocks_per_sm(smem, 32 * warps)


@functools.lru_cache(maxsize=None)
def launch_config(what, H, P, flags=7):
    """`launch_plan`'s tuple as the built library reports it
    (`ofq_window_attn_launch`), with the blocks per SM of the kernel
    instance launched (K6: in form `flags`, `form_flags`'s encoding) from
    the CUDA runtime's occupancy (registers counted; 0 where its shared
    memory does not fit a block)."""
    stages, warps, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = _lib_fn("ofq_window_attn_launch", ctypes.c_longlong,
                   [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3)(
        _VARIANT[what], flags, H, P, ctypes.byref(stages),
        ctypes.byref(warps), ctypes.byref(blocks))
    return smem, stages.value, warps.value, blocks.value


def _launch(what, q, k, v, WB, P, flags):
    Bn, _, H, d = q.shape
    smem = launch_config(what, H, P)[0]
    if smem > _MAX_SMEM:
        raise ValueError(f"{what}: H={H}, P={P} needs {smem} bytes of shared "
                         f"memory per block, more than the card's {_MAX_SMEM}")
    # K6: (..., Bn, H, WB, sm, flags, stream); K7, K8: (..., Bn, H, WB, P,
    # sm, stream)
    ints = [Bn, H, WB] if flags is not None else [Bn, H, WB, P]
    tail = [flags] if flags is not None else []
    fn = _lib_fn(f"ofq_{what}", ctypes.c_int,
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * len(ints)
                 + [ctypes.c_float] + [ctypes.c_int] * len(tail)
                 + [ctypes.c_void_p])
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *ints, d ** -0.5, *tail, stream)
    _build.check(_build.load("window_attention"), err, what)
    return out


def window_attn_units(q, k, v, WB=16, do_scores=True, do_softmax=True,
                      do_out=True):
    """K6: WB windows per block, one window's H units per pass, loaded by
    TMA into a swizzled two-stage ring, on the tensor cores; in the full
    form or one of the lab's three ablations (`ABLATIONS`: nodots =
    do_scores and do_out off, nosm = do_softmax off, scoresonly =
    do_softmax and do_out off), each counted on its own
    (`window_attn_units.launches`, `FORM_LAUNCHES[name].launches`)."""
    what = "window_attn_units"
    form = (bool(do_scores), bool(do_softmax), bool(do_out))
    if form not in _FORMS:
        raise ValueError(
            f"{what}: do_scores={form[0]}, do_softmax={form[1]}, "
            f"do_out={form[2]} is none of the lab's forms (the full tail, "
            f"{', '.join(ABLATIONS)})")
    _check(what, q, k, v, WB, q.shape[2])
    if not on_card(q):
        return window_attn_units_reference(q, k, v, *form)
    name = _FORMS[form]
    out = _launch(what, q, k, v, WB, q.shape[2], form_flags(*form))
    if name is None:
        window_attn_units.launches += 1
    else:
        FORM_LAUNCHES[name].launches += 1
    return out


def _run(fn, q, k, v, WB, P):
    what = fn.__name__
    _check(what, q, k, v, WB, P)
    if not on_card(q):
        return window_attn_tail_reference(q, k, v)
    out = _launch(what, q, k, v, WB, P, None)
    fn.launches += 1
    return out


def window_attn_packed(q, k, v, WB=16, P=None):
    """K7: P units per pass (H when None), each unit's rows packed densely
    (64 bytes, swizzled), on the tensor cores."""
    return _run(window_attn_packed, q, k, v, WB, P or q.shape[2])


def window_attn_packed_aligned(q, k, v, WB=16, P=4):
    """K8: as K7, each of a unit's rows in its own aligned 80-byte slot."""
    return _run(window_attn_packed_aligned, q, k, v, WB, P)


class _FormCount:
    """The launch count of one of K6's ablation forms, counted like a
    wrapper's under the name `window_attn_units_<form>`."""

    def __init__(self, form):
        self.__name__ = f"window_attn_units_{form}"
        self.launches = 0


# launches of the CUDA kernels; the CPU and comparison paths do not count
window_attn_units.launches = 0
window_attn_packed.launches = 0
window_attn_packed_aligned.launches = 0
FORM_LAUNCHES = {name: _FormCount(name) for name in ABLATIONS}
