"""K6-K8, the Swin window-attention tail kernels: the port's plain version
`window_attn_tail_reference` against the lab's Pallas kernel bodies
(`benchmarks/window_attn_lab.py`), run here through `pl.pallas_call` in
interpret mode, on seeded bf16 inputs at the lab's unit shape (n = 49,
H = 3, d = 32) with Bn = 32 windows; and the wrappers' checks.

The lab's own wrappers ask for the TPU's VMEM (no interpret mode on the
CPU), so each test builds the call itself, at the lab's grid and blocks.
Both sides round p and the output to bf16 after fp32 arithmetic in other
orders (and XLA's exp is not torch's), so now and then a value lands on
the other side of a bf16 rounding boundary: an output element by one ulp
of itself, or a probability p_m, which moves a whole output row by up to
2^-8 p_m |v_m| (many ulps of an output near 0).  So the gate of
`chip_smoke.py` and `test_torch_port_cuda.py` (`tail_within_gate`):
every element within 2^-7 max(|y|, |ref|) + 2^-8 sum_m p_m |v_m|, and at
most 0.1 % of the elements differing at all (measured: 6 to 28 of
150 528).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_port_cuda import tail_within_gate

from ofq_tpu_torch.ops import window_attention as wa

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))
import window_attn_lab as lab  # noqa: E402

BN = 32


def _qkv(seed=0, Bn=BN):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(Bn, lab.n, lab.H, lab.d)).astype(np.float32)
            for _ in range(3)]


def _lab_call(kernel, WB, q, k, v):
    Bn = q.shape[0]
    spec = pl.BlockSpec((WB, lab.n, lab.H, lab.d), lambda b: (b, 0, 0, 0))
    out = pl.pallas_call(
        kernel, grid=(Bn // WB,), in_specs=[spec, spec, spec],
        out_specs=spec, interpret=True,
        out_shape=jax.ShapeDtypeStruct(q.shape, jnp.bfloat16),
    )(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    return np.asarray(out.astype(jnp.float32))


def _check_against_lab(kernel, WB):
    q, k, v = _qkv()
    want = torch.from_numpy(_lab_call(kernel, WB, q, k, v).copy()).to(
        torch.bfloat16)
    qkv = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = wa.window_attn_tail_reference(*qkv)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    ok, worst, share = tail_within_gate(got, want, *qkv)
    assert ok, (worst, share)
    assert float(got.float().abs().max()) > 0.1  # a non-trivial output


@pytest.mark.parametrize("WB", [16, 32])
def test_reference_matches_lab_units(WB):
    """K6 (`pallas_units`, lab WB 16 and 64: here the 32 windows allow 16
    and 32)."""
    _check_against_lab(lab._mk_kernel(), WB)


@pytest.mark.parametrize("P", [3, 12])
def test_reference_matches_lab_packed(P):
    """K7 (`pallas_packed`, WB 16)."""
    _check_against_lab(lab._mk_packed_kernel(P), 16)


@pytest.mark.parametrize("P", [4, 8])
def test_reference_matches_lab_packed_aligned(P):
    """K8 (`pallas_packed_aligned`, WB 16)."""
    _check_against_lab(lab._mk_packed_aligned_kernel(P), 16)


def test_reference_is_the_composed_tail():
    """The plain version is the lab's XLA tail (`xla_tail`) in fp32 up to
    the two bf16 roundings: within 2^-8 relative of the fp64 attention."""
    q, k, v = _qkv(1)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = wa.window_attn_tail_reference(qb, kb, vb).double()
    q64, k64, v64 = (t.double() for t in (qb, kb, vb))
    s = torch.einsum("bnhd,bmhd->bhnm", q64, k64) * lab.SM
    p = torch.softmax(s, dim=-1)
    want = torch.einsum("bhnm,bmhd->bnhd", p, v64)
    lim = 2 ** -8 * (torch.einsum("bhnm,bmhd->bnhd", p, v64.abs())
                     + want.abs())
    assert bool(((got - want).abs() <= lim).all())


WRAPPERS = [
    (wa.window_attn_units, {}),
    (wa.window_attn_packed, {}),
    (wa.window_attn_packed_aligned, {}),
]


@pytest.mark.parametrize("fn,kw", WRAPPERS)
def test_wrapper_on_cpu_is_the_plain_version(fn, kw):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(2))
    before = fn.launches
    torch.testing.assert_close(fn(q, k, v, **kw),
                               wa.window_attn_tail_reference(q, k, v),
                               rtol=0, atol=0)
    assert fn.launches == before  # no kernel launched on the CPU


def _bad_cases():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(3))
    return {
        "dtype": ((q.float(), k, v), {}, "bfloat16"),
        "n": ((q[:, :48].contiguous(), k[:, :48].contiguous(),
               v[:, :48].contiguous()), {}, "49 tokens"),
        "d": ((q[..., :16].contiguous(), k[..., :16].contiguous(),
               v[..., :16].contiguous()), {}, "heads of 32"),
        "shape": ((q, k[:16], v), {}, "like q"),
        "layout": ((q.transpose(0, 1).contiguous().transpose(0, 1), k, v),
                   {}, "contiguous"),
        "WB": ((q, k, v), {"WB": 5}, "WB=5"),
    }


@pytest.mark.parametrize("fn,kw", WRAPPERS)
@pytest.mark.parametrize("case", ["dtype", "n", "d", "shape", "layout",
                                  "WB"])
def test_wrappers_refuse_what_the_kernels_do_not_take(fn, kw, case):
    args, extra, msg = _bad_cases()[case]
    with pytest.raises(ValueError, match=msg):
        fn(*args, **{**kw, **extra})


@pytest.mark.parametrize("fn", [wa.window_attn_packed,
                                wa.window_attn_packed_aligned])
def test_wrappers_refuse_a_P_that_does_not_divide(fn):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(4))
    with pytest.raises(ValueError, match="P=5"):
        fn(q, k, v, WB=16, P=5)


@pytest.mark.parametrize("fn,kw", WRAPPERS)
def test_wrappers_refuse_a_grad_input(fn, kw):
    """No backward (the lab kernels have none): a grad-requiring input
    under grad mode raises instead of cutting the graph."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(5))
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(q.requires_grad_(), k, v, **kw)
    with torch.no_grad():
        fn(q, k, v, **kw)


@pytest.mark.parametrize("fn,kw", WRAPPERS)
def test_wrappers_refuse_a_misaligned_base(fn, kw):
    """16-byte copies (K6's TMA boxes, K7's and K8's cp.async) need 16-byte
    aligned operands, checked on every device: a base 2 bytes off is
    refused; a slice that starts at a window boundary (9408 bytes a window)
    is aligned and runs."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(14))
    flat = torch.zeros(q.numel() + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + q.numel()].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(shifted, k, v, **kw)
    window = lab.n * lab.H * lab.d
    buf = torch.zeros(q.numel() + window, dtype=torch.bfloat16)
    sliced = buf[window:].view(q.shape)
    sliced.copy_(q)
    torch.testing.assert_close(fn(sliced, k, v, **kw), fn(q, k, v, **kw),
                               rtol=0, atol=0)
