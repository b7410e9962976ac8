"""The fused kernels' plain versions in the bf16 stream against the JAX
package's Pallas kernels in interpret mode, on the same inputs (seeded
numpy arrays rounded to bf16).

K2-bf16 / K3-bf16: `qkr_attention_fwd_reference` and
`qkr_attention_bwd_reference` with bf16 lhs, rhs, v (and g), through
`quantized_attention_core` and its autograd Function, against
`ofq_tpu.ops.fused_attention.quantized_attention_core` and its `jax.vjp`;
shared and per-head lhs, LSQ on and off.  Both sides widen the bf16
operands exactly, sum in fp32 (in other orders) and round at the same
places, so an output or cotangent element may differ from JAX's only
where the two fp32 sums round to bf16 on either side of a boundary (one
bf16 ulp, 2^-7 of the larger magnitude) or where a probability within an
fp32 ulp of an LSQ boundary falls on the other side: at least 99.9 % of
the elements within one bf16 ulp plus 1e-5 * (1 + |ref|), as in the fp32
tests of `test_torch_port_ops.py` and `test_torch_train_ops.py`.  ds is
fp32 on both sides: rtol 1e-4 with a floor of 1e-4 of its largest entry.

K1 with a bf16 x (`fused_qlinear`): the kernel runs in fp32 on both sides
and y is rounded to bf16 once, so y and dx agree within one bf16 ulp plus
the fp32 tests' 1e-6 (y) and 1e-5 of the largest |dx| (dx); the fp32
cotangents with the fp32 test's rtol 1e-5 and a floor of 1e-5 of their
largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_ops import _attn_case, _qlinear_case

from ofq_tpu.ops.fused_attention import \
    quantized_attention_core as jax_attention_core
from ofq_tpu.ops.fused_qlinear import fused_qlinear as jax_fused_qlinear
from ofq_tpu_torch.ops import fused_attention as t_attn
from ofq_tpu_torch.ops import fused_qlinear as t_fq

BF16_ULP = 2.0 ** -7


def _bf16(*arrays):
    """Seeded fp32 arrays rounded to bf16: (jax bf16, torch bf16) pairs."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
        out.append((jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _share_outside(got, want, atol=1e-5):
    """Share of elements farther apart than one bf16 ulp of the larger
    magnitude plus atol * (1 + |want|)."""
    a, b = _np(got), _np(want)
    lim = BF16_ULP * np.maximum(np.abs(a), np.abs(b)) + atol * (1 + np.abs(b))
    return float(np.mean(np.abs(a - b) > lim))


def _attn_bf16_case(seed, shared_lhs):
    lhs, rhs, v, s = _attn_case(seed, shared_lhs)
    return _bf16(lhs, rhs, v), s


@pytest.mark.parametrize("shared_lhs", [True, False])
@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("bits", [2, 4])
def test_k2_bf16_plain_matches_pallas(shared_lhs, quantize, bits):
    ops, s = _attn_bf16_case(20 + bits, shared_lhs)
    kw = dict(bits=bits, sm_scale=0.25, quantize_softmax=quantize)
    oj = jax_attention_core(*(j for j, _ in ops), jnp.asarray(s),
                            interpret=True, **kw)
    before = t_attn.qkr_attention_fwd.launches
    ot = t_attn.quantized_attention_core(*(t for _, t in ops),
                                         torch.from_numpy(s), **kw)
    assert t_attn.qkr_attention_fwd.launches == before
    assert oj.dtype == jnp.bfloat16 and ot.dtype == torch.bfloat16
    assert ot.shape == oj.shape
    assert _share_outside(ot, oj) <= 1e-3
    # the wrapper's CPU branch is the plain version itself
    direct = t_attn.qkr_attention_fwd(*(t for _, t in ops),
                                      torch.from_numpy(s), bits, 0.25,
                                      quantize)
    torch.testing.assert_close(direct, ot, rtol=0, atol=0)


@pytest.mark.parametrize("shared_lhs", [True, False])
@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("bits", [2, 4])
def test_k3_bf16_plain_matches_pallas(shared_lhs, quantize, bits):
    """The cotangents through `_AttnCore` in bf16: dlhs, drhs and dv in
    bf16, ds in fp32, as JAX's custom VJP returns them."""
    ops, s = _attn_bf16_case(30 + bits, shared_lhs)
    (gj, gt), = _bf16(np.random.default_rng(31).normal(
        size=ops[2][1].shape).astype(np.float32))
    kw = dict(bits=bits, sm_scale=0.25, quantize_softmax=quantize)
    _, vjp = jax.vjp(lambda *a: jax_attention_core(*a, interpret=True, **kw),
                     *(j for j, _ in ops), jnp.asarray(s))
    want = vjp(gj)
    ts = [t.clone().requires_grad_() for _, t in ops]
    ts.append(torch.from_numpy(s).requires_grad_())
    before = t_attn.qkr_attention_bwd.launches
    out = t_attn.quantized_attention_core(*ts, **kw)
    got = torch.autograd.grad(out, ts, gt)
    assert t_attn.qkr_attention_bwd.launches == before
    plain = t_attn.qkr_attention_bwd_reference(
        *(t.detach() for t in ts), gt, bits, 0.25, quantize)
    for nm, a, p, w in zip(("dlhs", "drhs", "dv"), got, plain, want):
        assert a.dtype == p.dtype == torch.bfloat16, nm
        assert w.dtype == jnp.bfloat16 and a.shape == w.shape, nm
        torch.testing.assert_close(a, p, rtol=0, atol=0, msg=nm)
        assert _share_outside(a, w) <= 1e-3, nm
    ds, ds_j = got[3], _np(want[3])
    assert ds.dtype == torch.float32
    if quantize:
        assert np.abs(ds_j).max() > 0
        np.testing.assert_allclose(ds.numpy(), ds_j, rtol=1e-4,
                                   atol=1e-4 * np.abs(ds_j).max())
    else:
        assert not ds.any() and not np.any(ds_j)


def test_k2_bf16_rounds_pq_before_v():
    """pq = bf16(fp32(uq * s_n)) feeds the product with v: with v the
    one-hot keys, out[n, h, m] is that value exactly (here s_n are not
    bf16 numbers, so the rounding shows), and not the unrounded fp32
    level."""
    case = _attn_case(9, True)
    lhs, rhs = _bf16(*case[:2])
    s = case[3]
    B, N, H, _ = rhs[1].shape
    eye = np.zeros((B, N, H, N), np.float32)
    for m in range(N):
        eye[:, m, :, m] = 1.0
    v = torch.from_numpy(eye).to(torch.bfloat16)
    out = t_attn.qkr_attention_fwd_reference(lhs[1], rhs[1], v,
                                             torch.from_numpy(s), 2, 0.25,
                                             True)
    scores = torch.einsum("bnk,bmhk->bhnm", lhs[1].float(),
                          rhs[1].float()) * 0.25
    p = t_attn.softmax(scores)
    s_row = torch.clamp_min(torch.from_numpy(s), 1e-5)[None, None, :, None]
    pq = torch.round(torch.clamp(p / s_row, 0.0, 3.0)) * s_row
    want = pq.to(torch.bfloat16).permute(0, 2, 1, 3)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert (pq.permute(0, 2, 1, 3) != out.float()).any()


def test_core_keeps_fp32_off_the_bf16_path():
    """An fp32 stream still computes in fp32 and returns fp32; only a bf16
    v selects the bf16 kernels."""
    lhs, rhs, v, s = (torch.from_numpy(a) for a in _attn_case(5, True))
    out = t_attn.quantized_attention_core(lhs, rhs, v, s, bits=2,
                                          sm_scale=0.25)
    want = t_attn.qkr_attention_fwd_reference(lhs, rhs, v, s, 2, 0.25, True)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("name,B,N,K,F,all_positive,bits", [
    ("proj_like", 2, 10, 64, 64, False, 2),
    ("fc2_like", 2, 10, 128, 64, True, 2),
    ("w4a4", 2, 10, 64, 32, False, 4),
])
def test_k1_bf16_x_matches_jax(name, B, N, K, F, all_positive, bits):
    """`fused_qlinear` with x in the bf16 stream: JAX casts x to fp32
    before its kernel and y back to bf16 after it, and returns dx in bf16;
    the port does the same around K1."""
    x, *rest = _qlinear_case(sum(map(ord, name)), B, N, K, F, all_positive,
                             bits, ties=True)
    (xj, xt), = _bf16(x)
    (gj, gt), = _bf16(np.random.default_rng(8).normal(
        size=(B, N, F)).astype(np.float32))
    kw = dict(w_bits=bits, a_bits=bits, all_positive=all_positive)
    yj, vjp = jax.vjp(lambda *a: jax_fused_qlinear(*a, interpret=True, **kw),
                      xj, *(jnp.asarray(a) for a in rest))
    want = vjp(gj)
    ts = [xt.clone().requires_grad_()] + [
        torch.from_numpy(a).requires_grad_() for a in rest]
    yt = t_fq.fused_qlinear(*ts, **kw)
    got = torch.autograd.grad(yt, ts, gt)
    assert yt.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    assert _share_outside(yt, yj, atol=1e-6) == 0.0
    assert got[0].dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    dx_j = _np(want[0])
    assert _share_outside(got[0], dx_j,
                          atol=1e-5 * float(np.abs(dx_j).max())) == 0.0
    for i, (a, b) in enumerate(zip(got[1:], want[1:]), 1):
        b = _np(b)
        assert a.dtype == torch.float32 and a.shape == b.shape, i
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()))
