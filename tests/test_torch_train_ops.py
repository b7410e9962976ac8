"""The kernels' backward passes on the CPU, against the JAX package.

K1: the `_FusedQLinear` autograd Function (plain forward, the closed-form
    backward in torch ops) vs `jax.vjp` of `ofq_tpu.ops.fused_qlinear`
    with its Pallas kernel in interpret mode; all six cotangents, fp32.
K3: `qkr_attention_bwd_reference`, the plain version of the attention
    backward kernel, and the `_AttnCore` Function around it vs `jax.vjp`
    of `ofq_tpu.ops.fused_attention.quantized_attention_core` (interpret).
The repair of the silent graph cut: a kernel launch returns a fresh
tensor with no autograd history, so the wrappers are reached only through
autograd Functions, and a raw wrapper called on a tensor that requires
grad raises.  The card's launch is simulated here by a stand-in that, like
the ctypes launch, returns a detached tensor.
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
from ofq_tpu_torch.nn import QAttentionQKR, QLinear
from ofq_tpu_torch.ops import fused_attention as t_attn
from ofq_tpu_torch.ops import fused_qlinear as t_fq


def _close_share(got, want, tol=1e-4):
    """Share of elements outside tol * (1 + |want|)."""
    return float(np.mean(np.abs(got - want) > tol * (1 + np.abs(want))))


# ----------------------------------------------------------------- K1
K1_NAMES = ("dx", "dkernel", "ds", "db_pre", "db_post", "dbias")


@pytest.mark.parametrize("name,B,N,K,F,all_positive,bits", [
    ("proj_like", 2, 10, 64, 64, False, 2),
    ("fc1_like", 2, 10, 64, 128, False, 2),
    ("fc2_like", 2, 10, 128, 64, True, 2),
    ("w4a4", 2, 10, 64, 32, False, 4),
])
@pytest.mark.parametrize("ties", [False, True])
def test_k1_function_cotangents_match_jax(name, B, N, K, F, all_positive,
                                          bits, ties):
    """fp32 on both sides.  The in-range masks and rounding are computed
    elementwise from the same fp32 values, so they agree exactly; the two
    products and the sums run in other orders, hence rtol 1e-5 and an
    absolute floor of 1e-5 of the cotangent's largest magnitude."""
    args = _qlinear_case(sum(map(ord, name)), B, N, K, F, all_positive,
                         bits, ties)
    g = np.random.default_rng(7).normal(size=(B, N, F)).astype(np.float32)
    kw = dict(w_bits=bits, a_bits=bits, all_positive=all_positive)
    yj, vjp = jax.vjp(lambda *a: jax_fused_qlinear(*a, interpret=True, **kw),
                      *(jnp.asarray(a) for a in args))
    want = [np.asarray(c) for c in vjp(jnp.asarray(g))]
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    yt = t_fq.fused_qlinear(*ts, **kw)
    got = torch.autograd.grad(yt, ts, torch.from_numpy(g))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=1e-6, atol=1e-6)
    for nm, a, b in zip(K1_NAMES, got, want):
        assert a.shape == b.shape, nm
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=nm)
    assert np.abs(want[2]).max() > 0 and np.abs(want[0]).max() > 0


# ----------------------------------------------------------------- K3
@pytest.mark.parametrize("shared_lhs", [True, False])
@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("bits", [2, 4])
def test_k3_plain_matches_pallas(shared_lhs, quantize, bits):
    """The cotangents of the attention core.  Both sides sum in fp32 in
    other orders, and a probability within an ulp of an LSQ boundary can
    fall on either side of it (the K2 precedent): at least 99.9 % of the
    elements of each cotangent within 1e-4 * (1 + |ref|).  With LSQ off,
    ds is exactly zero."""
    lhs, rhs, v, s = _attn_case(10 + bits, shared_lhs)
    g = np.random.default_rng(11).normal(size=v.shape).astype(np.float32)
    kw = dict(bits=bits, sm_scale=0.25, quantize_softmax=quantize)
    _, vjp = jax.vjp(
        lambda *a: jax_attention_core(*a, interpret=True, **kw),
        *(jnp.asarray(a) for a in (lhs, rhs, v, s)))
    want = [np.asarray(c) for c in vjp(jnp.asarray(g))]
    tl, tr, tv, tsc, tg = (torch.from_numpy(a) for a in (lhs, rhs, v, s, g))
    plain = t_attn.qkr_attention_bwd_reference(tl, tr, tv, tsc, tg, bits,
                                               0.25, quantize)
    ts = [t.clone().requires_grad_() for t in (tl, tr, tv, tsc)]
    before = t_attn.qkr_attention_bwd.launches
    out = t_attn.quantized_attention_core(*ts, **kw)
    via_fn = torch.autograd.grad(out, ts, tg)
    assert t_attn.qkr_attention_bwd.launches == before
    for nm, a, b, c in zip(("dlhs", "drhs", "dv", "ds"), plain, via_fn,
                           want):
        assert a.shape == c.shape == b.shape, nm
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=nm)
        assert _close_share(a.numpy(), c) <= 1e-3, nm
    if quantize:
        assert np.abs(want[3]).max() > 0
        np.testing.assert_allclose(plain[3].numpy(), want[3], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[3]).max())
    else:
        assert not plain[3].any() and not np.any(want[3])


def test_k3_ds_skips_nothing_below_eps():
    """ds is not masked where the scale was floored at 1e-5 (s[0] = 1e-7
    in the case), as in JAX: the floored row still gets its cotangent."""
    lhs, rhs, v, s = _attn_case(3, True)
    g = np.random.default_rng(4).normal(size=v.shape).astype(np.float32)
    ds = t_attn.qkr_attention_bwd_reference(
        *(torch.from_numpy(a) for a in (lhs, rhs, v, s, g)), 2, 0.25,
        True)[3]
    assert s[0] < 1e-5 and float(ds[0]) != 0.0


# ------------------------------------------- the repair: no silent cut
def _detached(fn):
    """A stand-in for a kernel launch on the card: the same values, no
    autograd history (what ctypes on `data_ptr()` returns)."""
    def launch(*args):
        with torch.no_grad():
            out = fn(*args)
        return (tuple(o.detach().clone() for o in out)
                if isinstance(out, tuple) else out.detach().clone())
    return launch


@pytest.fixture
def simulated_card(monkeypatch):
    """Every wrapper takes its 'CUDA' branch on CPU tensors."""
    for mod in (t_fq, t_attn):
        monkeypatch.setattr(mod, "on_card", lambda t: True)
    monkeypatch.setattr(t_fq, "_launch",
                        _detached(t_fq.fused_qlinear_fwd_reference))
    monkeypatch.setattr(t_attn, "_launch",
                        _detached(t_attn.qkr_attention_fwd_reference))
    monkeypatch.setattr(t_attn, "_launch_bwd",
                        _detached(t_attn.qkr_attention_bwd_reference))


def _pair(cls, *args, fused_kw, **kw):
    """A fused module and a composed twin with the same seeded weights."""
    fused = cls(*args, **fused_kw, **kw)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for name, p in fused.named_parameters():
            if name.endswith(".s"):
                p.copy_(torch.from_numpy(
                    rng.uniform(0.2, 0.6, size=p.shape)))
            else:
                p.copy_(torch.from_numpy(rng.normal(size=p.shape) * 0.3))
    composed = cls(*args, **kw)
    composed.load_state_dict(fused.state_dict())
    return fused, composed


def _grads(mod, x):
    x = x.clone().requires_grad_()
    out = x + mod(x)
    params = dict(mod.named_parameters())
    grads = torch.autograd.grad(out.sum() + (out ** 2).sum(),
                                [x] + list(params.values()),
                                allow_unused=True)
    return dict(zip(["x"] + list(params), grads))


def test_old_glue_cut_the_graph(simulated_card, monkeypatch):
    """The hazard the repair removes: the forward glue of the serving
    slice called the wrapper directly, so on the card the layer's output
    had no history and every parameter upstream got no gradient."""
    monkeypatch.setattr(t_fq, "refuse_graph_cut", lambda *a: None)
    fused, _ = _pair(QLinear, 16, 16, 5, weight_bits=2, input_bits=2,
                     fused_kw=dict(matmul_impl="fused"))
    x = torch.randn(2, 5, 16).requires_grad_()

    def old_glue(x):  # the former `fused_qlinear`, outside any Function
        a_lo, a_hi = t_fq.thresholds(2, False)
        x2, s_eff, n_tok = t_fq._prep(x, fused.input_quant.s)
        w = fused.kernel.to(torch.float32)
        sw = t_fq.statsq_scale(w)
        bvec = fused.move_aft.bias @ t_fq._wq_value(w, sw, 2.0) + fused.bias
        y2 = t_fq.fused_qlinear_fwd(x2, s_eff, n_tok, fused.move_b4.bias,
                                    w, sw, bvec, a_lo, a_hi, 2.0)
        return y2.reshape(2, 5, 16)

    y = old_glue(x)
    assert y.grad_fn is None
    (x.sum() + y.sum()).backward()
    assert fused.kernel.grad is None and fused.input_quant.s.grad is None


def test_fused_qlinear_gradients_equal_composed(simulated_card):
    """After the repair: the fused QLinear's gradients equal the composed
    path's (fp32, rtol 1e-4 and an absolute floor of 1e-5 * max(1, max|g|):
    the closed-form backward sums in another order than autograd through
    the composition, and a gradient that cancels to ~0 keeps fp32 noise)."""
    fused, composed = _pair(QLinear, 16, 16, 5, weight_bits=2, input_bits=2,
                            fused_kw=dict(matmul_impl="fused"))
    x = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(1))
    gf, gc = _grads(fused, x), _grads(composed, x)
    assert set(gf) == set(gc)
    for k in gc:
        assert gf[k] is not None and gc[k] is not None, k
        assert gc[k].abs().max() > 0, k
        torch.testing.assert_close(
            gf[k], gc[k], rtol=1e-4,
            atol=1e-5 * max(1.0, float(gc[k].abs().max())), msg=k)


def test_fused_attention_gradients_equal_composed(simulated_card):
    """The same for QKR attention with the fused core (K2 forward, K3
    backward) and the fused proj; the composed twin runs every product
    through autograd.  fp32, with the QLinear test's tolerance; at this
    small size no attention probability lies near an LSQ boundary (the
    K2 precedent's flip)."""
    C, H, N = 12, 3, 6
    fused, composed = _pair(
        QAttentionQKR, C, H, N, weight_bits=2, input_bits=2,
        fused_kw=dict(matmul_impl="fused", attn_impl="fused"))
    x = torch.randn(2, N, C, generator=torch.Generator().manual_seed(2))
    before = t_attn.qkr_attention_bwd.launches
    gf, gc = _grads(fused, x), _grads(composed, x)
    assert t_attn.qkr_attention_bwd.launches == before  # the stand-in
    for k in gc:
        assert gf[k] is not None and gc[k] is not None, k
        torch.testing.assert_close(
            gf[k], gc[k], rtol=1e-4,
            atol=1e-5 * max(1.0, float(gc[k].abs().max())), msg=k)
    assert gc["quan_softmax.s"].abs().max() > 0
    assert gc["q_kernel"].abs().max() > 0


def test_raw_wrappers_refuse_grad_inputs(simulated_card):
    """A raw wrapper on a tensor that requires grad, with grad mode on,
    raises instead of returning a tensor with no history; under
    torch.no_grad() it launches."""
    args = list(_qlinear_case(1, 2, 4, 16, 8, False, 2))
    x, w, s, b_pre, _, bias = (torch.from_numpy(a) for a in args)
    x2 = x.reshape(-1, 16).requires_grad_()
    sw = t_fq.statsq_scale(w)
    k1 = (x2, s, 4, b_pre, w, sw, bias, -2, 1, 2.0)
    with pytest.raises(RuntimeError, match="requires grad"):
        t_fq.fused_qlinear_fwd(*k1)
    with torch.no_grad():
        assert t_fq.fused_qlinear_fwd(*k1).shape == (8, 8)
    lhs, rhs, v, s2 = (torch.from_numpy(a) for a in _attn_case(1, True))
    g = torch.ones_like(v)
    for fn, a in ((t_attn.qkr_attention_fwd, (lhs, rhs, v, s2)),
                  (t_attn.qkr_attention_bwd, (lhs, rhs, v, s2, g))):
        grad_args = [t.clone().requires_grad_() for t in a]
        with pytest.raises(RuntimeError, match="requires grad"):
            fn(*grad_args, 2, 0.25, True)
        with torch.no_grad():
            fn(*grad_args, 2, 0.25, True)
