"""Full-LSQ weights (`--wq-mode lsq`) and the pieces around them, against
`ofq_tpu`, on the CPU.

  * `policy_from_args` field by field, for the flags of
    `train_scripts/deit_s/w2a2_deit_s.sh` and `swin_t/w2a2_swin_t.sh` with
    `--qk_reparam` dropped and with `--wq-mode lsq`, and the port's recipe
    helpers equal to it;
  * `LsqWeight` (per column and per tensor, signed and unsigned),
    `LsqLinear` and the full-LSQ `QMlp` in fp64 with the limits of
    `test_torch_train_layers.py` (output, dx, every parameter's gradient);
  * the frozen integer core of a full-LSQ kernel: the codes rebuilt from
    the restored scale bit-equal to JAX's (`frozen_lsq_weight_int`) and to
    the live quantizer's, the frozen `LsqLinear` forward in fp32 to 1e-6
    of max|ref| (both sum the int product exactly and run the epilogue in
    fp32, in other orders);
  * the oscillation state (`init_oscillation_state`, `track_oscillation`,
    `oscillation_metrics`) and `LsqWeightIterativeFreezing` over six
    training forwards whose weights swing across levels, the state carried
    from JAX's `oscillation` collection by `load_flax_params`: outputs and
    every state field exactly equal in fp64; an eval forward pins the
    frozen codes; a training forward that may not update the state
    raises;
  * a Swin under a full-LSQ policy builds JAX's tree (StatsQ linears);
  * one step of the full-LSQ `deit_test_distilled` student, composed in
    fp64 (`test_torch_kd_telemetry.assert_step`'s limits) and fused
    (per-head K2 and K3) in fp32 (`test_torch_qattention.py`'s).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dropout import _jitted_init
from test_torch_kd_telemetry import _jax_deit_policy, assert_step, step_case
from test_torch_port_common import (  # noqa: F401 (jax_interpret: fixture)
    jax_interpret, to_jax_tree, to_numpy_tree, x64)
from test_torch_train_layers import C, N, _check_grads_fp64, _tokens
from test_torch_train_loop import _flat
from test_torch_train_slice import LR, START

from ofq_tpu.models import swin as jswin
from ofq_tpu.nn import linear as jlin
from ofq_tpu.nn import quantizers as jquant
from ofq_tpu.ops import int8_qlinear as jint8
from ofq_tpu.quant import default_deit_qmodules, default_swin_qmodules
from ofq_tpu.quant import oscillation as josc
from ofq_tpu.quant import policy_from_args as jax_policy_from_args
from ofq_tpu_torch.convert import flatten_flax_tree, load_flax_params
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.nn import (LsqLinear, LsqWeight,
                              LsqWeightIterativeFreezing, QMlp)
from ofq_tpu_torch.ops import int8_qlinear as tint8
from ofq_tpu_torch.quant import (policy_from_args, w2a2_deit_policy,
                                 w2a2_swin_policy)
from ofq_tpu_torch.quant import oscillation as tosc
from ofq_tpu_torch.train import cosine_with_warmup_cooldown

W2A2 = dict(wq_enable=True, wq_mode="statsq", wq_bitw=2, wq_per_channel=True,
            aq_enable=True, aq_mode="lsq", aq_bitw=2, aq_per_channel=True,
            aq_learnable=True, qk_reparam_type=0)


# ---------------------------------------------------------------- policy
@pytest.mark.parametrize("family", ["deit", "swin"])
@pytest.mark.parametrize("variant", [dict(qk_reparam=False),
                                     dict(qk_reparam=False, wq_mode="lsq"),
                                     dict(qk_reparam=True),
                                     dict(qk_reparam=False, wq_mode="lsq",
                                          wq_asym=True, wq_learnable=True)])
def test_policy_from_args(family, variant):
    mods = (default_deit_qmodules(12) if family == "deit"
            else default_swin_qmodules())
    flags = dict(W2A2, **variant, qmodules=mods)
    want = jax_policy_from_args(**flags)
    got = policy_from_args(**flags)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert got.lsq_weights == want.lsq_weights
    if "wq_asym" not in variant:
        helper = w2a2_deit_policy if family == "deit" else w2a2_swin_policy
        assert helper(**variant) == got
    with pytest.raises(ValueError, match="wq_asym"):
        policy_from_args(**dict(flags, wq_mode="statsq", wq_asym=True))


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("per_channel,all_positive", [
    (True, False), (False, False), (True, True)])
def test_lsq_weight(per_channel, all_positive):
    w = np.random.default_rng(50).normal(size=(C, 16)) * 0.2
    jm = jquant.LsqWeight(bit=2, per_channel=per_channel,
                          all_positive=all_positive)
    tm = LsqWeight(2, 16, per_channel=per_channel, all_positive=all_positive)
    _check_grads_fp64(jm, tm, w, names=())


@pytest.mark.parametrize("symmetric,asym", [(True, False), (False, False),
                                            (True, True)])
def test_lsq_linear(symmetric, asym):
    x = _tokens(51, positive=not symmetric)
    kw = dict(weight_bits=2, input_bits=2, symmetric=symmetric,
              wq_all_positive=asym)
    _, _, gj = _check_grads_fp64(jlin.LsqLinear(16, **kw),
                                 LsqLinear(C, 16, N, **kw), x)
    assert np.abs(gj["weight_quant.s"]).max() > 0


def test_lsq_linear_scale_not_learnable():
    kw = dict(weight_bits=2, input_bits=2, wq_learnable=False)
    _, _, gj = _check_grads_fp64(jlin.LsqLinear(16, **kw),
                                 LsqLinear(C, 16, N, **kw), _tokens(52))
    assert not np.any(gj["weight_quant.s"])


def test_qmlp_full_lsq():
    kw = dict(weight_bits=2, input_bits=2, lsq_weights=True)
    _check_grads_fp64(jlin.QMlp(hidden_features=48, out_features=C, **kw),
                      QMlp(C, 48, C, N, **kw), _tokens(53))


@pytest.mark.parametrize("symmetric", [True, False])
def test_frozen_lsq_int8(symmetric):
    """The frozen integer core: codes from the restored scale."""
    rng = np.random.default_rng(54)
    s_w = (rng.random(16) * 0.1 + 0.05).astype(np.float32)
    k = rng.integers(-2, 2, size=(C, 16)).astype(np.float32)
    w_q = (s_w * k).astype(np.float32)  # `deploy._lsq_decode`'s levels
    codes_j, col_j = jint8.frozen_lsq_weight_int(jnp.asarray(w_q),
                                                 jnp.asarray(s_w))
    codes_t, col_t = tint8.frozen_lsq_weight_int(torch.from_numpy(w_q),
                                                 torch.from_numpy(s_w))
    assert np.array_equal(codes_t.numpy(), np.asarray(codes_j))
    assert np.array_equal(codes_t.numpy(), k)
    assert np.array_equal(col_t.numpy(), np.asarray(col_j))
    assert tint8.lsq_int8_eligible(8, 2) and not tint8.lsq_int8_eligible(
        8, 2, w_all_positive=True)
    x = _tokens(55, positive=not symmetric).astype(np.float32)
    kw = dict(weight_bits=32, input_bits=2, symmetric=symmetric,
              frozen_int_bits=2)
    jm = jlin.LsqLinear(16, **kw)
    v = to_numpy_tree(jm.init({"params": jax.random.key(0)},
                              jnp.asarray(x)))
    v["params"]["kernel"] = w_q
    v["params"]["weight_quant"]["s"] = s_w
    v["params"]["bias"] = rng.normal(size=16).astype(np.float32)
    want = np.asarray(jm.apply(to_jax_tree(v, np.float32), jnp.asarray(x)))
    tm = load_flax_params(LsqLinear(C, 16, N, **kw), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        tm.use_kernels = False  # the plain product: the same bits
        assert np.array_equal(tm(torch.from_numpy(x)).numpy(), got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


# ------------------------------------------------------------ oscillation
def _swings(seed, steps=6, shape=(C, 8)):
    """Kernels that swing across LSQ levels step by step."""
    rng = np.random.default_rng(seed)
    w0 = rng.normal(size=shape) * 0.3
    d = rng.normal(size=shape) * 0.15
    return [w0 + (-1) ** t * d + 0.01 * t for t in range(steps)]


def test_oscillation_functions():
    rng = np.random.default_rng(56)
    xs = [np.round(rng.normal(size=(5, 4)) * 2) for _ in range(6)]
    with x64():
        js = josc.init_oscillation_state(jnp.asarray(xs[0]))
        ts = tosc.init_oscillation_state(torch.from_numpy(xs[0]))
        for x in xs[1:]:
            jx, js = josc.track_oscillation(jnp.asarray(x), js, momentum=0.3,
                                            freeze_threshold=0.2)
            tx, ts = tosc.track_oscillation(torch.from_numpy(x), ts,
                                            momentum=0.3,
                                            freeze_threshold=0.2)
            assert np.array_equal(tx.numpy(), np.asarray(jx))
            for f in josc.OscillationState._fields:
                assert np.array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f))), f
        assert np.asarray(js.frozen).any()
        jm, tm = josc.oscillation_metrics(js), tosc.oscillation_metrics(ts)
    assert set(jm) == set(tm)
    for k in jm:
        assert float(tm[k]) == float(jm[k]), k


def test_lsq_weight_iterative_freezing():
    ws = _swings(57)
    kw = dict(bit=2, freeze_momentum=0.3, freeze_threshold=0.2)
    jm = jquant.LsqWeightIterativeFreezing(**kw)
    tm = LsqWeightIterativeFreezing(2, ws[0].shape, freeze_momentum=0.3,
                                    freeze_threshold=0.2).double()
    with x64():
        # fp64 under x64; `frozen` stays bool and `iters` int32
        v = to_numpy_tree(jm.init({"params": jax.random.key(0)},
                                  jnp.asarray(ws[0])))
    load_flax_params(tm, v)
    assert set(flatten_flax_tree(v)) == {
        "params/s", *(f"oscillation/state/{f}"
                      for f in josc.OscillationState._fields)}
    for w in ws[1:]:
        with x64():
            yj, upd = jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(w),
                               training=True, mutable=["oscillation"])
            v = {**v, **to_numpy_tree(upd)}
        wt = torch.from_numpy(w).requires_grad_()
        yt = tm(wt, training=True)
        yt.sum().backward()
        assert wt.grad is not None
        assert np.array_equal(yt.detach().numpy(), np.asarray(yj))
        state = tm.oscillation_state()
        for f in josc.OscillationState._fields:
            assert np.array_equal(
                getattr(state, f).numpy(),
                np.asarray(v["oscillation"]["state"]._asdict()[f])), f
    assert state.frozen.any()
    with x64():
        ye = jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(ws[0]))
    with torch.no_grad():
        assert np.array_equal(tm(torch.from_numpy(ws[0])).numpy(),
                              np.asarray(ye))
    tm.track = False
    with pytest.raises(ValueError, match="mutable"):
        tm(torch.from_numpy(ws[0]), training=True)


# ------------------------------------------------------------- the models
def test_swin_under_lsq_policy_builds_jax_tree():
    """JAX's Swin reads no `lsq_weights`: a full-LSQ policy builds the
    StatsQ linears, and the port's tree is JAX's."""
    depths = (1, 1)
    jpol = jax_policy_from_args(**dict(W2A2, wq_mode="lsq",
                                       qk_reparam=False),
                                qmodules=default_swin_qmodules(depths))
    x = np.zeros((1, 32, 32, 3))
    v = _jitted_init(jswin.swin_model("swin_test", jpol, depths=depths), x)
    tm = create_model("swin_test", policy=w2a2_swin_policy(
        depths, qk_reparam=False, wq_mode="lsq"), device="cpu",
        depths=depths)
    load_flax_params(tm, v)  # strict both ways
    # LSQ weights only in the pinned W8 head and patch embedding
    assert not any("weight_quant" in k and "features_" in k
                   for k in flatten_flax_tree(v))


def test_full_lsq_deit_step_fp64():
    met, jmet, port, jparams = step_case(
        _jax_deit_policy(qk_reparam=False, wq_mode="lsq"),
        w2a2_deit_policy(2, qk_reparam=False, wq_mode="lsq"))
    assert_step(met, jmet, port, jparams)
    assert type(port.blocks_0.mlp.fc1).__name__ == "LsqLinear"


def test_full_lsq_fused_step_fp32(jax_interpret):
    conf = dict(matmul_impl="fused", attn_impl="fused")
    met, jmet, port, jparams = step_case(
        _jax_deit_policy(qk_reparam=False, wq_mode="lsq"),
        w2a2_deit_policy(2, qk_reparam=False, wq_mode="lsq"), conf=conf,
        dtype=np.float32)
    assert abs(met["loss"] - jmet["loss"]) <= 1e-5 * abs(jmet["loss"])
    assert abs(met["grad_norm"] - jmet["grad_norm"]) <= (
        1e-5 * jmet["grad_norm"])
    lr = cosine_with_warmup_cooldown(5e-3, **LR)(START)
    got = {k: p.detach().numpy() for k, p in port.named_parameters()}
    for k, w in _flat(jparams).items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2.1 * lr, k
        assert np.mean(d > 1e-3 * lr + 1e-6 * np.abs(w)) <= 0.01, k
