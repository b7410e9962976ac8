"""The oscillation hook (`make_train_step(oscillation=...)`,
`train/oscillation_hook.py`) and `per_layer_grad_norms` against
`ofq_tpu`, on the CPU, on the `deit_test_distilled` W2A2 QKR student
(tracked: `v_kernel` and the kernels of proj, fc1, fc2):

  * `weight_int_image` and `init_oscillation_states` equal JAX's; JAX's
    `apply_frozen` on an fp64 tree with a frozen kernel: the pinned
    values within 2 fp32 ulps (`PINNED`: the scale in fp32, as JAX's,
    its mean summed in another order), their StatsQ images JAX's, the
    other kernels within 1e-12;
  * three fp64 steps with `oscillation=dict(bits=2, momentum=0.5,
    freeze_threshold=0.4, qk_reparam=True)` (JAX's
    `tests/test_oscillation.py` thresholds) from a seeded mid-run
    tracking state carried from JAX's (`load_oscillation_states`; half
    the entries already past a switch at EMA 0.35, so entries freeze in
    the first steps), without and with CGA (`qk_reparam_type=1`,
    boundary 0.005), each step from JAX's state after the one before
    (carried across by `convert.py`'s loaders: a pinned entry's fp32
    scale is summed in another order, `PINNED`, and would feed every
    leaf of the later steps): after each step the integer images, switch
    directions, frozen masks and frozen integers exactly JAX's, the EMAs
    and `oscillation/ema_mean` within 1e-9, every parameter within 1e-9
    of max(1, |p|) (the LSQ scales 1e-8,
    `test_torch_batchnorm.SCALE_LEAF`; the pinned entries within 2 fp32
    ulps, `PINNED`), entries frozen from the first step on and each
    pinned to its frozen integer's level;
  * one fp32 step with bf16 masters and the hook against JAX's, at
    `test_torch_cga_slice.py`'s bf16-master limits (masters within 2.1 *
    lr plus one bf16 ulp, the loss 2 %, the gradient norm 20 %): the
    frozen masks and integers equal JAX's but where a master differs,
    the working parameters the pinned masters;
  * `per_layer_grad_norms=True`: JAX's keys, each norm within 1e-6 as
    the total's (the LSQ scales' gradients are fp32 sums in both
    frameworks), the squares summing to the total's within 1e-12;
  * `load_oscillation_states` strict both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_batchnorm import SCALE_LEAF, assert_close, family, step_run
from test_torch_cga_slice import CGA, _jax_policy, _port_policy
from test_torch_dropout import x64_jit
from test_torch_port_common import to_jax_tree, to_numpy_tree
from test_torch_train_loop import _flat

from ofq_tpu.models import deit as jdeit
from ofq_tpu.quant.oscillation import OscillationState as JaxOscState
from ofq_tpu.train import oscillation_hook as josc
from ofq_tpu_torch.convert import (load_flax_params, load_optax_adamw_state,
                                   load_oscillation_states)
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.quant import statsq_b4_round
from ofq_tpu_torch.train import oscillation_hook as tosc

NAME = "deit_test_distilled"
OSC = dict(bits=2, momentum=0.5, freeze_threshold=0.4, qk_reparam=True)
TRACKED = 8  # v_kernel, proj, fc1, fc2 in each of the two blocks


def _seeded_states(params, rng):
    """JAX's states at `params`, half the entries past a switch (up or
    down) with their EMA at 0.35: a switch the other way freezes them."""
    out = {}
    for k, st in josc.init_oscillation_states(params, bits=2,
                                              qk_reparam=True).items():
        shape = st.prev_x_int.shape
        half = rng.random(size=shape) < 0.5
        direction = np.where(rng.random(size=shape) < 0.5, -1.0, 1.0)
        out[k] = st._replace(
            prev_switch_dir=jnp.asarray(np.where(half, direction, 0.0),
                                        st.prev_x_int.dtype),
            ema_oscillation=jnp.asarray(np.where(half, 0.35, 0.0),
                                        st.prev_x_int.dtype))
    return out


def _extra(jparams, state):
    """(JAX's seeded extra, the port's carried from it)."""
    jx = {"oscillation": _seeded_states(jparams, np.random.default_rng(8))}
    init = tosc.init_oscillation_states(state.params, bits=2,
                                        qk_reparam=True)
    assert len(init) == TRACKED
    state.extra = {"oscillation": init}
    load_oscillation_states(state, jax.device_get(jx))
    return jx, state.extra


def _assert_states(state, jst, *, ema=1e-9, where=None):
    """The port's tracking state against JAX's: the integer fields exact
    (where `where` holds, when given), the EMAs within `ema`."""
    got, want = state.extra["oscillation"], jst.extra["oscillation"]
    assert set(got) == {k.replace("/", ".") for k in want}
    for k, w in want.items():
        g, w = got[k.replace("/", ".")], w._asdict()
        keep = where(k) if where is not None else None
        for f in ("prev_x_int", "prev_switch_dir", "frozen",
                  "frozen_x_int", "total_oscillation"):
            a, b = getattr(g, f).numpy(), np.asarray(w[f])
            if keep is not None:
                a, b = a[keep], b[keep]
            np.testing.assert_array_equal(a, b, err_msg=f"{k} {f}")
        for f in ("ema_oscillation", "ema_x_int"):
            d = np.abs(getattr(g, f).numpy() - np.asarray(w[f]))
            if keep is not None:
                d = d[keep]
            assert float(d.max(initial=0.0)) <= ema, (k, f)
        assert int(g.iters) == int(w["iters"])


def _pinned_ok(state, bits=2):
    """Every frozen entry's StatsQ image is its frozen integer; returns
    the number of frozen entries."""
    n = 0
    for k, st in state.extra["oscillation"].items():
        img = torch.round(statsq_b4_round(state.params[k].detach(),
                                          bits)[0])
        assert torch.equal(img[st.frozen], st.frozen_x_int[st.frozen]), k
        n += int(st.frozen.sum())
    return n


# a pinned entry: s * ((frozen_x_int + 0.5) / n) with s the fp32 StatsQ
# scale, whose mean both frameworks sum in fp32, in their own orders: one
# fp32 ulp of s apart at most, so 2 fp32 ulps of the value (relative)
PINNED = 2.0 ** -22


def assert_pinned(got, want, what, where=None):
    d, w = np.abs(got - want), np.abs(want)
    if where is not None:
        d, w = d[where], w[where]
    assert np.all(d <= PINNED * w), (what, float((d / np.maximum(
        w, 1e-300)).max(initial=0.0)))


# ---------------------------------------------------------- functions
def test_hook_functions_match_jax():
    _, jpol, tpol = family(NAME)
    jm = jdeit.deit_model(NAME, jpol)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3))
    with x64_jit():
        v = jax.jit(lambda k, xx: jm.init({"params": k}, xx, train=False))(
            jax.random.key(0), jnp.asarray(x))
        params = to_jax_tree(to_numpy_tree(v["params"]), np.float64)
        jstates = josc.init_oscillation_states(params, bits=2,
                                               qk_reparam=True)
        name = "blocks_0/mlp/fc1/kernel"
        st = jstates[name]
        jstates[name] = st._replace(frozen=jnp.ones_like(st.frozen),
                                    frozen_x_int=st.prev_x_int)
        moved = jax.tree.map(lambda a: a * 1.1 + 0.01, params)
        pinned = _flat(to_numpy_tree(josc.apply_frozen(
            params, moved, jstates, bits=2, qk_reparam=True)))
        image = np.asarray(josc.weight_int_image(
            jnp.asarray(pinned["blocks_0.mlp.fc1.kernel"]), 2))
        jstates = jax.device_get(jstates)
    port = create_model(NAME, policy=tpol, device="cpu").double()
    load_flax_params(port, v)
    p = {k: t.detach() for k, t in port.named_parameters()}
    states = tosc.init_oscillation_states(p, bits=2, qk_reparam=True)
    assert len(states) == TRACKED
    for k, st in states.items():
        w = jstates[k.replace(".", "/")]
        np.testing.assert_array_equal(
            tosc.weight_int_image(p[k], 2).numpy(), np.asarray(w.prev_x_int))
        if k != name.replace("/", "."):
            for f, a in st._asdict().items():
                np.testing.assert_array_equal(a.numpy(),
                                              np.asarray(getattr(w, f)))
    ported = {k: JaxOscState(*[torch.from_numpy(np.array(a)) for a in st])
              for k, st in ((k.replace("/", "."), st)
                            for k, st in jstates.items())}
    got = tosc.apply_frozen(p, {k: t * 1.1 + 0.01 for k, t in p.items()},
                            ported, bits=2, qk_reparam=True)
    assert set(got) == set(pinned)
    k = name.replace("/", ".")
    for n, w in pinned.items():
        if n == k:
            assert_pinned(got[n].numpy(), w, n)
            continue
        err = float(np.abs(got[n].numpy() - w).max() / np.abs(w).max())
        assert err <= 1e-12, (n, err)
    np.testing.assert_array_equal(tosc.weight_int_image(got[k], 2).numpy(),
                                  image)
    assert torch.equal(got["blocks_0.mlp.fc2.kernel"],
                       p["blocks_0.mlp.fc2.kernel"] * 1.1 + 0.01)


# ---------------------------------------------------------------- steps
@pytest.mark.parametrize("cga", [False, True])
def test_oscillation_steps_fp64(cga):
    if cga:
        jpol, tpol = _jax_policy(), _port_policy()
        kw = dict(cga=CGA)
    else:
        _, jpol, tpol = family(NAME)
        kw = {}
    seen = []

    def check(state, jst, port):
        """This step against JAX's, then JAX's state carried into the
        port's for the next (`convert.py`'s loaders)."""
        _assert_states(state, jst)
        seen.append(_pinned_ok(state))
        want = _flat(jax.device_get(jst.params["params"]))
        frozen = {k: st.frozen.numpy()
                  for k, st in state.extra["oscillation"].items()}
        for k, p in port.named_parameters():
            got = p.detach().numpy()
            if k in frozen:
                assert_pinned(got, want[k], k, frozen[k])
                got = np.where(frozen[k], want[k], got)
            assert_close(got, want[k],
                         SCALE_LEAF if k.endswith(".s") else 1e-9, k)
        load_flax_params(port, jax.device_get(jst.params))
        load_optax_adamw_state(state, jax.device_get(jst.opt_state[0][0]),
                               step=jst.step)
        load_oscillation_states(state, jax.device_get(jst.extra))

    r = step_run(NAME, jpol, tpol, n=3, lr=2e-3, extra=_extra,
                 step_kw=dict(loss_kind="kd_soft_hard", oscillation=OSC,
                              **kw),
                 after_step=check)
    for i, (met, jmet) in enumerate(zip(r["met"], r["jmet"])):
        assert abs(met["oscillation/ema_mean"]
                   - jmet["oscillation/ema_mean"]) <= 1e-9, i
        assert abs(met["loss"] - jmet["loss"]) <= 1e-9 * abs(jmet["loss"])
    assert len(seen) == 3 and 0 < seen[0] <= seen[-1], seen


def test_bf16_masters_hook_step_fp32():
    _, jpol, tpol = family(NAME)
    lr = 2e-3
    before = {}

    def keep(state, jst):
        before.update({k: p.float().clone() for k, p in state.params.items()})

    r = step_run(NAME, jpol, tpol, dtype=np.float32, lr=lr,
                 master="bfloat16", extra=_extra, before_steps=keep,
                 step_kw=dict(loss_kind="kd_soft_hard", oscillation=OSC))
    state, port, jst = r["state"], r["port"], r["jst"]
    met, jmet = r["met"][0], r["jmet"][0]
    assert abs(met["loss"] - jmet["loss"]) <= 2e-2 * abs(jmet["loss"])
    assert abs(met["grad_norm"] - jmet["grad_norm"]) <= (
        0.2 * jmet["grad_norm"])
    assert all(p.dtype == torch.bfloat16 for p in state.params.values())
    for k, p in port.named_parameters():
        assert torch.equal(p, state.params[k].float()), k
    want = {k: np.asarray(v, np.float32)
            for k, v in _flat(jst.params["params"]).items()}
    got = {k: p.float().numpy() for k, p in state.params.items()}
    same = {}
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert float(d.max()) <= 2.1 * lr + float(
            np.abs(w).max()) * 2.0 ** -7, k
        same[k.replace(".", "/")] = d == 0
    _assert_states(state, jst, ema=0.0, where=lambda k: same[k])
    assert _pinned_ok(state) > 0
    moved = sum(int((before[k] != state.params[k].float()).sum())
                for k in state.params)
    assert moved > 0


def test_per_layer_grad_norms_fp64():
    _, jpol, tpol = family(NAME)
    r = step_run(NAME, jpol, tpol, step_kw=dict(loss_kind="kd_soft_hard",
                                                per_layer_grad_norms=True))
    met, jmet = r["met"][0], r["jmet"][0]
    assert set(met) == set(jmet)
    layers = [k for k in met if k.startswith("grad_norm/")]
    assert {"grad_norm/blocks_0", "grad_norm/cls_token", "grad_norm/head",
            "grad_norm/patch_embed"} <= set(layers)
    for k in layers:
        assert abs(met[k] - jmet[k]) <= 1e-6 * jmet[k], k
    total = sum(met[k] ** 2 for k in layers)
    assert abs(total - met["grad_norm"] ** 2) <= 1e-12 * total


def test_load_oscillation_states_is_strict():
    _, _, tpol = family(NAME)
    port = create_model(NAME, policy=tpol, device="cpu")
    p = dict(port.named_parameters())
    states = tosc.init_oscillation_states(p, bits=2, qk_reparam=True)
    tree = {k.replace(".", "/"): {f: np.asarray(t.numpy())
                                  for f, t in st._asdict().items()}
            for k, st in states.items()}

    class S:
        extra = None

    with pytest.raises(ValueError, match="no oscillation state"):
        load_oscillation_states(S(), {"oscillation": tree})
    s = S()
    s.extra = {"oscillation": states}
    load_oscillation_states(s, {"oscillation": tree})
    assert set(s.extra["oscillation"]) == set(states)
    missing = dict(tree)
    missing.pop("blocks_0/attn/v_kernel")
    with pytest.raises(ValueError, match="missing.*v_kernel"):
        load_oscillation_states(s, {"oscillation": missing})
    extra = {**tree, "blocks_0/attn/q_kernel": tree["blocks_0/attn/v_kernel"]}
    with pytest.raises(ValueError, match="unused.*q_kernel"):
        load_oscillation_states(s, {"oscillation": extra})
    bad = {**tree, "blocks_0/mlp/fc1/kernel": {
        f: a[:1] if a.ndim else a
        for f, a in tree["blocks_0/mlp/fc1/kernel"].items()}}
    with pytest.raises(ValueError, match="shape"):
        load_oscillation_states(s, {"oscillation": bad})
