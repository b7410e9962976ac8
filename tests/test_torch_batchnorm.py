"""The LN->BN swap (`norm_layer='batchnorm'`, the reference's
--replace-ln-by-bn) against `ofq_tpu`, on the CPU, at `deit_test_distilled`
and `swin_test` size, from the same converted variables with seeded
running statistics (mean N(0, 0.1), var 1 + U(0, 0.5)):

  * `BatchNorm` alone on a 4-D map, fp32 statistics and an fp64 input:
    the output and the promoted fp64 statistics within 1e-12 of JAX's
    `TorchBatchNorm`'s;
  * fp64 forward: the W2A2 QKR students' logits within 1e-9 relative in
    train mode (batch statistics) and eval mode (running statistics); the
    running statistics after one train forward within 1e-12 of max(1,
    |JAX's|), in fp64 as JAX's under x64; the LSQ scales `calibrate` sets
    (the model in train mode) within 1e-12 relative of Flax's lazy
    re-init with `train=False` (`jax_calibrate`'s, jitted), the running
    statistics untouched;
  * one fp64 step each of a BN DeiT, a BN Swin and a BN DeiT under
    `remat=True` against JAX's jitted `make_train_step` (JAX's remat
    step), at `test_torch_kd_telemetry.py`'s limits (loss 1e-9 relative,
    gradient norm 1e-6, every parameter 1e-9 of max(1, its largest
    magnitude), but the LSQ scales 1e-8: `SCALE_LEAF`), the running
    statistics to the parameters' limit;
  * the step under `remat=True` bit for bit the step without it, running
    statistics included: they move once per step;
  * `make_eval_step` on the BN student, with its parameters and with an
    EMA's, against JAX's eval step on the full variables;
    `Predictor.from_flax_npz` on a BN student's `.npz` (params,
    batch_stats, quant_stats) against JAX's fp32 probabilities within
    1e-5; the loader is strict about `batch_stats`.

`step_run` (n steps of both frameworks from one start, with the step's
options) serves `test_torch_oscillation_hook.py` and
`test_torch_mlp_acts.py`.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cga_slice import _jax_state
from test_torch_dropout import x64_jit
from test_torch_kd_telemetry import _jax_deit_policy
from test_torch_port_common import (perturb, to_jax_tree, to_numpy_tree,
                                    without_scales)
from test_torch_swin_model import _jax_policy as _jax_swin_policy
from test_torch_swin_model import _with_head
from test_torch_train_loop import _flat, _mid_run_adam
from test_torch_train_slice import LR, START, _batches, _with_heads

from ofq_tpu.models import deit as jdeit
from ofq_tpu.models import swin as jswin
from ofq_tpu.train import make_eval_step as jax_make_eval_step
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu.train import make_train_step as jax_make_train_step
from ofq_tpu.train import schedule as jschedule
from ofq_tpu_torch.calibrate import calibrate
from ofq_tpu_torch.convert import (flatten_flax_tree, load_flax_params,
                                   load_optax_adamw_state)
from ofq_tpu_torch.models import BatchNorm, create_model
from ofq_tpu_torch.quant import (QuantPolicy, w2a2_deit_policy,
                                 w2a2_qkr_swin_policy)
from ofq_tpu_torch.serve import Predictor
from ofq_tpu_torch.train import (TrainState, constant_lr, make_eval_step,
                                 make_optimizer, make_train_step)
from ofq_tpu_torch.train import schedule as tschedule

NAME, SWIN = "deit_test_distilled", "swin_test"
BN = dict(norm_layer="batchnorm")


def family(name):
    """(JAX constructor, JAX policy, port policy) of the W2A2 QKR
    student `name`."""
    if name == SWIN:
        return (jswin.swin_model, _jax_swin_policy((1, 1)),
                w2a2_qkr_swin_policy((1, 1)))
    return jdeit.deit_model, _jax_deit_policy(), w2a2_deit_policy(2)


def _images(seed, n=4):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3))


def with_stats(variables, rng):
    """Seeded running statistics in place of the init's (0, 1)."""
    if "batch_stats" not in variables:
        return variables

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else (
            rng.normal(size=v.shape) * 0.1 if k == "mean"
            else 1.0 + rng.random(size=v.shape) * 0.5).astype(v.dtype)
            for k, v in tree.items()}
    return {**variables, "batch_stats": draw(variables["batch_stats"])}


def _init(jm, x, dtype=np.float64):
    """Variables from a jitted float32 init (the LSQ scales set from `x`),
    in `dtype`."""
    v = jax.jit(lambda k, xx: jm.init({"params": k}, xx, train=False))(
        jax.random.key(0), jnp.asarray(x, jnp.float32))
    return to_numpy_tree(v, dtype)


def start(name, jpol, tpol, *, conf=None, dtype=np.float64):
    """The JAX student and teacher, their variables (random shifts and
    heads, seeded running statistics) and the port's student and teacher
    loaded from them."""
    conf = conf or {}
    make = jswin.swin_model if name == SWIN else jdeit.deit_model
    extra = dict(depths=(1, 1)) if name == SWIN else {}
    jm, jt = make(name, jpol, **conf, **extra), make(name, **extra)
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3))
    variables = (_with_head if name == SWIN else _with_heads)(
        _init(jm, x, dtype), np.random.default_rng(3))
    variables = with_stats(variables, np.random.default_rng(6))
    tvars = perturb(_init(jt, x, dtype), np.random.default_rng(4),
                    scale=0.1)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    port = create_model(name, policy=tpol, device="cpu", **conf,
                        **extra).to(tdt)
    load_flax_params(port, variables)
    teacher = create_model(name, policy=QuantPolicy(), device="cpu",
                           **extra).to(tdt)
    load_flax_params(teacher, tvars["params"])
    return jm, jt, variables, tvars, port, teacher


def step_run(name, jpol, tpol, *, conf=None, n=1, dtype=np.float64, lr=None,
             master=None, step_kw=None, extra=None, before_steps=None,
             after_step=None):
    """`n` steps of the port and of JAX's jitted `make_train_step` from the
    same start and mid-run Adam state on seeded batches (x64 on for fp64):
    `lr` a constant learning rate (default: the cosine schedule at
    START), `master` 'bfloat16' for bf16 masters, `step_kw` both steps'
    options, `extra(jax params, port state)` -> (JAX extra, port extra)
    for the states' `extra`; `before_steps(port state, JAX state)` runs
    once before the first step, `after_step(port state, JAX state, port
    model)` after each.  Returns dict(met, jmet: each step's
    metrics; port, state, jst: the port's model and state, JAX's state
    after the steps)."""
    step_kw = step_kw or {}
    jm, jt, variables, tvars, port, teacher = start(name, jpol, tpol,
                                                    conf=conf, dtype=dtype)
    mu, nu = _mid_run_adam(variables["params"], np.random.default_rng(5))

    def sched(lib):
        return (lib.constant_lr(lr) if lr is not None else
                lib.cosine_with_warmup_cooldown(5e-3, **LR))

    opt = make_optimizer(sched(tschedule), weight_decay=0.05)
    tx = jax_make_optimizer(sched(jschedule), weight_decay=0.05)
    state = TrainState.create(port, opt, master_dtype=master)
    load_optax_adamw_state(state, {"count": START, "mu": mu, "nu": nu},
                           step=START)
    step = make_train_step(port, opt, teacher=teacher, device="cpu",
                           master_dtype=master, **step_kw)
    jstep = jax.jit(jax_make_train_step(jm, tx, teacher=jt,
                                        master_dtype=master, **step_kw))
    out = dict(met=[], jmet=[], port=port)
    with x64_jit() if dtype == np.float64 else contextlib.nullcontext():
        jst = _jax_state(tx, variables, mu, nu, dtype,
                         masters=jnp.bfloat16 if master else None)
        if extra is not None:
            jx, state.extra = extra(jst.params["params"], state)
            jst = jst.replace(extra=jx)
        if before_steps is not None:
            before_steps(state, jst)
        tparams = to_jax_tree(tvars, dtype)["params"]
        for i, batch in enumerate(_batches(n, dtype)):
            jst, jmet = jstep(jst, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                              jax.random.key(i), tparams)
            out["jmet"].append({k: float(v) for k, v in jmet.items()})
            state, met = step(state, batch)
            out["met"].append({k: float(v) for k, v in met.items()})
            if after_step is not None:
                after_step(state, jst, port)
        out["jst"] = jax.tree.map(np.asarray, jax.device_get(jst))
    out["state"] = state
    return out


def assert_close(got, want, limit, what):
    err = float(np.abs(np.asarray(got) - want).max()) / max(
        1.0, float(np.abs(want).max()))
    assert err <= limit, (what, err)


def assert_stats(port, stats, limit):
    """The port's running statistics against JAX's `batch_stats`, in its
    dtype."""
    want = _flat(stats)
    got = {k: v for k, v in port.named_buffers() if k in want}
    assert set(got) == set(want) and want
    for k, w in want.items():
        assert str(got[k].dtype) == f"torch.{np.asarray(w).dtype}", k
        assert_close(got[k].detach().numpy(), w, limit, k)


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("name", [NAME, SWIN])
@pytest.mark.parametrize("train", [True, False])
def test_bn_forward_fp64(name, train):
    make, jpol, tpol = family(name)
    jm, _, variables, _, port, _ = start(name, jpol, tpol, conf=BN)
    assert sum(isinstance(m, BatchNorm) for m in port.modules()) == (
        5 if name == NAME else 7)
    x = _images(1)
    with x64_jit():
        v = to_jax_tree(variables, np.float64)
        fn = jax.jit(lambda vv, xx: jm.apply(
            vv, xx, train=train, mutable=["batch_stats", "quant_stats"]))
        (want, _), upd = fn(v, jnp.asarray(x))
        want = jax.tree.map(np.asarray, want)
        upd = jax.tree.map(np.asarray, upd)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    got, want = ((got, want) if isinstance(got, tuple)
                 else ((got,), (want,)))
    for g, w in zip(got, want):
        assert np.abs(w).max() > 1e-3
        err = float(np.abs(g.numpy() - w).max() / np.abs(w).max())
        assert err <= 1e-9, err
    # train: the running statistics after one forward; eval: unchanged
    assert_stats(port, upd["batch_stats"], 1e-12)
    if not train:
        assert_stats(port, variables["batch_stats"], 0.0)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_module_promotes_fp32_stats(train):
    """`BatchNorm` alone against JAX's `TorchBatchNorm` on a 4-D map (a
    Swin patch merging's shape: statistics over the first three axes)
    with fp32 parameters and statistics and an fp64 input under x64: the
    output in fp64 and, in train mode, the running statistics promoted to
    fp64 as JAX's, within 1e-12 (eval mode: left in fp32)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 3, 5, 8)) * 2.0 + 0.5
    f32 = np.float32
    v = {"params": {"scale": (1 + 0.1 * rng.normal(size=8)).astype(f32),
                    "bias": (0.1 * rng.normal(size=8)).astype(f32)},
         "batch_stats": {"mean": (0.1 * rng.normal(size=8)).astype(f32),
                         "var": (1 + 0.5 * rng.random(size=8)).astype(f32)}}
    jm = jdeit.TorchBatchNorm(use_running_average=not train)
    with x64_jit():
        y, upd = jax.jit(lambda vv, xx: jm.apply(
            vv, xx, mutable=["batch_stats"]))(
            jax.tree.map(jnp.asarray, v), jnp.asarray(x))
        y, upd = np.asarray(y), jax.device_get(upd)
    bn = BatchNorm(8)
    load_flax_params(bn, v)
    bn.train(train)
    with torch.no_grad():
        got = bn(torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), y, rtol=1e-12, atol=1e-12)
    assert_stats(bn, upd["batch_stats"], 1e-12)


@pytest.mark.parametrize("name", [NAME, SWIN])
def test_bn_calibration_fp64(name):
    """`calibrate` in train mode normalizes with the running statistics
    and updates nothing, as JAX's `train=False` init."""
    make, jpol, tpol = family(name)
    jm, _, variables, _, port, _ = start(name, jpol, tpol, conf=BN)
    x = _images(2)
    with x64_jit():
        v = to_jax_tree(variables, np.float64)
        pruned = {**v, "params": to_jax_tree(
            without_scales(variables["params"]), np.float64)}
        _, new = jax.jit(lambda vv, xx: jm.apply(
            vv, xx, train=False, mutable=["params"],
            rngs={"params": jax.random.key(0)}))(pruned, jnp.asarray(x))
        want = {"params": to_numpy_tree(new["params"])}
    with torch.no_grad():
        for n, p in port.named_parameters():
            if n.endswith(".s"):
                p.fill_(1.0)
    port.train()
    calibrate(port, x)
    got = dict(port.named_parameters())
    scales = {k: v for k, v in _flat(want["params"]).items()
              if k.endswith(".s")}
    assert len(scales) > 10
    for k, w in scales.items():
        err = float(np.abs(got[k].detach().numpy() - w).max()
                    / np.abs(w).max())
        assert err <= 1e-12, (k, err)
    assert_stats(port, variables["batch_stats"], 0.0)


# ---------------------------------------------------------------- steps
# the LSQ scales' limit: their gradients are fp32 sums in both frameworks
# (`quant/lsq.py:_LsqFused`), so Adam moves them by a rounding the fp64
# leaves do not see; the trajectory tests' limit for that cause
# (`test_torch_swin_train.py`; measured 1.0e-9 at the BN Swin's head
# scale, 1.8e-10 at the LN one's, every other leaf <= 2.1e-11)
SCALE_LEAF = 1e-8


def assert_step_and_stats(r, *, leaf=1e-9):
    met, jmet = r["met"][0], r["jmet"][0]
    assert abs(met["loss"] - jmet["loss"]) <= 1e-9 * abs(jmet["loss"])
    assert abs(met["grad_norm"] - jmet["grad_norm"]) <= (
        1e-6 * jmet["grad_norm"])
    want = _flat(r["jst"].params["params"])
    got = {k: p.detach().numpy() for k, p in r["port"].named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        assert_close(got[k], w, SCALE_LEAF if k.endswith(".s") else leaf, k)
    if "batch_stats" in r["jst"].params:
        assert_stats(r["port"], r["jst"].params["batch_stats"], leaf)


@pytest.mark.parametrize("name,remat", [(NAME, False), (SWIN, False),
                                        (NAME, True)])
def test_bn_step_fp64(name, remat):
    make, jpol, tpol = family(name)
    conf = dict(BN, remat=True) if remat else BN
    r = step_run(name, jpol, tpol, conf=conf, step_kw=dict(
        loss_kind="kd_soft_hard"))
    assert_step_and_stats(r)


def test_bn_remat_step_is_the_plain_step_bit_for_bit():
    """The same BN DeiT step with and without `remat=True`: parameters and
    running statistics bit-equal; the statistics moved once, from the
    step's one train forward."""
    _, jpol, tpol = family(NAME)
    _, _, variables, tvars, _, teacher = start(NAME, jpol, tpol, conf=BN)
    batch = _batches(1)[0]
    out = []
    for remat in (False, True):
        port = create_model(NAME, policy=tpol, device="cpu", remat=remat,
                            **BN).double()
        load_flax_params(port, variables)
        opt = make_optimizer(constant_lr(1e-2), weight_decay=0.05)
        state = TrainState.create(port, opt)
        step = make_train_step(port, opt, teacher=teacher, device="cpu")
        step(state, batch)
        out.append(dict(port.state_dict()))
    for k, v in out[0].items():
        assert torch.equal(v, out[1][k]), k
    # once: the running statistics of a single train forward from the start
    port = create_model(NAME, policy=tpol, device="cpu", **BN).double()
    load_flax_params(port, variables)
    port.train()
    with torch.no_grad():
        port(torch.from_numpy(batch["image"]))
    for k, v in port.named_buffers():
        if k.endswith((".mean", ".var")):
            assert torch.equal(v, out[1][k]), k


# ------------------------------------------------------- eval, serving
def test_bn_eval_step_and_ema_match_jax():
    """`make_eval_step` on the BN student, with its parameters and with an
    EMA's (the running statistics the model's), against JAX's eval step
    on the full variables."""
    _, jpol, tpol = family(NAME)
    jm, _, variables, _, port, _ = start(NAME, jpol, tpol, conf=BN,
                                         dtype=np.float32)
    rng = np.random.default_rng(9)
    batch = {"image": _images(3, 8).astype(np.float32),
             "label": rng.integers(0, 1000, size=8)}
    ema = jax.tree.map(lambda p: p + 0.01 * rng.normal(size=p.shape).astype(
        p.dtype), variables["params"])
    jstep = jax.jit(jax_make_eval_step(jm))
    step = make_eval_step(port)
    for params, port_params in ((variables["params"], None),
                                (ema, {k: torch.from_numpy(np.asarray(v))
                                       for k, v in _flat(ema).items()})):
        want = jstep({**variables, "params": params},
                     {k: jnp.asarray(v) for k, v in batch.items()})
        got = step(port_params, batch)
        for k in ("correct1", "correct5", "count"):
            assert int(got[k]) == int(want[k]), k
        assert abs(float(got["loss_sum"]) - float(want["loss_sum"])) <= (
            1e-5 * abs(float(want["loss_sum"])))


def test_bn_predictor_from_flax_npz_and_strict_loading(tmp_path):
    _, jpol, tpol = family(NAME)
    jm, _, variables, _, _, _ = start(NAME, jpol, tpol, conf=BN,
                                      dtype=np.float32)
    path = tmp_path / "bn.npz"
    np.savez(path, **flatten_flax_tree(variables))
    pred = Predictor.from_flax_npz(str(path), model_name=NAME, policy=tpol,
                                   batch_size=4, device="cpu", **BN)
    x = _images(4, 3).astype(np.float32)
    logits, _ = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
        to_jax_tree(variables, np.float32), jnp.asarray(x))
    want = np.asarray(jax.nn.softmax(logits, axis=-1))
    np.testing.assert_allclose(pred.predict(x), want, atol=1e-5, rtol=0)
    no_stats = {k: v for k, v in variables.items() if k != "batch_stats"}
    with pytest.raises(ValueError, match="missing.*norm1.mean"):
        load_flax_params(create_model(NAME, policy=tpol, device="cpu", **BN),
                         no_stats)
    with pytest.raises(ValueError, match="unused.*norm1.mean"):
        load_flax_params(create_model(NAME, policy=tpol, device="cpu"),
                         variables)
