"""The train step's options against `ofq_tpu.train`, on the CPU:
`constant_lr`; gradient clipping (`norm`, `value`, `agc`) against optax's
transforms and `adaptive_grad_clip` in fp64, with a quantized and with a
float head for AGC's `exclude_head`, alone and chained before AdamW;
`ema_update`; `dampening_loss`, its value and gradient; `make_eval_step`'s
counts with padding rows; `TrainState.create` with an EMA and bf16
masters, and the carry-over of the EMA and of a clip-chained optimizer
state through `convert.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_common import perturb, to_jax_tree, to_numpy_tree, x64
from test_torch_train_loop import (BATCH, CLASSES, DEPTH, IMG, NAME, _flat,
                                   _jax_policy, _mid_run_adam,
                                   _student_variables)

from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.train import TrainState as JaxTrainState
from ofq_tpu.train import losses as jlosses
from ofq_tpu.train import make_eval_step as jax_make_eval_step
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu.train import optim as joptim
from ofq_tpu.train import schedule as jschedule
from ofq_tpu_torch.convert import (load_ema_params, load_flax_params,
                                   load_optax_adamw_state)
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.quant import w2a2_qkr_policy
from ofq_tpu_torch.train import (TrainState, clip_gradients, constant_lr,
                                 dampening_loss, ema_update, make_eval_step,
                                 make_optimizer, make_train_step)


def test_constant_lr():
    for v in (1e-5, 5.47e-4, 0.1):
        jf, tf = jschedule.constant_lr(v), constant_lr(v)
        for t in (0, 1, 7, 300, 10 ** 6):
            assert tf(t) == float(jf(t)) == float(np.float32(v))


# ------------------------------------------------------------ clipping
def _clip_case(seed, float_head):
    """A parameter tree with the shapes AGC tells apart (kernels, the 2-D
    ImageBias, 1-D biases and scales, pos_embed) and the last head
    quantized (head_dist with its move biases) or float (head alone), and
    gradients from 1e-4 to 10 times their parameters' size."""
    rng = np.random.default_rng(seed)
    params = {"blocks_0": {"attn": {"v_kernel": rng.normal(size=(6, 6)),
                                    "quan_v": {"s": rng.random(6) + .1}},
                           "mlp": {"fc1": {"kernel": rng.normal(size=(6, 8)),
                                           "bias": rng.normal(size=8)}}},
              "pos_embed": rng.normal(size=(1, 3, 6)) * 0.02,
              "patch_embed": {"kernel": rng.normal(size=(2, 2, 3, 6)),
                              "move_b4": {"bias": rng.normal(size=(4, 4))}}}
    heads = ("head",) if float_head else ("head", "head_dist")
    for h in heads:
        params[h] = {"kernel": rng.normal(size=(6, 5)) * 0.2,
                     "bias": rng.normal(size=5)}
        if not float_head:
            params[h].update(move_b4={"bias": rng.normal(size=6)},
                             move_aft={"bias": rng.normal(size=5)},
                             input_quant={"s": rng.random(1) + .1})
    grads = jax.tree.map(lambda p: rng.normal(size=np.shape(p)) *
                         10.0 ** rng.uniform(-4, 1), params)
    return params, grads


def _jax_clip(mode, value):
    return {"norm": lambda: optax.clip_by_global_norm(value),
            "value": lambda: optax.clip(value),
            "agc": lambda: joptim.adaptive_grad_clip(
                clip_factor=value, exclude_head=True)}[mode]()


@pytest.mark.parametrize("float_head", [False, True])
@pytest.mark.parametrize("mode,value", [
    ("norm", 0.5), ("norm", 1e3), ("value", 0.05), ("agc", 0.01),
    ("agc", 0.3)])
def test_clip_gradients_match_optax(mode, value, float_head):
    """fp64: every clipped leaf within 1e-12 relative; the case clips some
    leaves and not others (norm: both sides of the threshold)."""
    params, grads = _clip_case(1, float_head)
    with x64():
        tx = _jax_clip(mode, value)
        jp, jg = to_jax_tree(params, np.float64), to_jax_tree(grads,
                                                                np.float64)
        want = _flat(to_numpy_tree(tx.update(jg, tx.init(jp), jp)[0]))
    tp = {k: torch.from_numpy(v) for k, v in _flat(params).items()}
    tg = {k: torch.from_numpy(v) for k, v in _flat(grads).items()}
    got = clip_gradients(tg, tp, value, mode)
    assert set(got) == set(want)
    changed = 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-12, atol=0,
                                   err_msg=k)
        changed += not np.array_equal(w, _flat(grads)[k])
    if (mode, value) != ("norm", 1e3):
        assert 0 < changed
    if mode == "agc":
        assert changed < len(want)
        skipped = ({"head.kernel", "head.bias"} if float_head else
                   {"head_dist.move_b4.bias", "head_dist.move_aft.bias"})
        for k in skipped:
            assert got[k] is tg[k]


@pytest.mark.parametrize("mode,value", [("norm", 0.5), ("value", 0.05),
                                        ("agc", 0.01)])
def test_clipped_adamw_matches_optax_chain(mode, value):
    """Three AdamW updates after each clipping transform in fp64, against
    `ofq_tpu.train.make_optimizer(..., clip_grad, clip_mode)`: updates
    and moments within 1e-12."""
    params, _ = _clip_case(2, False)
    grads = [_clip_case(3 + i, False)[1] for i in range(3)]
    sched = dict(epochs=300, warmup_epochs=5, warmup_lr=1e-6, min_lr=1e-5)
    with x64():
        tx = jax_make_optimizer(
            jschedule.cosine_with_warmup_cooldown(5e-2, **sched),
            weight_decay=0.05, clip_grad=value, clip_mode=mode)
        jp = to_jax_tree(params, np.float64)
        st = tx.init(jp)
        want = []
        for g in grads:
            u, st = tx.update(to_jax_tree(g, np.float64), st, jp)
            want.append(_flat(to_numpy_tree(u)))
        adam = st[1][0]
        j_mu = _flat(to_numpy_tree(adam.mu))
    from ofq_tpu_torch.train import cosine_with_warmup_cooldown
    opt = make_optimizer(cosine_with_warmup_cooldown(5e-2, **sched),
                         weight_decay=0.05, clip_grad=value, clip_mode=mode)
    tp = {k: torch.from_numpy(v) for k, v in _flat(params).items()}
    state = opt.init(tp)
    for g, w in zip(grads, want):
        upd, state = opt.update(
            {k: torch.from_numpy(v) for k, v in _flat(g).items()}, state, tp)
        for k in w:
            np.testing.assert_allclose(upd[k].numpy(), w[k], rtol=1e-12,
                                       atol=0, err_msg=k)
    for k in j_mu:
        np.testing.assert_allclose(state.mu[k].numpy(), j_mu[k], rtol=1e-12,
                                   atol=0, err_msg=k)


# ------------------------------------------------------------------ EMA
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_ema_update_matches_jax(dtype):
    """fp32 accumulators (JAX's TrainState keeps them so) against masters
    in `dtype`: within one fp32 ulp; fp64 accumulators within 1e-15."""
    rng = np.random.default_rng(4)
    p = {"a": rng.normal(size=(5, 7)), "b": rng.normal(size=3) * 1e-3}
    e = jax.tree.map(lambda x: x + rng.normal(size=x.shape) * 1e-2, p)
    acc = np.float64 if dtype == "float64" else np.float32
    tdt = getattr(torch, dtype)
    with x64():
        jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.dtype(dtype)), p)
        want = to_numpy_tree(joptim.ema_update(to_jax_tree(e, acc), jp,
                                               0.9999))
    got = ema_update({k: torch.from_numpy(np.asarray(v, acc))
                      for k, v in e.items()},
                     {k: torch.from_numpy(v).to(tdt) for k, v in p.items()},
                     0.9999)
    for k in p:
        assert got[k].dtype == torch.from_numpy(np.zeros(1, acc)).dtype
        if acc is np.float32:
            np.testing.assert_array_max_ulp(got[k].numpy(), want[k], 1)
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-15,
                                       atol=0)


# ------------------------------------------------------------ dampening
@pytest.mark.parametrize("weighting", [0.0, 0.3])
def test_dampening_loss_and_gradient(weighting):
    """Over every parameter of `deit_test_distilled` W2A2 QKR in fp64
    (the kernels of proj, fc1 and fc2 take part; v, q, k, the patch
    embedding and the heads do not): value and gradient within 1e-12."""
    params = _student_variables(0, np.float64)["params"]
    with x64():
        jp = to_jax_tree(params, np.float64)
        jv, jg = jax.value_and_grad(lambda t: jlosses.dampening_loss(
            t, 2, weighting))(jp)
        jv, jg = float(jv), _flat(to_numpy_tree(jg))
    tp = {k: torch.from_numpy(v).requires_grad_()
          for k, v in _flat(params).items()}
    tv = dampening_loss(tp, 2, weighting)
    if weighting == 0.0:
        assert float(tv) == jv == 0.0
        return
    tv.backward()
    assert jv > 0 and abs(float(tv) - jv) <= 1e-12 * jv
    touched = {k for k, g in jg.items() if np.any(g != 0)}
    assert touched == {f"blocks_{i}.{p}.kernel" for i in range(DEPTH)
                       for p in ("attn.proj", "mlp.fc1", "mlp.fc2")}
    for k, g in jg.items():
        got = (tp[k].grad.numpy() if tp[k].grad is not None
               else np.zeros_like(g))
        np.testing.assert_allclose(got, g, rtol=1e-12,
                                   atol=1e-12 * np.abs(g).max(), err_msg=k)


# ----------------------------------------------------------- eval step
def _eval_case():
    variables = perturb(_student_variables(2, np.float64),
                        np.random.default_rng(2))
    for h in ("head", "head_dist"):
        k = variables["params"][h]["kernel"]
        variables["params"][h]["kernel"] = (
            np.random.default_rng(3).normal(size=k.shape) * 0.3)
    port = create_model(NAME, policy=w2a2_qkr_policy(DEPTH),
                        device="cpu").double()
    load_flax_params(port, variables)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2 * BATCH, IMG, IMG, 3))
    return variables, port, x


def test_eval_step_matches_jax():
    """fp64: top-1 and top-5 counts equal JAX's, `loss_sum` (fp32 log
    softmax on both sides) within 1e-6 relative; the labels hit the top-1
    and the top-5 on some rows, and rows labelled -1 count nothing."""
    variables, port, x = _eval_case()
    with torch.no_grad():
        logits = port.eval()(torch.from_numpy(x)).numpy()
    order = np.argsort(-logits, axis=-1)
    label = np.random.default_rng(1).integers(0, CLASSES, size=len(x))
    label[0], label[1], label[2] = order[0, 0], order[1, 3], order[2, 1]
    label[-2:] = -1
    batch = {"image": x, "label": label}
    with x64():
        want = jax_make_eval_step(jax_deit_model(NAME, _jax_policy()))(
            to_jax_tree(variables, np.float64),
            {"image": jnp.asarray(x), "label": jnp.asarray(label)})
        want = {k: float(v) for k, v in want.items()}
    got = {k: float(v) for k, v in
           make_eval_step(port)(None, batch).items()}
    assert got["count"] == want["count"] == len(x) - 2
    assert got["correct1"] == want["correct1"] >= 1
    assert got["correct5"] == want["correct5"] >= 3
    assert abs(got["loss_sum"] - want["loss_sum"]) <= 1e-6 * want["loss_sum"]
    # the padding rows: their nll (class 0's) is left out
    label2 = label.copy()
    label2[-2:] = 0
    full = make_eval_step(port)(None, {"image": x, "label": label2})
    assert float(full["loss_sum"]) > got["loss_sum"]


def test_eval_step_ties_rank_the_lower_class_as_jax():
    """Logits with many exact ties (integers 0-2 over 12 classes): the
    top-1 and top-5 counts equal JAX's, whose `lax.top_k` ranks equal
    values by the lower class first, and rows labelled -1 count nothing."""
    rng = np.random.default_rng(12)
    logits = rng.integers(0, 3, size=(32, 12)).astype(np.float32)
    label = rng.integers(0, 12, size=32)
    label[:8] = np.argmax(logits[:8], axis=-1)  # the first maximum
    label[-3:] = -1

    class Fixed(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(()))

        def forward(self, x):
            return torch.from_numpy(logits) + 0 * self.w

    class JaxFixed:
        def apply(self, variables, image, train):
            return jnp.asarray(logits), None

    batch = {"image": np.zeros((32, 1, 1, 3), np.float32), "label": label}
    got = make_eval_step(Fixed())(None, batch)
    want = jax_make_eval_step(JaxFixed())(
        {"params": {}}, {k: jnp.asarray(v) for k, v in batch.items()})
    for k in ("correct1", "correct5", "count"):
        assert float(got[k]) == float(want[k]), k
    assert float(got["correct1"]) >= 8 and float(got["count"]) == 29
    assert abs(float(got["loss_sum"]) - float(want["loss_sum"])) <= (
        1e-6 * float(want["loss_sum"]))


def test_eval_step_params_bf16_masters_and_ema():
    """`params` replace the model's for one call: bf16 masters evaluate as
    their fp32 view (the model's working copy), an EMA as itself, and the
    model's own parameters are left as they were."""
    _, port, x = _eval_case()
    port.float()
    batch = {"image": x.astype(np.float32),
             "label": np.arange(len(x)) % CLASSES}
    opt = make_optimizer(constant_lr(1e-5))
    state = TrainState.create(port, opt, ema=True, master_dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in state.params.values())
    step = make_eval_step(port)
    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    a = step(state.params, batch)
    b = step(None, batch)
    assert {k: float(v) for k, v in a.items()} == {
        k: float(v) for k, v in b.items()}
    ema = {k: v + 0.01 for k, v in state.ema_params.items()}
    c = step(ema, batch)
    assert float(c["loss_sum"]) != float(b["loss_sum"])
    for k, p in port.named_parameters():
        assert torch.equal(p, before[k]), k


# ------------------------------------------------------ the step's inputs
def _step_case(policy):
    port = create_model(NAME, policy=policy, device="cpu").float()
    load_flax_params(port, _student_variables(2, np.float32))
    rng = np.random.default_rng(4)
    batch = {"image": rng.normal(size=(BATCH, IMG, IMG, 3)).astype(
                 np.float32),
             "label": rng.integers(0, CLASSES, size=BATCH)}
    return port, make_optimizer(constant_lr(1e-3)), batch


def test_cga_settings_come_from_the_policy(monkeypatch):
    """`make_train_step(cga=...)` takes the boundary range and the QKR
    selection rule from the model's policy when `cga` leaves them out (the
    masks are then the policy's, 0.01 here), and refuses a `cga` that
    disagrees with the policy."""
    from ofq_tpu_torch.train import cga as cga_lib
    port, opt, batch = _step_case(dataclasses.replace(
        w2a2_qkr_policy(DEPTH), qk_reparam_type=1, boundary_range=0.01))
    seen, real = [], cga_lib.freeze_masks
    monkeypatch.setattr(cga_lib, "freeze_masks",
                        lambda params, **kw: seen.append(kw) or real(
                            params, **kw))
    step = make_train_step(port, opt, loss_kind="ce", device="cpu",
                           cga=dict(bits=2))
    _, met = step(TrainState.create(port, opt), batch)
    assert np.isfinite(float(met["loss"]))
    assert seen == [dict(bits=2, model_type="deit", boundary_range=0.01,
                         qk_reparam=True)]
    for bad in (dict(bits=2, boundary_range=0.005),
                dict(bits=2, qk_reparam=False)):
        with pytest.raises(ValueError, match="policy"):
            make_train_step(port, opt, loss_kind="ce", device="cpu", cga=bad)


def test_step_reads_the_masters_dtype_from_the_state():
    """bf16 masters (`TrainState.create(..., master_dtype="bfloat16")`)
    stay bf16 through a step built without `master_dtype`, and the model's
    working copies equal them after it; fp32 masters are the model's own
    tensors, updated in place; a `master_dtype` that disagrees with the
    state's masters raises."""
    port, opt, batch = _step_case(w2a2_qkr_policy(DEPTH))
    step = make_train_step(port, opt, loss_kind="ce", device="cpu")
    st = TrainState.create(port, opt, master_dtype="bfloat16")
    before = {k: p.clone() for k, p in st.params.items()}
    st, _ = step(st, batch)
    assert all(p.dtype == torch.bfloat16 for p in st.params.values())
    assert any(not torch.equal(p, before[k]) for k, p in st.params.items())
    for k, p in port.named_parameters():
        assert torch.equal(p, st.params[k].float()), k
    with pytest.raises(ValueError, match="master_dtype"):
        make_train_step(port, opt, loss_kind="ce", device="cpu",
                        master_dtype="float32")(st, batch)
    st32 = TrainState.create(port, opt)
    ptrs = {k: p.data_ptr() for k, p in st32.params.items()}
    st32, _ = step(st32, batch)
    for k, p in port.named_parameters():
        assert st32.params[k] is p and p.data_ptr() == ptrs[k], k
    with pytest.raises(ValueError, match="master_dtype"):
        make_train_step(port, opt, loss_kind="ce", device="cpu",
                        master_dtype="bfloat16")(st32, batch)


# ---------------------------------------------------------- train state
def test_train_state_create_ema_and_masters():
    m = create_model(NAME, policy=w2a2_qkr_policy(DEPTH),
                     device="cpu").double()
    opt = make_optimizer(constant_lr(1e-5))
    st = TrainState.create(m, opt, ema=True)
    assert st.epoch == 0 and st.step == 0
    for k, p in m.named_parameters():
        assert st.params[k] is p
        assert st.ema_params[k].dtype == torch.float32
        assert st.ema_params[k].data_ptr() != p.data_ptr()
        np.testing.assert_array_equal(st.ema_params[k].numpy(),
                                      p.detach().numpy().astype(np.float32))
    assert TrainState.create(m, opt).ema_params is None
    m.float()
    w32 = {k: p.detach().clone() for k, p in m.named_parameters()}
    st = TrainState.create(m, opt, ema=True, master_dtype="bfloat16")
    for k, p in m.named_parameters():
        assert st.params[k].dtype == torch.bfloat16
        assert p.dtype == torch.float32
        assert torch.equal(p, st.params[k].float())
        assert torch.equal(st.params[k], w32[k].to(torch.bfloat16))
        assert st.opt_state.mu[k].dtype == torch.float32
        assert torch.equal(st.ema_params[k], st.params[k].float())
    with pytest.raises(ValueError, match="master_dtype"):
        TrainState.create(m, opt, master_dtype="float16")


def test_carry_ema_and_clip_chained_state():
    """JAX's state with an EMA and AGC chained before AdamW, mid-run: the
    Adam state is picked out of the chain (`opt_state[1][0]`), the EMA
    loads by the model's names, strictly."""
    variables = _student_variables(0, np.float32)
    mu, nu = _mid_run_adam(variables["params"], np.random.default_rng(0))
    tx = jax_make_optimizer(jschedule.constant_lr(1e-5), clip_grad=0.01,
                            clip_mode="agc")
    jst = JaxTrainState.create(to_jax_tree(variables, np.float32), tx,
                               ema=True)
    clip_state, (adam, masked, sched) = jst.opt_state
    adam = adam._replace(count=jnp.asarray(5, jnp.int32),
                         mu=to_jax_tree(mu, np.float32),
                         nu=to_jax_tree(nu, np.float32))
    ema = jax.tree.map(lambda e: e * 0.5, jst.ema_params)
    m = create_model(NAME, policy=w2a2_qkr_policy(DEPTH), device="cpu")
    load_flax_params(m, variables)
    st = TrainState.create(m, make_optimizer(constant_lr(1e-5),
                                             clip_grad=0.01,
                                             clip_mode="agc"), ema=True)
    load_optax_adamw_state(st, adam, step=5)
    load_ema_params(st, ema)
    assert st.opt_state.count == 5 and st.step == 5
    for k, e in _flat(to_numpy_tree(ema)).items():
        assert st.ema_params[k].dtype == torch.float32
        np.testing.assert_array_equal(st.ema_params[k].numpy(), e)
        np.testing.assert_array_equal(st.opt_state.mu[k].numpy(),
                                      _flat(mu)[k].astype(np.float32))
    del ema["pos_embed"]
    with pytest.raises(ValueError, match="missing.*pos_embed"):
        load_ema_params(st, ema)
