"""The int8 slice as a whole against `ofq_tpu`: the `deit_test_distilled`
W2A2 QKR student with `matmul_impl='int8'` (every quantized product on the
integer codes: QKR's v and qkx, proj, fc1, fc2), forward and one
`make_train_step` step with its float teacher, KD soft+hard and AdamW,
from the same converted parameters, `quant_stats` and mid-run Adam state as
`test_torch_pallas_slice.py`; and `swin_test`'s int8 forward.

  * fp64 (x64), the eval forward: JAX's int8 ops compute in fp32 whatever
    the stream (the epilogue `acc * s_eff * col + bq`), the rest of the
    model in fp64, the same in the port; the two differ by the order of
    their fp32 sums: logits to 1e-5 relative;
  * the step in fp32 (JAX's int8 VJP cannot run under x64: it returns the
    bias cotangents in fp32 for fp64 primals, which JAX refuses), against
    XLA's compiled step, under the limits of
    `test_torch_train_slice_fused.py`'s fp32 step;
  * bf16, bench.py's int8 configuration (`compute_dtype='bfloat16'`, fp32
    masters, the teacher's parameters in bf16), against XLA's compiled
    step, under the limits of `test_torch_pallas_slice.py`'s bf16 test
    (LSQ outputs on another level, logits, loss, gradient norm, the
    parameters after the step, StatsQ levels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_pallas_slice import _codes_port, _statsq_levels
from test_torch_port_common import (jit_x64_apply, jitted_init, to_jax_tree,
                                    to_numpy_tree)
from test_torch_swin_model import _images, _with_head
from test_torch_swin_model import _jax_policy as _jax_swin_policy
from test_torch_train_loop import (BATCH, DEPTH, NAME, _flat, _jax_policy,
                                   _mid_run_adam, _student_variables,
                                   _teacher_variables)
from test_torch_train_slice import (LR, START, _batches, _jax_state,
                                    _with_heads)

from ofq_tpu.models import swin as jswin
from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.nn import quantizers as jquant
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu.train import make_train_step as jax_make_train_step
from ofq_tpu.train import schedule as jschedule
from ofq_tpu_torch.convert import load_flax_params, load_optax_adamw_state
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.ops import launch_counts, reset_launch_counts
from ofq_tpu_torch.quant import (QuantPolicy, w2a2_qkr_policy,
                                 w2a2_qkr_swin_policy)
from ofq_tpu_torch.serve import Predictor
from ofq_tpu_torch.train import (TrainState, cosine_with_warmup_cooldown,
                                 make_optimizer, make_train_step)

INT8 = dict(matmul_impl="int8", attn_impl=None)


def _case(dtype, compute_dtype):
    variables = _with_heads(_student_variables(3, dtype),
                            np.random.default_rng(3))
    tvars = _teacher_variables(4)
    mu, nu = _mid_run_adam(variables["params"], np.random.default_rng(5))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    port = create_model(NAME, policy=w2a2_qkr_policy(DEPTH), device="cpu",
                        compute_dtype=compute_dtype, **INT8).to(tdt)
    load_flax_params(port, variables)
    teacher = create_model(NAME, policy=QuantPolicy(), device="cpu",
                           compute_dtype=compute_dtype).to(tdt)
    load_flax_params(teacher, tvars["params"])
    if compute_dtype is not None:
        teacher.to(torch.bfloat16)
    opt = make_optimizer(cosine_with_warmup_cooldown(5e-3, **LR),
                         weight_decay=0.05)
    state = TrainState.create(port, opt)
    load_optax_adamw_state(state, {"count": START, "mu": mu, "nu": nu},
                           step=START)
    step = make_train_step(port, opt, teacher=teacher,
                           loss_kind="kd_soft_hard", device="cpu")
    return variables, tvars, mu, nu, port, state, step


def _jax_models(compute_dtype):
    return (jax_deit_model(NAME, _jax_policy(), compute_dtype=compute_dtype,
                           **INT8),
            jax_deit_model(NAME, compute_dtype=compute_dtype))


def _jax_tx():
    return jax_make_optimizer(
        jschedule.cosine_with_warmup_cooldown(5e-3, **LR), weight_decay=0.05)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def test_forward_fp64():
    variables, _, _, _, port, _, _ = _case(np.float64, None)
    batch = _batches(1)[0]
    jm, _ = _jax_models(None)
    want = jit_x64_apply(jm, variables, batch["image"], train=False)[0]
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(batch["image"]))
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-5


def test_step_fp32():
    """One int8 step in fp32: the loss and the gradient norm to 1e-5
    relative; at most 1 % of a leaf's elements farther than 1e-3 * lr +
    1e-6 * |p| from JAX's, none farther than 2.1 * lr (AdamW's update is
    ~ lr * sign(g): a gradient that is fp32 noise may step the other
    way)."""
    variables, tvars, mu, nu, port, state, step = _case(np.float32, None)
    batch = _batches(1, np.float32)[0]
    jm, jt = _jax_models(None)
    tx = _jax_tx()
    jst = _jax_state(tx, variables, mu, nu, np.float32)
    jst, jmet = jax.jit(jax_make_train_step(jm, tx, teacher=jt,
                                            loss_kind="kd_soft_hard"))(
        jst, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(0), to_jax_tree(tvars, np.float32)["params"])
    state, met = step(state, batch)
    jl = float(jmet["loss"])
    assert abs(float(met["loss"]) - jl) <= 1e-5 * abs(jl)
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= (
        1e-5 * float(jmet["grad_norm"]))
    lr = cosine_with_warmup_cooldown(5e-3, **LR)(START)
    got = {k: p.detach().numpy() for k, p in port.named_parameters()}
    for k, w in _flat(to_numpy_tree(jst.params["params"])).items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2.1 * lr, k
        assert np.mean(d > 1e-3 * lr + 1e-6 * np.abs(w)) <= 0.01, k


def test_slice_bf16():
    """bench.py's int8 step in bf16 against XLA's compiled step (the limits
    of `test_torch_pallas_slice.test_slice_bf16`)."""
    variables, tvars, mu, nu, port, state, step = _case(np.float32,
                                                        "bfloat16")
    batch = _batches(1, np.float32)[0]
    jm, jt = _jax_models("bfloat16")
    jv = to_jax_tree(variables, np.float32)
    x = jnp.asarray(batch["image"])
    (want_logits, _), inter = jax.jit(lambda v, xx: jm.apply(
        v, xx, train=False, mutable=["intermediates"],
        capture_intermediates=lambda m, n: isinstance(m, jquant.LsqAct)
        and n == "__call__"))(jv, x)
    codes_j = {k.replace("/", ".").rsplit(".__call__", 1)[0]: np.asarray(
        v, np.float32) for k, v in _flat(to_numpy_tree(
            inter["intermediates"])).items()}
    reset_launch_counts()
    logits, codes_t = _codes_port(port, batch["image"])
    assert launch_counts()["int8_mm"] == 0  # the CPU: the plain product
    assert logits.dtype == torch.float32
    # JAX's int8 branch forms the QKR input's fp view from its scale
    # without its LsqAct (`_ScaleParam`), so that output is not captured
    # there; every other LSQ output is compared
    codes_t = {k: v for k, v in codes_t.items()
               if not k.endswith("attn.quant_x")}
    assert {k.rsplit(".0", 1)[0] for k in codes_j} == set(codes_t)
    moved = {"blocks_0": [0, 0], "all": [0, 0]}
    for k, v in codes_t.items():
        want = codes_j.get(k, codes_j.get(k + ".0"))
        for part in ("all", "blocks_0"):
            if part == "all" or k.startswith(part + "."):
                moved[part][0] += int(np.sum(v.float().numpy() != want))
                moved[part][1] += v.numel()
    share = {k: m / n for k, (m, n) in moved.items()}
    assert share["blocks_0"] <= 2e-3 and share["all"] <= 5e-2, share
    l2 = float(np.linalg.norm(logits.numpy() - np.asarray(want_logits))
               / np.linalg.norm(np.asarray(want_logits)))
    assert l2 <= 0.1, l2

    tx = _jax_tx()
    jst = _jax_state(tx, variables, mu, nu, np.float32)
    tparams = jax.tree.map(lambda p: p.astype(jnp.bfloat16),
                           to_jax_tree(tvars, np.float32)["params"])
    jst, jmet = jax.jit(jax_make_train_step(jm, tx, teacher=jt,
                                            loss_kind="kd_soft_hard"))(
        jst, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(0), tparams)
    state, met = step(state, batch)
    jl = float(jmet["loss"])
    assert abs(float(met["loss"]) - jl) <= 2e-2 * abs(jl)
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= (
        0.2 * float(jmet["grad_norm"]))
    lr = cosine_with_warmup_cooldown(5e-3, **LR)(START)
    got = {k: p.detach().numpy() for k, p in port.named_parameters()}
    want = _flat(to_numpy_tree(jst.params["params"]))
    far = n = 0
    for k, w in want.items():
        assert got[k].dtype == np.float32, k
        d = np.abs(got[k] - w)
        assert d.max() <= 2.1 * lr, k
        assert np.mean(d > lr / 4) <= 0.2, k
        far += int(np.sum(d > lr / 4))
        n += d.size
    assert far <= 0.1 * n, far / n
    lv_t, lv_j = _statsq_levels(got), _statsq_levels(want)
    flips = sum(int(np.sum(lv_t[k] != lv_j[k])) for k in lv_t)
    assert lv_t and flips <= 0.005 * sum(v.size for v in lv_t.values())


def test_swin_int8_fp64():
    """`swin_test` (two stages, a patch merging) with matmul_impl='int8':
    the QKR products, the MLPs and the reduction on the 4-D map."""
    x = _images(0)
    depths = (1, 1)
    jm = jswin.swin_model("swin_test", _jax_swin_policy(depths),
                          depths=depths, matmul_impl="int8")
    variables = to_numpy_tree(jitted_init(jm)(jax.random.key(0), jnp.asarray(
            x, jnp.float32)), np.float64)
    shifted = _with_head(variables, np.random.default_rng(1))
    want, _ = jit_x64_apply(jm, shifted, x, train=False)
    tm = create_model("swin_test", policy=w2a2_qkr_swin_policy(depths),
                      device="cpu", depths=depths, matmul_impl="int8")
    load_flax_params(tm.double(), shifted)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.abs(np.asarray(want)).max() > 1e-3
    assert _rel(got, want) <= 1e-5


def test_predictor_int8_bf16():
    """`Predictor` in bench.py's int8 serving configuration; its
    probabilities are the model's softmax, and the plain product's."""
    variables = _student_variables(3, np.float32)
    model = create_model(NAME, policy=w2a2_qkr_policy(DEPTH), device="cpu",
                         compute_dtype="bfloat16", **INT8)
    load_flax_params(model, variables)
    pred = Predictor(model, batch_size=BATCH, img_size=32, device="cpu")
    x = _batches(1, np.float32)[0]["image"][:3]
    probs = pred.predict(x)
    assert probs.shape == (3, 1000) and np.isfinite(probs).all()
    with torch.no_grad():
        want = torch.softmax(model(torch.from_numpy(
            np.pad(x, ((0, BATCH - 3), (0, 0), (0, 0), (0, 0))))), -1)
    np.testing.assert_array_equal(probs, want[:3].numpy())
    model.use_kernels = False
    np.testing.assert_array_equal(pred.predict(x), probs)
