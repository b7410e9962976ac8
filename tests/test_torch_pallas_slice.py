"""The pallas slice as a whole against `ofq_tpu`: the `deit_test_distilled`
W2A2 QKR student with `matmul_impl='pallas'` (the StatsQ matmul kernel K4
in every quantized linear, the composed attention tail), forward and one
`make_train_step` step with its float teacher, KD soft+hard and AdamW,
from the same converted parameters, `quant_stats` and mid-run Adam state
as `test_torch_train_slice.py`.  The Pallas kernel runs in interpret mode.

  * fp64 (x64): the kernel's sums are rounded to its fp32 accumulator in
    both frameworks (`preferred_element_type`), from the same fp64
    products, so the slice agrees as tightly as the composed fp64
    trajectory: logits to 1e-9, the loss to 1e-9, every parameter to 1e-9
    of max(1, its largest magnitude) after the step;
  * bf16, bench.py's configuration (`compute_dtype='bfloat16'`, fp32
    masters, the teacher's parameters in bf16), against XLA's compiled
    step: products and sums run in other orders, so a few LSQ levels move
    and the random-weight student carries them on (see
    `test_torch_pallas_layers.py`).  Counted and held: the share of LSQ
    outputs on another level than JAX's in the eval forward, at most
    0.2 % in the first block (the same input on both sides; measured
    0.02 %) and 5 % in all (the later blocks see the moved levels'
    consequences; measured 1.4 %); the logits within a relative L2
    distance of 0.1; the loss within 2 %; the gradient norm within 20 %
    (90 % of it is the gradient of the head's weight-LSQ scale, a sum of
    24 000 terms that cancel to a tenth of their magnitudes, and the
    head's input carries the later blocks' moved levels; measured 11 %);
    after the step
    AdamW moves a parameter by about lr * sign(g), so at most 10 % of the
    elements (and 20 % of any one leaf) may differ by more than lr / 4,
    none by more than 2.1 * lr, and at most 0.5 % of the quantized
    kernels' StatsQ levels may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pallas_layers import jax_pallas_interpret  # noqa: F401
from test_torch_port_common import to_jax_tree, to_numpy_tree, x64
from test_torch_train_loop import (BATCH, DEPTH, NAME, _flat, _jax_policy,
                                   _mid_run_adam, _student_variables,
                                   _teacher_variables)
from test_torch_train_slice import (LR, START, _batches, _jax_state,
                                    _with_heads)

from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.nn import quantizers as jquant
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu.train import make_train_step as jax_make_train_step
from ofq_tpu.train import schedule as jschedule
from ofq_tpu_torch.convert import load_flax_params, load_optax_adamw_state
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.nn import LsqAct
from ofq_tpu_torch.quant import QuantPolicy, statsq_b4_round, w2a2_qkr_policy
from ofq_tpu_torch.serve import Predictor
from ofq_tpu_torch.train import (TrainState, cosine_with_warmup_cooldown,
                                 make_optimizer, make_train_step)

PALLAS = dict(matmul_impl="pallas", attn_impl=None)


def _case(dtype, compute_dtype):
    """Variables, teacher variables, mid-run Adam moments; the port's
    student, bf16 or fp32/fp64 teacher, train state and step."""
    variables = _with_heads(_student_variables(3, dtype),
                            np.random.default_rng(3))
    tvars = _teacher_variables(4)
    mu, nu = _mid_run_adam(variables["params"], np.random.default_rng(5))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    port = create_model(NAME, policy=w2a2_qkr_policy(DEPTH), device="cpu",
                        compute_dtype=compute_dtype, **PALLAS).to(tdt)
    load_flax_params(port, variables)
    teacher = create_model(NAME, policy=QuantPolicy(), device="cpu",
                           compute_dtype=compute_dtype).to(tdt)
    load_flax_params(teacher, tvars["params"])
    if compute_dtype is not None:
        teacher.to(torch.bfloat16)  # bench.py's bf16 teacher parameters
    opt = make_optimizer(cosine_with_warmup_cooldown(5e-3, **LR),
                         weight_decay=0.05)
    state = TrainState.create(port, opt)
    load_optax_adamw_state(state, {"count": START, "mu": mu, "nu": nu},
                           step=START)
    step = make_train_step(port, opt, teacher=teacher,
                           loss_kind="kd_soft_hard", device="cpu")
    return variables, tvars, mu, nu, port, teacher, state, step


def _jax_models(compute_dtype):
    return (jax_deit_model(NAME, _jax_policy(), compute_dtype=compute_dtype,
                           **PALLAS),
            jax_deit_model(NAME, compute_dtype=compute_dtype))


def _jax_tx():
    return jax_make_optimizer(
        jschedule.cosine_with_warmup_cooldown(5e-3, **LR), weight_decay=0.05)


def test_slice_fp64(jax_pallas_interpret):
    variables, tvars, mu, nu, port, _, state, step = _case(np.float64, None)
    batch = _batches(1)[0]
    jm, jt = _jax_models(None)
    with x64():
        want = jm.apply(to_jax_tree(variables, np.float64),
                        jnp.asarray(batch["image"]), train=False)[0]
        tx = _jax_tx()
        jst = _jax_state(tx, variables, mu, nu, np.float64)
        jst, jmet = jax_make_train_step(jm, tx, teacher=jt,
                                        loss_kind="kd_soft_hard")(
            jst, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.key(0), to_jax_tree(tvars, np.float64)["params"])
        jparams = to_numpy_tree(jst.params["params"])
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(batch["image"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-9)
    state, met = step(state, batch)
    jl = float(jmet["loss"])
    assert abs(float(met["loss"]) - jl) <= 1e-9 * abs(jl)
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= (
        1e-6 * float(jmet["grad_norm"]))
    got = {k: p.detach().numpy() for k, p in port.named_parameters()}
    for k, w in _flat(jparams).items():
        err = float(np.abs(got[k] - w).max()) / max(1.0, float(
            np.abs(w).max()))
        assert err <= 1e-9, (k, err)


def _codes_port(model, x):
    """Every LsqAct's output of one eval forward, by module name."""
    out = {}
    hooks = [m.register_forward_hook(
        lambda mod, a, y, name=name: out.__setitem__(name, y.detach()))
        for name, m in model.named_modules() if isinstance(m, LsqAct)]
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    return logits, out


def _statsq_levels(params):
    """The StatsQ level index of every quantized kernel (fp32 rounding)."""
    out = {}
    for k, w in params.items():
        if k.endswith(("fc1.kernel", "fc2.kernel", "proj.kernel",
                       "v_kernel")) and k.startswith("blocks_"):
            b4, _ = statsq_b4_round(torch.as_tensor(w).float(), 2)
            out[k] = torch.round(b4).numpy()
    return out


def test_slice_bf16(jax_pallas_interpret):
    """bench.py's pallas step in bf16 against XLA's compiled step (the
    limits are in the module docstring)."""
    variables, tvars, mu, nu, port, _, state, step = _case(np.float32,
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
    logits, codes_t = _codes_port(port, batch["image"])
    assert logits.dtype == torch.float32
    assert {k.rsplit(".0", 1)[0] for k in codes_j} == set(codes_t)
    moved = {"blocks_0": [0, 0], "all": [0, 0]}
    for k, v in codes_t.items():
        want = codes_j.get(k, codes_j.get(k + ".0"))
        assert v.dtype == torch.bfloat16 or k.startswith("head"), k
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


def test_predictor_pallas_bf16(tmp_path):
    """Serving: `Predictor.from_flax_npz` builds bench.py's pallas bf16
    configuration; its probabilities are the model's softmax."""
    variables = _student_variables(3, np.float32)
    path = tmp_path / "w.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in _flat_paths(
        variables).items()})
    pred = Predictor.from_flax_npz(
        str(path), model_name=NAME, policy=w2a2_qkr_policy(DEPTH),
        compute_dtype="bfloat16", batch_size=BATCH, device="cpu", **PALLAS)
    assert pred.model.compute_dtype == torch.bfloat16
    x = _batches(1, np.float32)[0]["image"][:3]
    probs = pred.predict(x)
    assert probs.shape == (3, 1000) and np.isfinite(probs).all()
    with torch.no_grad():
        want = torch.softmax(pred.model(torch.from_numpy(
            np.pad(x, ((0, BATCH - 3), (0, 0), (0, 0), (0, 0))))), -1)
    np.testing.assert_allclose(probs, want[:3].numpy(), rtol=0, atol=0)


def _flat_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_paths(v, p))
        else:
            out[p] = v
    return out


def test_fused_kernels_refuse_the_bf16_stream(monkeypatch):
    """The fused kernels take the bf16 stream now (ROADMAP Queue 1 item
    1): each fused configuration builds under compute_dtype='bfloat16'
    and runs in it.  What the attention kernels' wrappers still refuse on
    the card is a stream dtype they have no kernel for (fp16), and a bf16
    stream whose operands are not all bf16."""
    from ofq_tpu_torch.ops import fused_attention as fa
    for kw in (dict(matmul_impl="fused"), dict(attn_impl="fused")):
        m = create_model(NAME, policy=w2a2_qkr_policy(DEPTH), device="cpu",
                         compute_dtype="bfloat16", **kw)
        assert m.blocks_0.attn.compute_dtype == torch.bfloat16
        with torch.no_grad():
            y = m(torch.zeros(1, 32, 32, 3))
        assert y.shape == (1, 1000) and torch.isfinite(y).all()
    monkeypatch.setattr(fa, "on_card", lambda t: True)
    lhs, rhs, v = (torch.zeros(1, 4, 2, 8) for _ in range(3))
    s = torch.ones(4)
    with pytest.raises(ValueError, match="contiguous float32"):
        fa.qkr_attention_fwd(lhs.half(), rhs.half(), v.half(), s, 2, 0.5,
                             True)
    with pytest.raises(ValueError, match="contiguous bfloat16"):
        fa.qkr_attention_bwd(lhs.bfloat16(), rhs, v.bfloat16(), s,
                             v.bfloat16(), 2, 0.5, True)
