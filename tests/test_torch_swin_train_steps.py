"""The Swin train step against `ofq_tpu.train.make_train_step` in the
pallas configuration (K4's plain version against JAX's Pallas kernel in
interpret mode) and the int8 one (the products on the integer codes), on
the CPU, from `test_torch_swin_train.py`'s cases (`swin_test` W2A2 QKR at
depths (2, 2), its float teacher, KD soft+hard, mid-run Adam state; JAX's
steps jitted): one step in fp32 at `test_torch_train_slice_fused.py`'s
limits and one in bf16 (`compute_dtype='bfloat16'`, fp32 masters, a bf16
teacher) at `test_torch_pallas_slice.py`'s.  Split from
`test_torch_swin_train.py`, unchanged, so that the two files run on two
test workers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pallas_layers import jax_pallas_interpret  # noqa: F401
from test_torch_pallas_slice import _codes_port
from test_torch_port_common import to_jax_tree, to_numpy_tree
from test_torch_swin_train import _case, _jax_batch
from test_torch_train_loop import _flat
from test_torch_train_slice import LR, START, _batches, _jax_state

from ofq_tpu.nn import quantizers as jquant
from ofq_tpu_torch.quant import statsq_b4_round
from ofq_tpu_torch.train import cosine_with_warmup_cooldown


# ------------------------------------------------- pallas, int8: fp32
def _one_step(c, dtype):
    b = _batches(1, np.float32)[0]
    jst = _jax_state(c["tx"], c["variables"], c["mu"], c["nu"], dtype)
    jst, jmet = c["jstep"](jst, _jax_batch(b), jax.random.key(0),
                           c["tparams"])
    state, met = c["step"](c["state"], b)
    return b, jst, jmet, met


@pytest.mark.parametrize("impl", ["pallas", "int8"])
def test_step_fp32(jax_pallas_interpret, impl):
    """The limits of `test_torch_train_slice_fused.py`'s fp32 step: the
    loss and the gradient norm to 1e-5 relative; at most 1 % of a leaf's
    elements farther than 1e-3 * lr + 1e-6 * |p| from JAX's, none farther
    than 2.1 * lr."""
    c = _case((2, 2), np.float32, dict(matmul_impl=impl))
    _, jst, jmet, met = _one_step(c, np.float32)
    jl = float(jmet["loss"])
    assert abs(float(met["loss"]) - jl) <= 1e-5 * abs(jl)
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= (
        1e-5 * float(jmet["grad_norm"]))
    lr = cosine_with_warmup_cooldown(5e-3, **LR)(START)
    got = {k: p.detach().numpy() for k, p in c["port"].named_parameters()}
    for k, w in _flat(to_numpy_tree(jst.params["params"])).items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2.1 * lr, k
        assert np.mean(d > 1e-3 * lr + 1e-6 * np.abs(w)) <= 0.01, k


# ------------------------------------------------- pallas, int8: bf16
def _statsq_levels(params):
    """The StatsQ level index of every quantized Swin kernel."""
    out = {}
    for k, w in params.items():
        if k.startswith("features_") and k.endswith((
                "fc1.kernel", "fc2.kernel", "proj.kernel", "v_kernel",
                "reduction.kernel")):
            b4, _ = statsq_b4_round(torch.as_tensor(w).float(), 2)
            out[k] = torch.round(b4).numpy()
    return out


@pytest.mark.parametrize("impl", ["pallas", "int8"])
def test_step_bf16(jax_pallas_interpret, impl):
    """bench.py's Swin-T configuration at `swin_test` size against XLA's
    compiled step, at `test_torch_pallas_slice.test_slice_bf16`'s limits:
    LSQ outputs of the eval forward on another level than JAX's at most
    0.2 % in the first block (the same input on both sides); logits within
    a relative L2 distance of 0.1; the loss within 2 %; after the step at
    most 20 % of a leaf's (10 % of all) elements farther than lr / 4 from
    JAX's and at most 0.5 % of the StatsQ levels moved.  Printed, not
    held: the largest distance (DeiT's 2.1 * lr: one fc2 element of the
    pallas step moved 3.07 * lr, where the mid-run second moment is tiny
    and the gradient's sign is the bf16 forward's), the share over all
    LSQ outputs (the
    random-weight student carries a moved level on from block to block, 4
    blocks and a merging deep here: 8-9 %; `test_torch_swin_serving.py`
    measured 45 % at the last block end to end and holds each block alone
    on the same input), and the gradient norm, of which the head's
    weight-LSQ scale gradient is most (2.4-3.0 of 2.5-3.0): a sum that
    cancels, which moved by 70-130 % of itself against JAX's on every bf16
    path measured here, the composed one too."""
    conf = dict(matmul_impl=impl, compute_dtype="bfloat16")
    c = _case((2, 2), np.float32, conf)
    b = _batches(1, np.float32)[0]
    jv = to_jax_tree(c["variables"], np.float32)
    (want_logits, _), inter = jax.jit(lambda v, xx: c["jm"].apply(
        v, xx, train=False, mutable=["intermediates"],
        capture_intermediates=lambda m, n: isinstance(m, jquant.LsqAct)
        and n == "__call__"))(jv, jnp.asarray(b["image"]))
    codes_j = {k.replace("/", ".").rsplit(".__call__", 1)[0]: np.asarray(
        v, np.float32) for k, v in _flat(to_numpy_tree(
            inter["intermediates"])).items()}
    logits, codes_t = _codes_port(c["port"], b["image"])
    assert logits.dtype == torch.float32
    moved = {"features_1_0": [0, 0], "all": [0, 0]}
    compared = 0
    for k, v in codes_t.items():
        want = codes_j.get(k, codes_j.get(k + ".0"))
        if want is None:
            # JAX's int8 branch forms the QKR input's fp view from its
            # scale without its LsqAct: that output is not captured there
            assert impl == "int8" and k.endswith("attn.quant_x"), k
            continue
        compared += 1
        for part in ("all", "features_1_0"):
            if part == "all" or k.startswith(part + "."):
                moved[part][0] += int(np.sum(v.float().numpy() != want))
                moved[part][1] += v.numel()
    assert compared >= len(codes_t) - 4
    share = {k: m / n for k, (m, n) in moved.items()}
    print(f"LSQ outputs on another level than JAX's: {share}")
    assert share["features_1_0"] <= 2e-3, share
    want_logits = np.asarray(want_logits)
    l2 = float(np.linalg.norm(logits.numpy() - want_logits)
               / np.linalg.norm(want_logits))
    assert l2 <= 0.1, l2

    _, jst, jmet, met = _one_step(c, np.float32)
    jl = float(jmet["loss"])
    assert abs(float(met["loss"]) - jl) <= 2e-2 * abs(jl)
    print(f"gradient norm {float(met['grad_norm'])}, JAX's "
          f"{float(jmet['grad_norm'])}")
    lr = cosine_with_warmup_cooldown(5e-3, **LR)(START)
    got = {k: p.detach().numpy() for k, p in c["port"].named_parameters()}
    want = _flat(to_numpy_tree(jst.params["params"]))
    far = n = 0
    worst = (0.0, 0.0)
    for k, w in want.items():
        assert got[k].dtype == np.float32, k
        d = np.abs(got[k] - w)
        worst = max(worst[0], float(d.max()) / lr), max(
            worst[1], float(np.mean(d > lr / 4)))
        assert np.mean(d > lr / 4) <= 0.2, k
        far += int(np.sum(d > lr / 4))
        n += d.size
    print(f"largest distance / lr {worst[0]}, worst leaf's share farther "
          f"than lr / 4 {worst[1]}, of all {far / n}")
    assert far <= 0.1 * n, far / n
    lv_t, lv_j = _statsq_levels(got), _statsq_levels(want)
    assert len(lv_t) == 4 * 4 + 1
    flips = sum(int(np.sum(lv_t[k] != lv_j[k])) for k in lv_t)
    assert flips <= 0.005 * sum(v.size for v in lv_t.values())
