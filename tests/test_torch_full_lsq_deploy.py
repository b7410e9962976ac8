"""Packed artifacts of full-LSQ students (`--wq-mode lsq`, no QKR) against
`ofq_tpu.deploy`, on the CPU, at `test_torch_deploy.py`'s widths.

  * the port's export against JAX's from the same weights (signed and
    `--wq_asym`): metadata, passthroughs, scales and every code equal;
  * a JAX artifact restored by the port equal to JAX's `restore_packed`
    tree bit for bit (fp and int-core trees);
  * the port's frozen models on a JAX artifact against JAX's frozen
    models in fp64: the fp path (its `LsqWeight` at 32 bits the identity,
    the restored block scales dropped) to 1e-9 of max|ref|, the integer
    core (codes rebuilt from the restored `weight_quant.s`, the epilogue
    in fp32 on both sides) to 1e-5;
  * the port's own round trip (`model_tree` -> `export_packed` ->
    `Predictor.from_packed`): the artifact's codes equal to the live
    student's LSQ codes, its probabilities to the live student's within
    1e-4 relative, top-1 equal;
  * the frozen trees (fp and int core, from `jax.eval_shape`) load into the
    port's frozen models strictly; the policy checks of `from_packed`;
  * a StatsQ student without QKR (`QAttention`'s qkv and proj frozen) makes
    the same round trip, fp and integer core, against the live student.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_deploy import DEIT, _assert_trees_equal
from test_torch_port_common import perturb, to_jax_tree, to_numpy_tree, x64

import ofq_tpu.deploy as jdep
from ofq_tpu.models import deit as jdeit
from ofq_tpu.quant import default_deit_qmodules, policy_from_args
from ofq_tpu_torch import deploy as tdep
from ofq_tpu_torch.calibrate import calibrate
from ofq_tpu_torch.convert import flatten_flax_tree, load_flax_params
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.quant import w2a2_deit_policy
from ofq_tpu_torch.serve import Predictor

NAME = "deit_test_distilled"


def _jpol(asym=False):
    return policy_from_args(wq_bitw=2, aq_bitw=2, wq_mode="lsq",
                            wq_asym=asym, qk_reparam=False,
                            qmodules=default_deit_qmodules(2))


def _tpol(asym=False):
    return dataclasses.replace(
        w2a2_deit_policy(2, qk_reparam=False, wq_mode="lsq"),
        weight=dataclasses.replace(
            w2a2_deit_policy(2, qk_reparam=False, wq_mode="lsq").weight,
            all_positive=asym, symmetric=not asym))


def _trained(seed=0, asym=False):
    """JAX variables of the full-LSQ student (a jitted fp32 init on a
    seeded batch, shifts and head kernels drawn from the seed) and the
    batch."""
    jm = jdeit.deit_model(NAME, _jpol(asym), **DEIT)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 32, 32, 3))
    v = to_numpy_tree(jax.jit(lambda k, xx: jm.init(
        {"params": k}, xx, train=False))(jax.random.key(seed),
                                         jnp.asarray(x, jnp.float32)))
    v = perturb(v, rng)
    for h in ("head", "head_dist"):
        k = (rng.normal(size=v["params"][h]["kernel"].shape) * 0.2
             ).astype(np.float32)
        v["params"][h]["kernel"] = k
        v["params"][h]["weight_quant"]["s"] = (
            2 * np.abs(k).mean(0) / np.sqrt(127)).astype(np.float32)
    return v, x


def _export(fn, params, asym):
    return fn(params, weight_bits=2, qk_reparam=False, wq_mode="lsq",
              wq_asym=asym)


@pytest.mark.parametrize("asym", [False, True])
def test_port_export_against_jax(asym):
    variables, _ = _trained(seed=1, asym=asym)
    ej = _export(jdep.export_packed, variables["params"], asym)
    et = _export(tdep.export_packed, variables["params"], asym)
    meta = tdep.artifact_meta(et)
    assert meta == json.loads(bytes(ej["__meta__"]).decode())
    lsq2 = [k for k, i in meta["entries"].items()
            if i["kind"] == "lsq" and i["bits"] == 2]
    assert len(lsq2) == 8  # qkv, proj, fc1, fc2 of two blocks
    assert sorted(et) == sorted(ej)
    for key, v in et.items():
        if key != "__meta__":
            np.testing.assert_array_equal(v, ej[key], err_msg=key)


def test_jax_artifact_restored_bit_for_bit():
    variables, _ = _trained(seed=2)
    ex = _export(jdep.export_packed, variables["params"], False)
    for int_core in (False, True):
        _assert_trees_equal(tdep.restore_packed(ex, int_core=int_core),
                            jdep.restore_packed(ex, int_core=int_core))


@pytest.mark.parametrize("int_core", [False, True])
def test_frozen_serving_on_a_jax_artifact(int_core):
    variables, x = _trained(seed=3)
    ex = _export(jdep.export_packed, variables["params"], False)
    tree = jdep.restore_packed(ex, int_core=int_core)
    jm = jdeit.deit_model(NAME, dataclasses.replace(
        _jpol(), weight_frozen=True, frozen_int_bits=2 if int_core else None),
        **DEIT)
    with x64():
        want, _ = jm.apply({"params": to_jax_tree(tree, np.float64)},
                           jnp.asarray(x), train=False)
    want = np.asarray(want)
    tm = create_model(NAME, policy=dataclasses.replace(
        _tpol(), weight_frozen=True, frozen_int_bits=2 if int_core else None),
        device="cpu", **DEIT).double()
    load_flax_params(tm, {"params": tree if int_core
                          else tdep.drop_block_lsq_scales(tree),
                          "quant_stats": variables["quant_stats"]})
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 1e-3
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= (1e-5 if int_core else 1e-9), err


def test_port_artifact_serves_and_matches_the_live_model(tmp_path):
    x = np.random.default_rng(4).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    live = create_model(NAME, policy=_tpol(), device="cpu", head_std=0.2,
                        generator=torch.Generator().manual_seed(4))
    calibrate(live, x)
    ex = tdep.export_packed(tdep.model_tree(live), weight_bits=2,
                            qk_reparam=False, wq_mode="lsq")
    params = dict(live.named_parameters())
    for key, info in tdep.artifact_meta(ex)["entries"].items():
        if info["kind"] != "lsq" or info["bits"] != 2:
            continue
        name = key.replace("/", ".")
        s = torch.clamp_min(params[name[:-len("kernel")]
                                   + "weight_quant.s"], 1e-5)
        codes = torch.round(torch.clamp(params[name] / s, -2, 1)) + 2
        got = tdep.unpack_codes(ex[key + ".codes"], 2, codes.numel())
        np.testing.assert_array_equal(got, codes.detach().numpy().ravel()
                                      .astype(np.uint8), err_msg=key)
    path = tmp_path / "lsq.npz"
    np.savez(path, **ex)
    with torch.no_grad():
        want = torch.softmax(live(torch.from_numpy(x)), -1).numpy()
    for int_core in (False, True):
        pred = Predictor.from_packed(str(path), model_name=NAME,
                                     policy=_tpol(), int_core=int_core,
                                     batch_size=4, device="cpu")
        got = pred.predict(x)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("int_core", [False, True])
def test_frozen_trees_load_strictly(int_core):
    fib = 2 if int_core else None
    jm = jdeit.deit_model(NAME, dataclasses.replace(
        _jpol(), weight_frozen=True, frozen_int_bits=fib), **DEIT)
    shapes = jax.eval_shape(lambda k: jm.init(
        {"params": k}, jnp.zeros((1, 32, 32, 3)), train=False),
        jax.random.key(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = create_model(NAME, policy=dataclasses.replace(
        _tpol(), weight_frozen=True, frozen_int_bits=fib), device="cpu",
        **DEIT)
    load_flax_params(tm, tree)
    block_scales = [k for k in flatten_flax_tree(tree)
                    if "blocks_" in k and k.endswith("weight_quant/s")]
    assert len(block_scales) == (8 if int_core else 0)


def test_from_packed_checks_the_policy():
    variables, _ = _trained(seed=5)
    ex = _export(tdep.export_packed, variables["params"], False)
    kw = dict(model_name=NAME, device="cpu")
    with pytest.raises(ValueError, match="does not match the policy"):
        Predictor.from_packed(ex, policy=w2a2_deit_policy(2, qk_reparam=False),
                              **kw)
    with pytest.raises(ValueError, match="does not match the policy"):
        Predictor.from_packed(ex, policy=_tpol(asym=True), **kw)
    with pytest.raises(ValueError, match="wq_mode='lsq'"):
        tdep.export_packed(variables["params"], weight_bits=2,
                           qk_reparam=False)


def test_non_qkr_statsq_artifact_round_trip():
    x = np.random.default_rng(6).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    pol = w2a2_deit_policy(2, qk_reparam=False)
    live = create_model(NAME, policy=pol, device="cpu", head_std=0.2,
                        generator=torch.Generator().manual_seed(6))
    calibrate(live, x)
    ex = tdep.export_packed(tdep.model_tree(live), weight_bits=2,
                            qk_reparam=False)
    assert "blocks_0/attn/qkv/kernel.codes" in ex
    with torch.no_grad():
        want = torch.softmax(live(torch.from_numpy(x)), -1).numpy()
    for int_core in (False, True):
        pred = Predictor.from_packed(ex, model_name=NAME, policy=pol,
                                     int_core=int_core, batch_size=4,
                                     device="cpu")
        got = pred.predict(x)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
