"""Packed deployment artifacts (`ofq_tpu_torch/deploy.py`,
`Predictor.from_packed`) against `ofq_tpu.deploy`, on the CPU:

  * `pack_codes` / `unpack_codes` at 2-8 bits, bit for bit against JAX's;
  * a JAX artifact restored by the port equal to JAX's `restore_packed`
    tree bit for bit (fp and int-core trees);
  * the port's frozen int-core and frozen fp logits on a JAX artifact
    against JAX's in fp64 (the fp path to 1e-9; the int core, whose
    epilogue both frameworks form in fp32, to 1e-5), and int core against
    fp with every prediction kept (JAX's own rule: 2e-4);
  * the port's export against JAX's from the same weights: metadata and
    passthroughs equal, scales to 1e-6 (means in another order), and any
    differing code within one fp32 ulp of its level boundary (the
    pre-round value `clip(w/s) * n - 0.5` within one ulp of a
    half-integer; measured: none differ at these widths, ROADMAP.md
    Queue 3);
  * the full-LSQ kernel without `wq_mode='lsq'`, the one-bit refusal,
    and strict loading of the
    frozen trees (DeiT and Swin-T, fp and int core, shapes from
    `jax.eval_shape`).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_common import (jitted_init, perturb, to_jax_tree,
                                    to_numpy_tree, x64)

import ofq_tpu.deploy as jdep
from ofq_tpu.models import deit as jdeit
from ofq_tpu.models import swin as jswin
from ofq_tpu.quant import (default_deit_qmodules, default_swin_qmodules,
                           policy_from_args)
from ofq_tpu_torch import deploy as tdep
from ofq_tpu_torch.convert import flatten_flax_tree, load_flax_params
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.quant import w2a2_qkr_policy, w2a2_qkr_swin_policy
from ofq_tpu_torch.quant.statsq import statsq_b4_round
from ofq_tpu_torch.serve import Predictor

# JAX's `tests/test_deploy.py` configurations
DEIT = dict(embed_dim=128, num_heads=2, num_classes=7)
SWIN = dict(embed_dim=64, num_classes=5)


def _jax_deit(pol):
    return jdeit.deit_model("deit_test_distilled", pol, **DEIT)


def _jax_swin(pol):
    return jswin.swin_model("swin_test", pol, **SWIN)


def _jpol(family, qk_reparam=True, bits=2):
    mods = (default_deit_qmodules(2) if family == "deit"
            else default_swin_qmodules((1, 1)))
    return policy_from_args(wq_bitw=bits, aq_bitw=bits, qmodules=mods,
                            qk_reparam=qk_reparam, qk_reparam_type=0)


def _export_kw(family):
    return dict(num_heads=2) if family == "deit" else dict(head_dim=32)


def _trained(family, seed=0):
    """JAX variables of the W2A2 QKR student (a jitted fp32 init on a
    seeded batch, the zero-initialised shifts and head kernels drawn from
    the seed, the heads' weight scales fitted to them) and the batch."""
    jm = (_jax_deit if family == "deit" else _jax_swin)(_jpol(family))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 32, 32, 3))
    v = to_numpy_tree(jitted_init(jm)(jax.random.key(seed),
                                         jnp.asarray(x, jnp.float32)))
    v = perturb(v, rng)
    for h in ("head", "head_dist"):
        if h in v["params"]:
            k = (rng.normal(size=v["params"][h]["kernel"].shape) * 0.2
                 ).astype(np.float32)
            v["params"][h]["kernel"] = k
            v["params"][h]["weight_quant"]["s"] = (
                2 * np.abs(k).mean(0) / np.sqrt(127)).astype(np.float32)
    return v, x


def _port(family, pol, **kw):
    name = "deit_test_distilled" if family == "deit" else "swin_test"
    return create_model(name, policy=pol, device="cpu",
                        **(DEIT if family == "deit" else SWIN), **kw)


def _tpol(family):
    return (w2a2_qkr_policy(2) if family == "deit"
            else w2a2_qkr_swin_policy((1, 1)))


@pytest.mark.parametrize("bits", range(2, 9))
def test_pack_unpack_bit_equal(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2 ** bits, size=1001).astype(np.uint8)
    packed = tdep.pack_codes(codes, bits)
    np.testing.assert_array_equal(packed, jdep.pack_codes(codes, bits))
    assert packed.dtype == np.uint8 and packed.size == -(-1001 * bits // 8)
    np.testing.assert_array_equal(tdep.unpack_codes(packed, bits, 1001),
                                  codes)
    np.testing.assert_array_equal(tdep.unpack_codes(packed, bits, 1001),
                                  jdep.unpack_codes(packed, bits, 1001))


def _assert_trees_equal(a, b):
    fa, fb = flatten_flax_tree(a), flatten_flax_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("family", ["deit", "swin"])
def test_jax_artifact_restored_bit_for_bit(family):
    variables, _ = _trained(family)
    ex = jdep.export_packed(variables["params"], weight_bits=2,
                            qk_reparam=True, **_export_kw(family))
    for int_core in (False, True):
        _assert_trees_equal(tdep.restore_packed(ex, int_core=int_core),
                            jdep.restore_packed(ex, int_core=int_core))
    assert tdep.artifact_nbytes(ex) == jdep.artifact_nbytes(ex)


@pytest.mark.parametrize("family", ["deit", "swin"])
def test_frozen_serving_on_a_jax_artifact(family):
    variables, x = _trained(family, seed=1)
    ex = jdep.export_packed(variables["params"], weight_bits=2,
                            qk_reparam=True, **_export_kw(family))
    logits = {}
    for int_core in (False, True):
        jpol = dataclasses.replace(_jpol(family), weight_frozen=True,
                                   frozen_int_bits=2 if int_core else None)
        jm = (_jax_deit if family == "deit" else _jax_swin)(jpol)
        tree = jdep.restore_packed(ex, int_core=int_core)
        with x64():
            want, _ = jm.apply({"params": to_jax_tree(tree, np.float64)},
                               jnp.asarray(x), train=False)
        fpol = dataclasses.replace(_tpol(family), weight_frozen=True,
                                   frozen_int_bits=2 if int_core else None)
        tm = _port(family, fpol).double()
        load_flax_params(tm, {"params": tree,
                              "quant_stats": variables["quant_stats"]})
        with torch.no_grad():
            got = tm(torch.from_numpy(x)).numpy()
        want = np.asarray(want)
        assert np.abs(want).max() > 1e-3
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= (1e-5 if int_core else 1e-9), (int_core, err)
        logits[int_core] = got
    np.testing.assert_allclose(logits[True], logits[False], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(logits[True].argmax(-1),
                                  logits[False].argmax(-1))


@pytest.mark.parametrize("family", ["deit", "swin"])
def test_port_export_against_jax(family):
    variables, _ = _trained(family, seed=2)
    params = variables["params"]
    kw = _export_kw(family)
    ej = jdep.export_packed(params, weight_bits=2, qk_reparam=True, **kw)
    et = tdep.export_packed(params, weight_bits=2, qk_reparam=True, **kw)
    meta = tdep.artifact_meta(et)
    assert meta == json.loads(bytes(ej["__meta__"]).decode())
    assert sorted(et) == sorted(ej)
    differing = 0
    for key, v in et.items():
        if key == "__meta__" or key.endswith(".codes"):
            continue
        if key.endswith(".scale"):
            np.testing.assert_allclose(v, ej[key], rtol=1e-6, err_msg=key)
            continue
        np.testing.assert_array_equal(v, ej[key], err_msg=key)
    for key, info in meta["entries"].items():
        size = int(np.prod(info["enc_shape"]))
        ct = tdep.unpack_codes(et[key + ".codes"], info["bits"], size)
        cj = jdep.unpack_codes(ej[key + ".codes"], info["bits"], size)
        bad = np.flatnonzero(ct != cj)
        if not bad.size:
            continue
        assert info["kind"] == "statsq", key
        differing += bad.size
        w = _encoded_input(params, key, info, kw)
        b4, _ = statsq_b4_round(torch.from_numpy(w), info["bits"],
                                reduce_axis=-1 if key.endswith(
                                    "w_qk_frozen") else 0)
        t = b4.numpy().ravel()[bad]
        gap = np.abs(t - (np.floor(t) + 0.5))
        assert np.all(gap <= np.spacing(np.abs(t).astype(np.float32))), (
            key, gap)
    assert differing == 0, differing  # measured at these widths


def _encoded_input(params, key, info, kw):
    """The fp32 tensor an entry's codes encode (W_qk from q and k)."""
    node = params
    path = key.split("/")
    for p in path[:-1]:
        node = node[p]
    if path[-1] != "w_qk_frozen":
        return np.asarray(node[path[-1]], np.float32)
    H, C, _ = info["shape"]
    q = torch.from_numpy(np.asarray(node["q_kernel"], np.float32))
    k = torch.from_numpy(np.asarray(node["k_kernel"], np.float32))
    return torch.einsum("ihd,jhd->hij", q.reshape(C, H, C // H),
                        k.reshape(C, H, C // H)).reshape(H * C, C).numpy()


def test_port_artifact_serves_and_matches_the_live_model(tmp_path):
    """The port's own round trip: `model_tree` -> `export_packed` -> an
    `.npz` -> `Predictor.from_packed`, fp and int core, against the live
    student (the same codes: the same ops on the same device)."""
    from ofq_tpu_torch.calibrate import calibrate
    x = np.random.default_rng(3).normal(size=(4, 32, 32, 3))
    live = create_model("deit_test_distilled", policy=_tpol("deit"),
                        device="cpu", head_std=0.2,
                        generator=torch.Generator().manual_seed(3))
    calibrate(live, x.astype(np.float32))
    ex = tdep.export_packed(tdep.model_tree(live), weight_bits=2,
                            qk_reparam=True, num_heads=3)
    path = tmp_path / "a.npz"
    np.savez(path, **ex)
    with torch.no_grad():
        want = torch.softmax(live(torch.from_numpy(x).float()), -1).numpy()
    for int_core in (False, True):
        pred = Predictor.from_packed(
            str(path), model_name="deit_test_distilled",
            policy=_tpol("deit"), int_core=int_core, batch_size=4,
            device="cpu")
        got = pred.predict(x.astype(np.float32))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_artifact_size():
    """At JAX's test width (embed 128) the W2 artifact is more than 3x
    smaller than the fp32 parameters (the fp32 passthroughs, norms, biases,
    scales and embeddings, cap the ratio), and `artifact_nbytes` counts
    JAX's way."""
    variables, _ = _trained("deit", seed=4)
    live = _port("deit", _tpol("deit"))
    load_flax_params(live, variables)
    ex = tdep.export_packed(tdep.model_tree(live), weight_bits=2,
                            qk_reparam=True, num_heads=2)
    fp32 = sum(p.numel() * 4 for p in live.parameters())
    assert fp32 / tdep.artifact_nbytes(ex) > 3.0
    assert tdep.artifact_nbytes(ex) == jdep.artifact_nbytes(ex)


def test_refusals():
    with pytest.raises(ValueError, match="2..8"):
        tdep.export_packed({"fc1": {"kernel": np.ones((4, 4), np.float32)}},
                           weight_bits=1, qk_reparam=False, num_heads=1)
    lsq_tree = {"blocks_0": {"mlp": {"fc1": {
        "kernel": np.ones((4, 4), np.float32),
        "weight_quant": {"s": np.ones(4, np.float32)},
        "input_quant": {"s": np.ones(4, np.float32)}}}}}
    # a full-LSQ block kernel needs wq_mode='lsq' (its packing:
    # test_torch_full_lsq_deploy.py)
    with pytest.raises(ValueError, match="wq_mode='lsq'"):
        tdep.export_packed(lsq_tree, weight_bits=2, qk_reparam=False)
    variables, _ = _trained("deit")
    ex = jdep.export_packed(variables["params"], weight_bits=2,
                            qk_reparam=True, num_heads=2)
    with pytest.raises(ValueError, match="does not match the policy"):
        Predictor.from_packed(ex, model_name="deit_test_distilled",
                              policy=dataclasses.replace(
                                  _tpol("deit"), qk_reparam=False),
                              device="cpu")


@pytest.mark.parametrize("family,int_core", [("deit", False),
                                             ("deit", True),
                                             ("swin_t", False),
                                             ("swin_t", True)])
def test_frozen_trees_load_strictly(family, int_core):
    """The JAX frozen model's tree (names and shapes from `jax.eval_shape`)
    loads into the port's frozen model strictly both ways, and one entry
    left out raises."""
    fib = 2 if int_core else None
    if family == "deit":
        jpol = dataclasses.replace(_jpol("deit"), weight_frozen=True,
                                   frozen_int_bits=fib)
        jm, img = _jax_deit(jpol), 32
        tm = _port("deit", dataclasses.replace(
            _tpol("deit"), weight_frozen=True, frozen_int_bits=fib))
    else:
        jpol = policy_from_args(
            wq_bitw=2, aq_bitw=2, qmodules=default_swin_qmodules(),
            qk_reparam=True, qk_reparam_type=0)
        jm = jswin.swin_model("swin_t", dataclasses.replace(
            jpol, weight_frozen=True, frozen_int_bits=fib))
        img = 224
        tm = create_model("swin_t", policy=dataclasses.replace(
            w2a2_qkr_swin_policy(), weight_frozen=True,
            frozen_int_bits=fib), device="cpu")
    shapes = jax.eval_shape(
        lambda k: jm.init({"params": k}, jnp.zeros((1, img, img, 3)),
                          train=False), jax.random.key(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    load_flax_params(tm, tree)
    flat = flatten_flax_tree(tree)
    assert any(k.endswith("w_qk_frozen") for k in flat)
    assert not any(k.endswith(("q_kernel", "k_kernel")) for k in flat)
    assert any(k.endswith("w_qk_scale") for k in flat) == int_core
    dropped = next(k for k in flat if k.endswith("w_qk_frozen"))
    with pytest.raises(ValueError, match="missing"):
        load_flax_params(tm, {k: v for k, v in flat.items()
                              if k != dropped})
