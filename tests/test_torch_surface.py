"""The rest of the JAX package's public surface in the port, against the
JAX functions on the CPU:

  * `models.list_models` equals `ofq_tpu.models.list_models`; a
    constructor registered with `register_model` is what `create_model`
    builds under its name and is listed; every listed name builds through
    `create_model` on the meta device and its eval forward traces to
    (1, classes), as JAX's `tests/test_registry.py` traces shapes without
    real weights;
  * `quant.statsq_quantize_4d` (the reference's `StatsQuantizer_4d`)
    bit-exact in its forward values against JAX's on seeded inputs whose
    sums are exact (dyadic values, an all-zero slice at the 1e-12 floor)
    and on rounding ties, and its straight-through gradient exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_quant import _dyadic, _eager, _statsq_ties

from ofq_tpu import models as jmodels
from ofq_tpu.quant import statsq as jstatsq
from ofq_tpu_torch import models
from ofq_tpu_torch.models import deit, registry
from ofq_tpu_torch.quant import (QuantPolicy, statsq_quantize_4d,
                                 w2a2_qkr_policy, w2a2_qkr_swin_policy)


def test_list_models_is_jaxs():
    assert models.list_models() == jmodels.list_models()
    assert models.list_models() == sorted(models.list_models())


def test_register_model_round_trips(monkeypatch):
    """A registered name: listed, built by `create_model` through its
    constructor (with the policy and the overrides), initialised and
    placed as the built-in names are; the registry comes before the DeiT
    table, so a registered built-in name takes the constructor."""
    monkeypatch.setattr(registry, "_REGISTRY", {})
    calls = []

    @models.register_model("deit_registered_test")
    def build(policy, **overrides):
        calls.append((policy, overrides))
        return deit.deit_model("deit_test_distilled", policy, **overrides)

    assert build.__name__ == "build"
    assert "deit_registered_test" in models.list_models()
    assert len(models.list_models()) == len(jmodels.list_models()) + 1
    pol = w2a2_qkr_policy(2)
    m = models.create_model("deit_registered_test", policy=pol,
                            device="cpu", num_classes=7,
                            generator=torch.Generator().manual_seed(1))
    assert calls == [(pol, {"num_classes": 7})]
    assert isinstance(m, deit.VisionTransformer) and not m.training
    want = models.create_model("deit_test_distilled", policy=pol,
                               device="cpu", num_classes=7,
                               generator=torch.Generator().manual_seed(1))
    got, ref = m.state_dict(), want.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    models.register_model("deit_tiny_patch16_224")(build)
    models.create_model("deit_tiny_patch16_224", policy=pol, device="cpu")
    assert len(calls) == 2
    with pytest.raises(KeyError, match="deit_registered_test"):
        models.create_model("no_such_model", policy=pol, device="cpu")


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "w2a2"])
@pytest.mark.parametrize("name", jmodels.list_models())
def test_listed_name_builds_and_traces(name, quantized):
    """Every listed name through `create_model` on the meta device, float
    and W2A2 QKR: the published geometry's eval forward traces to (1,
    num_classes)."""
    swin = name.startswith("swin")
    pol = QuantPolicy()
    if quantized:
        pol = w2a2_qkr_swin_policy() if swin else w2a2_qkr_policy(12)
    with torch.device("meta"):
        m = models.create_model(name, policy=pol, device="meta")
    s = m.cfg.img_size
    out = m(torch.empty(1, s, s, 3, device="meta"))
    assert out.shape == (1, m.cfg.num_classes) and out.is_meta


# ------------------------------------------------------- statsq_quantize_4d
def _ties(rng, n):
    """A (2, 3, 6, 8) tensor whose every axis-2 slice has mean|w| = 0.5
    exactly (scale 1) with entries on the 1/n grid: a rounding tie at each
    unclipped entry."""
    w = _statsq_ties(rng, 48, 6, n)          # (K, slices)
    return np.ascontiguousarray(w.reshape(2, 3, 8, 6).transpose(0, 1, 3, 2))


def _dyadic_4d(rng):
    """Dyadic values (every sum exact, whatever its order) with slice 2
    all zero: its scale is the 1e-12 floor."""
    w = _dyadic(rng, (3, 4, 5, 16))
    w[:, :, 2] = 0.0
    return w


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("make", ["ties", "dyadic"])
def test_statsq_quantize_4d_bit_exact(bits, make):
    rng = np.random.default_rng(bits)
    w = (_ties(rng, 2 ** (bits - 1)) if make == "ties"
         else _dyadic_4d(rng))
    if make == "ties":
        b4 = w * 2 ** (bits - 1) - 0.5
        unclipped = np.abs(w) < 1.0
        assert np.mean((b4 - np.floor(b4))[unclipped] == 0.5) > 0.9
    j = _eager(jstatsq.statsq_quantize_4d, jnp.asarray(w), bits)
    t = statsq_quantize_4d(torch.from_numpy(w), bits).numpy()
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t, j)
    if make == "dyadic":
        # the zero slice at the floor's lowest non-negative half level
        n = np.float32(2 ** (bits - 1))
        assert np.all(t[:, :, 2] == np.float32(1e-12) * (0.5 / n))


@pytest.mark.parametrize("bits", [2, 4])
def test_statsq_quantize_4d_ste_gradient(bits):
    """The straight-through gradient: the cotangent passed to w as it is,
    in both frameworks (a seeded cotangent, the dyadic input)."""
    rng = np.random.default_rng(10 + bits)
    w = _dyadic_4d(rng)
    g = rng.normal(size=w.shape).astype(np.float32)
    jg = _eager(lambda x: jax.vjp(
        lambda y: jstatsq.statsq_quantize_4d(y, bits), x)[1](
            jnp.asarray(g))[0], jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    statsq_quantize_4d(wt, bits).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(wt.grad.numpy(), jg)
    np.testing.assert_array_equal(wt.grad.numpy(), g)
