"""The slice as a whole: the port's DeiT W2A2 QKR serving forward vs the
JAX package, at `deit_test_distilled` size (img 32, patch 8, dim 24,
depth 2, 3 heads).

  (a) composed config, fp64: logits within rtol 1e-9;
  (b) fused config, fp32: logits within atol 1e-4 of the JAX fused config
      (Pallas kernels in interpret mode), same argmax;
plus calibration, the strict weight loader and the Predictor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_common import (  # noqa: F401 (jax_interpret: fixture)
    assert_scales_match, jax_calibrate, jax_interpret, load_into, perturb,
    to_jax_tree, to_numpy_tree, x64)

from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.quant import default_deit_qmodules, policy_from_args
from ofq_tpu.serve import Predictor as JaxPredictor
from ofq_tpu_torch.calibrate import calibrate
from ofq_tpu_torch.convert import flatten_flax_tree, load_flax_params
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.quant import QuantPolicy, QuantSpec, w2a2_qkr_policy
from ofq_tpu_torch.serve import Predictor

NAME = "deit_test_distilled"
DEPTH, IMG, CLASSES = 2, 32, 1000


def _jax_policy():
    return policy_from_args(wq_bitw=2, aq_bitw=2, qk_reparam=True,
                            qmodules=default_deit_qmodules(DEPTH))


def _port_policy():
    return w2a2_qkr_policy(DEPTH)


def _images(seed, n=4):
    return np.random.default_rng(seed).normal(size=(n, IMG, IMG, 3))


def _port(impl=None, dtype=torch.float64):
    return create_model(NAME, policy=_port_policy(), device="cpu",
                        matmul_impl=impl, attn_impl=impl).to(dtype)


def _with_heads(variables, rng):
    """Random shifts everywhere and random head kernels (the JAX init
    zeroes them, which would make the logits trivial)."""
    out = perturb(variables, rng)
    for h in ("head", "head_dist"):
        k = out["params"][h]["kernel"]
        out["params"][h]["kernel"] = (rng.normal(size=k.shape) * 0.2).astype(
            k.dtype)
    return out


@pytest.fixture(scope="module")
def fp64_case():
    """JAX variables of the composed model in fp64, scales calibrated
    with the fp64 weights in place, and the JAX logits."""
    x = _images(0)
    jm = jax_deit_model(NAME, _jax_policy())
    with x64():
        variables = to_numpy_tree(
            jm.init({"params": jax.random.key(0)}, jnp.asarray(x),
                    train=False), np.float64)
    variables = jax_calibrate(jm, variables, x, train=False)
    shifted = _with_heads(variables, np.random.default_rng(1))
    with x64():
        logits, _ = jm.apply(to_jax_tree(shifted, np.float64),
                             jnp.asarray(x), train=False)
    return x, variables, shifted, np.asarray(logits)


def test_policy_matches_jax():
    jp, tp = _jax_policy(), _port_policy()
    for f in ("mode", "bit", "per_channel", "learnable", "all_positive",
              "symmetric"):
        assert getattr(tp.weight, f) == getattr(jp.weight, f), f
        assert getattr(tp.act, f) == getattr(jp.act, f), f
    assert tp.qmodules == jp.qmodules
    assert (tp.qk_reparam, tp.quantize_softmax, tp.act_layer) == (
        jp.qk_reparam, jp.quantize_softmax, jp.act_layer)


def test_param_names_are_flax_paths(fp64_case):
    _, variables, _, _ = fp64_case
    flax_names = {k.split("/", 1)[1].replace("/", ".")
                  for k in flatten_flax_tree(variables)}
    m = _port()
    port_names = set(dict(m.named_parameters())) | set(
        dict(m.named_buffers()))
    assert port_names == flax_names


def test_composed_fp64_logits(fp64_case):
    x, _, shifted, logits_j = fp64_case
    m = load_into(_port(), shifted)
    with torch.no_grad():
        logits_t = m(torch.from_numpy(x)).numpy()
    assert logits_t.shape == (4, CLASSES) and logits_t.dtype == np.float64
    assert np.abs(logits_j).max() > 1e-3  # non-trivial logits
    np.testing.assert_allclose(logits_t, logits_j, rtol=1e-9, atol=1e-12)


def test_calibrate_matches_jax_init(fp64_case):
    x, variables, _, _ = fp64_case
    m = load_into(_port(), variables)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith(".s"):
                p.fill_(1.0)
        m.patch_embed.input_quant.signed.fill_(0.0)
    calibrate(m, x)
    assert_scales_match(variables, m)
    assert float(m.patch_embed.input_quant.signed) == 1.0


def test_calibrate_fused_config_uses_composition(fp64_case):
    """A fused-config model calibrates to the same scales: the softmax
    and input scales are fitted on the composition, never through the
    kernels."""
    x, variables, _, _ = fp64_case
    m = load_into(_port("fused"), variables)
    calibrate(m, x)
    assert_scales_match(variables, m)


def test_fused_fp32_logits(jax_interpret):
    x = _images(2).astype(np.float32)
    pol = _jax_policy()
    jm = jax_deit_model(NAME, pol)
    jf = jax_deit_model(NAME, pol, matmul_impl="fused", attn_impl="fused")
    variables = to_numpy_tree(jm.init({"params": jax.random.key(3)},
                                      jnp.asarray(x), train=False))
    shifted = _with_heads(variables, np.random.default_rng(4))
    logits_j, _ = jf.apply(to_jax_tree(shifted, np.float32), jnp.asarray(x),
                           train=False)
    logits_j = np.asarray(logits_j)
    m = load_into(_port("fused", torch.float32), shifted, torch.float32)
    with torch.no_grad():
        logits_t = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(logits_t, logits_j, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(logits_t.argmax(-1), logits_j.argmax(-1))


class TestLoader:
    def _tree(self, fp64_case):
        return {k: dict(v) for k, v in fp64_case[1].items()}

    def test_missing_key(self, fp64_case):
        tree = self._tree(fp64_case)
        del tree["params"]["pos_embed"]
        with pytest.raises(ValueError, match="missing.*pos_embed"):
            load_flax_params(_port(), tree)

    def test_extra_key(self, fp64_case):
        tree = self._tree(fp64_case)
        tree["params"]["not_a_param"] = np.zeros(3)
        with pytest.raises(ValueError, match="unused.*not_a_param"):
            load_flax_params(_port(), tree)

    def test_wrong_shape(self, fp64_case):
        tree = self._tree(fp64_case)
        tree["params"]["cls_token"] = np.zeros((1, 1, 7))
        with pytest.raises(ValueError, match="shape.*cls_token"):
            load_flax_params(_port(), tree)

    def test_missing_quant_stats(self, fp64_case):
        tree = {"params": fp64_case[1]["params"]}
        with pytest.raises(ValueError, match="signed"):
            load_flax_params(_port(), tree)

    def test_flat_npz(self, fp64_case, tmp_path):
        path = tmp_path / "w.npz"
        np.savez(path, **flatten_flax_tree(fp64_case[2]))
        a = load_flax_params(_port(), str(path))
        b = load_flax_params(_port(), fp64_case[2])
        for (k, va), vb in zip(a.state_dict().items(),
                               b.state_dict().values()):
            torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)


class TestPredictor:
    def test_pads_and_trims(self, fp64_case):
        m = load_into(_port(), fp64_case[2], torch.float32)
        p = Predictor(m, batch_size=4, img_size=IMG, device="cpu")
        x = fp64_case[0].astype(np.float32)
        short = p.predict(x[:3])
        full = p.predict(x)
        assert short.shape == (3, CLASSES) and full.shape == (4, CLASSES)
        np.testing.assert_allclose(short, full[:3], rtol=0, atol=1e-7)
        np.testing.assert_allclose(short.sum(-1), 1.0, atol=1e-5)
        with pytest.raises(ValueError):
            p.predict(np.concatenate([x, x]))

    def test_matches_jax_predictor(self, fp64_case):
        x = fp64_case[0].astype(np.float32)
        shifted = fp64_case[2]
        jp = JaxPredictor(jax_deit_model(NAME, _jax_policy()),
                          to_jax_tree(shifted, np.float32), batch_size=4,
                          img_size=IMG)
        m = load_into(_port(), shifted, torch.float32)
        p = Predictor(m, batch_size=4, img_size=IMG, device="cpu")
        np.testing.assert_allclose(p.predict(x[:3]), jp.predict(x[:3]),
                                   rtol=0, atol=1e-4)

    def test_from_flax_npz(self, fp64_case, tmp_path):
        path = tmp_path / "w.npz"
        np.savez(path, **flatten_flax_tree(fp64_case[2]))
        p = Predictor.from_flax_npz(
            str(path), model_name=NAME, policy=_port_policy(),
            matmul_impl="fused", attn_impl="fused", batch_size=4,
            device="cpu")
        m = load_into(_port("fused", torch.float32), fp64_case[2],
                      torch.float32)
        ref = Predictor(m, batch_size=4, img_size=IMG, device="cpu")
        x = fp64_case[0].astype(np.float32)
        np.testing.assert_array_equal(p.predict(x), ref.predict(x))

    def test_cuda_default_raises_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        m = _port(dtype=torch.float32)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Predictor(m, batch_size=4, img_size=IMG)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_model(NAME, policy=_port_policy())


def test_unsupported_configs_raise():
    with pytest.raises(NotImplementedError, match="Swin"):
        create_model("swin_t", policy=_port_policy(), device="cpu")
    non_qkr = dataclasses.replace(_port_policy(), qk_reparam=False)
    with pytest.raises(NotImplementedError, match="non-QKR"):
        create_model(NAME, policy=non_qkr, device="cpu")
    with pytest.raises(NotImplementedError, match="float"):
        create_model(NAME, policy=QuantPolicy(), device="cpu")
    lsq = dataclasses.replace(_port_policy(),
                              weight=QuantSpec(mode="lsq", bit=2))
    with pytest.raises(NotImplementedError, match="LsqLinear"):
        create_model(NAME, policy=lsq, device="cpu")
