"""The original-layout checkpoint converters against `ofq_tpu.convert`.

JAX variables of the test models (DeiT W2A2 QKR with LayerNorm and with
BatchNorm, the float DeiT, Swin W2A2 QKR and float) are written as
`.pth.tar` by the JAX package's exporter; both packages then read them
(`load_torch_state_dict`, `convert_deit`/`convert_swin`,
`split_qkv_for_qkr`, `convert_bn_stats`): the trees are equal bit for
bit.  The port's exporter, fed the port model's own variables
(`convert.model_variables` after `load_flax_params`), writes the JAX
exporter's state dict bit for bit.  `resize_pos_embed` equals JAX's bit
for bit (both are numpy) and torch's bicubic interpolation to 1 fp32
ulp of the grid's largest magnitude; the spatial patch-embedding bias
resampled at another resolution equals `jax.image.resize` to 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_common import to_numpy_tree

from ofq_tpu.convert import torch_export as jexport
from ofq_tpu.convert import torch_import as jimport
from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.models.swin import swin_model as jax_swin_model
from ofq_tpu.quant import (default_deit_qmodules, default_swin_qmodules,
                           policy_from_args)
from ofq_tpu_torch.convert import (flatten_flax_tree, load_flax_params,
                                   model_variables, torch_export,
                                   torch_import)
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.quant import (QuantPolicy, w2a2_qkr_policy,
                                 w2a2_qkr_swin_policy)

SWIN_DEPTHS = (1, 1)


def _jax_policy(family):
    q = (default_swin_qmodules(SWIN_DEPTHS) if family == "swin"
         else default_deit_qmodules(2))
    return policy_from_args(wq_bitw=2, aq_bitw=2, qk_reparam=True,
                            qmodules=q)


CASES = {
    # name: (family, quantized, overrides)
    "deit-qkr": ("deit", True, {}),
    "deit-qkr-bn": ("deit", True, dict(norm_layer="batchnorm")),
    "deit-float": ("deit", False, {}),
    "swin-qkr": ("swin", True, {}),
    "swin-float": ("swin", False, {}),
}


def _perturbed(tree, rng):
    """Every leaf moved off its init (biases and shifts start at 0)."""
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(size=np.shape(a)) * 0.05
                   ).astype(np.asarray(a).dtype)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


@functools.lru_cache(maxsize=None)
def _jax_variables(case):
    family, quantized, over = CASES[case]
    kw = dict(over)
    if quantized:
        kw["policy"] = _jax_policy(family)
    if family == "swin":
        m = jax_swin_model("swin_test", **kw)
    else:
        m = jax_deit_model("deit_test_distilled", **kw)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 32, 32, 3)),
                    jnp.float32)
    v = jax.jit(lambda k, xx: m.init({"params": k}, xx, train=False))(
        jax.random.key(1), x)
    v = to_numpy_tree(v, np.float32)
    v["params"] = _perturbed(v["params"], np.random.default_rng(2))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree.map(
            lambda a: a + np.abs(np.random.default_rng(3).normal(
                size=a.shape)).astype(np.float32), v["batch_stats"])
    return v


def _export_kw(case, v):
    family = CASES[case][0]
    kw = dict(model_type=family, quant_stats=v.get("quant_stats"),
              batch_stats=v.get("batch_stats"))
    if family == "swin":
        kw["depths"] = SWIN_DEPTHS
    return kw


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """{case: (JAX variables, path of the JAX exporter's .pth.tar)}."""
    d = tmp_path_factory.mktemp("pth")
    out = {}
    for case in CASES:
        v = _jax_variables(case)
        sd = jexport.export_state_dict(v["params"], **_export_kw(case, v))
        path = str(d / f"{case}.pth.tar")
        jexport.save_pth_tar(sd, path, arch=case, epoch=3)
        out[case] = (v, path)
    return out


def _assert_trees_equal(got, want):
    g, w = flatten_flax_tree(got), flatten_flax_tree(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _convert(mod, case, sd):
    if CASES[case][0] == "swin":
        return mod.convert_swin(sd, depths=SWIN_DEPTHS, img_size=32)
    return mod.convert_deit(sd, depth=2, img_size=32)


@pytest.mark.parametrize("case", list(CASES))
def test_import_trees_bit_equal(written, case):
    _, path = written[case]
    sd, jsd = (torch_import.load_torch_state_dict(path),
               jimport.load_torch_state_dict(path))
    assert sorted(sd) == sorted(jsd)
    for k in jsd:
        np.testing.assert_array_equal(sd[k], jsd[k], err_msg=k)
    got, want = _convert(torch_import, case, sd), _convert(jimport, case, jsd)
    _assert_trees_equal(got, want)
    _assert_trees_equal(torch_import.convert_bn_stats(sd),
                        jimport.convert_bn_stats(jsd))
    if CASES[case][1]:
        assert "q_kernel" in got[next(k for k in got if "_" in k and
                                      "attn" in got[k])]["attn"]
    else:  # a float tree: split its fused qkv as a QKR warm start does
        _assert_trees_equal(torch_import.split_qkv_for_qkr(got),
                            jimport.split_qkv_for_qkr(want))


@pytest.mark.parametrize("case", list(CASES))
def test_merge_pretrained_equal(written, case):
    """The converted tree overlaid onto the student's own (a QKR student
    for the float checkpoints, after the split) as both runners do."""
    v, path = written[case]
    loaded = torch_import.split_qkv_for_qkr(
        _convert(torch_import, case, torch_import.load_torch_state_dict(
            path)))
    jloaded = jimport.split_qkv_for_qkr(
        _convert(jimport, case, jimport.load_torch_state_dict(path)))
    dest = _jax_variables(case.split("-")[0] + "-qkr")["params"]
    dest = jax.tree.map(lambda a: a * 0 + 1, dest)
    _assert_trees_equal(torch_import.merge_pretrained(dest, loaded),
                        jimport.merge_pretrained(dest, jloaded))


def _port_model(case):
    family, quantized, over = CASES[case]
    name = "swin_test" if family == "swin" else "deit_test_distilled"
    pol = QuantPolicy()
    if quantized:
        pol = (w2a2_qkr_swin_policy(SWIN_DEPTHS) if family == "swin"
               else w2a2_qkr_policy(2))
    return create_model(name, policy=pol, device="cpu", **over)


@pytest.mark.parametrize("case", list(CASES))
def test_export_state_dict_bit_equal(written, case, tmp_path):
    """The port model holding JAX's variables exports JAX's state dict;
    its `.pth.tar` reads back into the same tree."""
    v, _ = written[case]
    port = load_flax_params(_port_model(case), v)
    pv = model_variables(port)
    kw = _export_kw(case, pv)
    got = torch_export.export_state_dict(pv["params"], **kw)
    want = jexport.export_state_dict(v["params"], **_export_kw(case, v))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    path = torch_export.save_pth_tar(got, str(tmp_path / "p.pth.tar"),
                                     arch=case, epoch=1)
    obj = torch.load(path, weights_only=True)
    assert obj["arch"] == case and obj["epoch"] == 1
    _assert_trees_equal(
        _convert(torch_import, case, torch_import.load_torch_state_dict(
            path)),
        _convert(jimport, case, jimport.load_torch_state_dict(path)))


def test_swin_depths_from_params(written):
    v, _ = written["swin-qkr"]
    assert torch_export.swin_depths_from_params(v["params"]) == \
        jexport.swin_depths_from_params(v["params"]) == SWIN_DEPTHS


@pytest.mark.parametrize("old,new,prefix", [(14, 24, 2), (24, 14, 1),
                                            (7, 9, 0)])
def test_resize_pos_embed(old, new, prefix):
    rng = np.random.default_rng(old * new)
    pos = rng.normal(size=(1, prefix + old * old, 16)).astype(np.float32)
    got = torch_import.resize_pos_embed(pos, prefix + new * new)
    want = jimport.resize_pos_embed(pos, prefix + new * new)
    np.testing.assert_array_equal(got, want)
    grid = torch.from_numpy(pos[0, prefix:].reshape(1, old, old, -1)
                            ).permute(0, 3, 1, 2).double()
    ref = torch.nn.functional.interpolate(
        grid, size=(new, new), mode="bicubic", align_corners=False)
    ref = ref.permute(0, 2, 3, 1).reshape(1, new * new, -1).float().numpy()
    np.testing.assert_array_equal(got[:, :prefix], pos[:, :prefix])
    ulp = float(np.spacing(np.float32(np.abs(ref).max())))
    assert float(np.abs(got[:, prefix:] - ref).max()) <= ulp


@pytest.mark.parametrize("side,img", [(4, 32), (32, 20), (16, 24)])
def test_spatial_bias_resize_matches_jax_image_resize(side, img):
    b = np.random.default_rng(side).normal(size=(side, side)).astype(
        np.float32)
    got = torch_import._jax_bilinear_resize(b, (img, img))
    want = np.asarray(jax.image.resize(jnp.asarray(b), (img, img),
                                       method="bilinear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


class Opaque:
    """An object `weights_only` loading refuses."""


def test_load_torch_state_dict_reads_weights_only(tmp_path):
    """Nested layouts and `module.` prefixes; bf16 as fp32; a file holding
    a pickled object other than tensors and containers is refused."""
    w = torch.randn(3, 2)
    torch.save({"model": {"module.a.weight": w,
                          "b": w.to(torch.bfloat16)}}, tmp_path / "m.pth")
    sd = torch_import.load_torch_state_dict(str(tmp_path / "m.pth"))
    assert sorted(sd) == ["a.weight", "b"] and sd["b"].dtype == np.float32
    np.testing.assert_array_equal(sd["a.weight"], w.numpy())

    torch.save({"state_dict": {"a": w}, "obj": Opaque()}, tmp_path / "o.pt")
    with pytest.raises(Exception):
        torch_import.load_torch_state_dict(str(tmp_path / "o.pt"))
