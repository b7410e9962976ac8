"""CGA's pieces against `ofq_tpu`, on numpy inputs from a seed:

  * `cga_band_mask` and `outer_freeze_mask` in fp64, fp32 and on bf16
    weights, on images built to sit on and next to the band edges and at
    the level range's ends.  On weights whose scales are exact in any
    summation order the masks are equal element for element; on images
    built within ulps of the edges an element may differ only where its
    two images lie within a few ulps of each other across an edge, in a
    column whose scale the two frameworks summed to another value (the
    count is printed);
  * `statsq_quantize_cga` equals `statsq_quantize` in value and gradient;
  * `is_cga_kernel` and `freeze_masks` over every parameter of
    `deit_test_distilled` (QKR, and the non-QKR tree's names) and of
    `swin_test`, against JAX's selection over the Flax trees;
  * `mask_grads` and `restore_frozen` keep the dtype and select exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_common import to_jax_tree, to_numpy_tree, x64

from ofq_tpu.models import swin as jswin
from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.quant import (default_deit_qmodules, default_swin_qmodules,
                           policy_from_args)
from ofq_tpu.quant import statsq as jstatsq
from ofq_tpu.train import cga as jcga
from ofq_tpu_torch.convert import flatten_flax_tree, load_flax_params
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.quant import (cga_band_mask, outer_freeze_mask,
                                 statsq_b4_round, statsq_quantize,
                                 statsq_quantize_cga, w2a2_qkr_policy,
                                 w2a2_qkr_swin_policy)
from ofq_tpu_torch.train import (freeze_masks, is_cga_kernel, mask_grads,
                                 restore_frozen)

BR = 0.005
DTYPES = {"float64": (np.float64, torch.float64),
          "float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _edge_images(rng, shape, bits, br, dtype, spread=1.0):
    """Pre-round images on the band edges 0.5 +- br of each level (levels
    drawn from [-n - 1, n - 1) scaled by `spread` toward -1), one and two
    ulps to either side, and Gaussian filler of scale n * spread / 2."""
    n = 2 ** (bits - 1)
    levels = np.round(-1 + spread * (rng.integers(-n - 1, n, size=shape)
                                     + 1)).astype(np.float64)
    edge = levels + 0.5 + rng.choice([-br, br], size=shape)
    steps = rng.integers(-2, 3, size=shape)
    b4 = edge.astype(dtype)
    for _ in range(2):
        b4 = np.where(steps > 0, np.nextafter(b4, np.inf, dtype=dtype), b4)
        b4 = np.where(steps < 0, np.nextafter(b4, -np.inf, dtype=dtype), b4)
        steps = steps - np.sign(steps)
    filler = rng.normal(size=shape) * n * spread / 2
    return np.where(rng.uniform(size=shape) < 0.25, filler.astype(dtype), b4)


def _edge_weights(rng, shape, bits, br, dtype, quantum=None):
    """Weights whose StatsQ images sit on and next to the band edges and at
    the clip's ends.  Each column is built for scale 1 (w = (b4 + 0.5) /
    n, levels near -1 so that the mean |w| stays under 1/2), and its last
    entry brings the mean |w| to 1/2 (its image is clipped at the top end;
    the first row holds the bottom end).  With `quantum` every weight is a
    multiple of it, so that with K a power of two the column sums, and so
    the scales, are exact in any order."""
    n = 2 ** (bits - 1)
    K, N = shape
    b4 = _edge_images(rng, (K - 1, N), bits, br, np.float64, spread=0.5)
    b4[0] = -n - 0.5
    w = (b4 + 0.5) / n
    if quantum is not None:
        w = np.round(w / quantum) * quantum
    bal = K / 2 - np.abs(w).sum(0)
    assert np.all(bal > 1.0)
    return np.concatenate([w, bal[None]], 0).astype(dtype)


def _masks_both(w, bits, br, tdt):
    """(port's mask, JAX's mask, port's image, JAX's image, port's scale,
    JAX's scale) of `w` in the torch dtype `tdt` (JAX gets the same
    values in its dtype)."""
    wt = torch.from_numpy(w).to(tdt)
    with x64():
        wj = jnp.asarray(wt.float().numpy() if tdt == torch.bfloat16
                         else wt.numpy())
        if tdt == torch.bfloat16:
            wj = wj.astype(jnp.bfloat16)
        want = np.asarray(jstatsq.outer_freeze_mask(wj, bits, br))
        b4_j, s_j = (np.asarray(a) for a in jstatsq.statsq_b4_round(wj, bits))
    got = outer_freeze_mask(wt, bits, br)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    b4_t, s_t = (a.numpy() for a in statsq_b4_round(wt, bits))
    return got.numpy(), want, b4_t, b4_j, s_t, s_j


def _near_edges(b4, br, within):
    frac = b4 - np.floor(b4)
    return int(np.sum(np.minimum(np.abs(frac - (0.5 - br)),
                                 np.abs(frac - (0.5 + br))) <= within))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("bits,br", [(2, BR), (4, 0.1)])
def test_cga_band_mask(dtype, bits, br):
    npdt, tdt = DTYPES[dtype]
    b4 = _edge_images(np.random.default_rng(bits), (64, 48), bits, br, npdt)
    with x64():
        for lo, hi in ((None, None), (-1, 0)):
            want = np.asarray(jstatsq.cga_band_mask(
                jnp.asarray(b4), bits, br, level_lo=lo, level_hi=hi))
            got = cga_band_mask(torch.from_numpy(b4), bits, br, level_lo=lo,
                                level_hi=hi).numpy()
            np.testing.assert_array_equal(got, want)
            assert 0 < got.mean() < 1


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("bits,br", [(2, BR), (4, 0.1)])
def test_outer_freeze_mask(dtype, bits, br):
    """Weights on a grid of 2^-6 (2^-14 in fp64), 64 to a column, so that
    both frameworks' scales are exact: the masks are equal element for
    element, with hundreds of images near a band edge and the level
    range's bottom end reached."""
    _, tdt = DTYPES[dtype]
    quantum = 2.0 ** (-14 if dtype == "float64" else -6)
    w = _edge_weights(np.random.default_rng(10 + bits), (64, 40), bits, br,
                      np.float64, quantum=quantum)
    got, want, b4_t, b4_j, s_t, s_j = _masks_both(w, bits, br, tdt)
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(b4_t, b4_j)
    np.testing.assert_array_equal(got, want)
    assert _near_edges(b4_t, br, 2.0 ** -4) >= 200
    assert np.round(b4_t).min() == -2 ** (bits - 1)
    assert 0 < (got == 0).mean() < 1


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("bits,br", [(2, BR), (4, 0.1)])
def test_outer_freeze_mask_at_the_ulp(dtype, bits, br):
    """Images built to lie on the band edges and one and two ulps off them
    (any weights).  The two frameworks sum a column's mean |w| in other
    orders, so a scale may differ by a few ulps (at most 4 here) and move
    an image across an edge.  Every element that differs lies in a column
    whose scale moved, its two images at most 4 ulps apart with an edge
    between (or on) them; the rest are equal.  The count is printed
    (measured: 231 and 268 of 3 840 at W2, 227 and 189 at W4, fp64 and
    fp32)."""
    npdt, tdt = DTYPES[dtype]
    w = _edge_weights(np.random.default_rng(12), (96, 40), bits, br,
                      np.float64).astype(npdt)
    got, want, b4_t, b4_j, s_t, s_j = _masks_both(w, bits, br, tdt)
    assert np.all(np.abs(s_t - s_j) <= 4 * np.spacing(s_t))
    moved = np.broadcast_to(s_t != s_j, got.shape)
    ft, fj = b4_t - np.floor(b4_t), b4_j - np.floor(b4_j)
    between = np.floor(b4_t) != np.floor(b4_j)
    for e in (0.5 - br, 0.5 + br):
        between |= (np.minimum(ft, fj) <= e) & (np.maximum(ft, fj) >= e)
    close = np.abs(b4_t - b4_j) <= 4 * np.spacing(np.abs(b4_t) + 1)
    differ = got != want
    assert not np.any(differ & ~(moved & between & close))
    assert not np.any(differ & (b4_t == b4_j))
    assert _near_edges(b4_t, br, 4 * np.spacing(npdt(2.0))) >= 1000
    print(f"{dtype} W{bits}: {int(differ.sum())} of {differ.size} masks "
          f"differ, each across an edge in a column whose scale moved "
          f"({int((s_t != s_j).sum())} of {s_t.size} columns)")


def test_freeze_mask_bf16_is_its_fp32_view():
    """bf16 weights: the band test runs on the fp32 image, so the mask is
    that of the weights' fp32 view (the port keeps bf16 masters' fp32
    working copies)."""
    w = torch.from_numpy(np.random.default_rng(6).normal(size=(256, 384))
                         ).to(torch.bfloat16)
    m16 = outer_freeze_mask(w, 8, BR)
    assert torch.equal(m16, outer_freeze_mask(w.float(), 8, BR))
    trainable = float((m16 == 0).float().mean())
    assert 0.0 < trainable < 0.1


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_statsq_quantize_cga_is_statsq(dtype):
    _, tdt = DTYPES[dtype]
    w_np = np.random.default_rng(3).normal(size=(24, 12))
    g_np = np.random.default_rng(4).normal(size=(24, 12))
    outs = []
    for fn in (lambda w: statsq_quantize(w, 2),
               lambda w: statsq_quantize_cga(w, 2, BR, training=True)):
        w = torch.from_numpy(w_np).to(tdt).requires_grad_()
        y = fn(w)
        y.backward(torch.from_numpy(g_np).to(tdt))
        outs.append((y.detach(), w.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    with x64():
        want = np.asarray(jstatsq.statsq_quantize_cga(
            jnp.asarray(w_np, dtype), 2, BR, training=True))
        plain = np.asarray(jstatsq.statsq_quantize(jnp.asarray(w_np, dtype),
                                                   2))
    np.testing.assert_array_equal(want, plain)
    # the scale's mean is summed in another order: an ulp apart
    np.testing.assert_allclose(outs[1][0].numpy(), want, atol=0,
                               rtol=3 * np.finfo(dtype).eps)


# ------------------------------------------------------------ selection
DEPTH, IMG = 2, 32


def _jax_deit(qk_reparam):
    return jax_deit_model("deit_test_distilled", policy_from_args(
        wq_bitw=2, aq_bitw=2, qk_reparam=qk_reparam, qk_reparam_type=1,
        qmodules=default_deit_qmodules(DEPTH)))


def _jax_swin():
    return jswin.swin_model("swin_test", policy_from_args(
        wq_bitw=2, aq_bitw=2, qk_reparam=True,
        qmodules=default_swin_qmodules((1, 1))), depths=(1, 1))


def _jax_params(jm, seed=0):
    x = np.random.default_rng(seed).normal(size=(2, IMG, IMG, 3))
    v = jax.jit(lambda k, xx: jm.init({"params": k}, xx, train=False))(
        jax.random.key(seed), jnp.asarray(x, jnp.float32))
    return to_numpy_tree(v)


def _jax_selection(params, qk_reparam, model_type):
    sel = jax.tree_util.tree_map_with_path(
        lambda p, _: jcga.is_cga_kernel(p, qk_reparam=qk_reparam,
                                        model_type=model_type), params)
    return {k.replace("/", "."): bool(v)
            for k, v in flatten_flax_tree(sel).items()}


@pytest.mark.parametrize("model_type,qk_reparam", [
    ("deit", True), ("deit", False), ("swin", True)])
def test_is_cga_kernel_matches_jax(model_type, qk_reparam):
    """Every parameter name of the JAX tree (the port's names, '.' for
    '/'), selected alike; the port's model has exactly those names (the
    port has no non-QKR attention yet: its names are JAX's tree's)."""
    jm = _jax_deit(qk_reparam) if model_type == "deit" else _jax_swin()
    want = _jax_selection(_jax_params(jm)["params"], qk_reparam, model_type)
    got = {n: is_cga_kernel(n, qk_reparam=qk_reparam, model_type=model_type)
           for n in want}
    assert got == want
    chosen = sorted(n for n, v in got.items() if v)
    if model_type == "deit" and qk_reparam:
        assert chosen == sorted(f"blocks_{i}.{p}" for i in range(DEPTH) for p in (
            "attn.v_kernel", "attn.proj.kernel", "mlp.fc1.kernel",
            "mlp.fc2.kernel"))
    elif model_type == "deit":
        assert chosen == sorted(f"blocks_{i}.{p}" for i in range(DEPTH) for p in (
            "attn.qkv.kernel", "attn.proj.kernel", "mlp.fc1.kernel",
            "mlp.fc2.kernel"))
    else:
        assert "features_2.reduction.kernel" in chosen and len(chosen) == 9
    if qk_reparam:
        tm = (create_model("deit_test_distilled",
                           policy=w2a2_qkr_policy(DEPTH), device="cpu")
              if model_type == "deit" else
              create_model("swin_test", policy=w2a2_qkr_swin_policy((1, 1)),
                           device="cpu", depths=(1, 1)))
        assert set(dict(tm.named_parameters())) == set(want)


@pytest.mark.parametrize("model_type", ["deit", "swin"])
def test_freeze_masks_match_jax(model_type):
    """The masks of a whole model, from the same converted fp32 weights:
    None where JAX has None, equal fp32 0/1 masks elsewhere."""
    jm = _jax_deit(True) if model_type == "deit" else _jax_swin()
    variables = _jax_params(jm, seed=1)
    tm = (create_model("deit_test_distilled", policy=w2a2_qkr_policy(DEPTH),
                       device="cpu") if model_type == "deit" else
          create_model("swin_test", policy=w2a2_qkr_swin_policy((1, 1)),
                       device="cpu", depths=(1, 1)))
    load_flax_params(tm, variables)
    want = jcga.freeze_masks(to_jax_tree(variables["params"], np.float32),
                             bits=2, boundary_range=BR, qk_reparam=True,
                             model_type=model_type)
    want = {k.replace("/", "."): v for k, v in flatten_flax_tree(
        want).items() if v.dtype != object}
    got = freeze_masks(dict(tm.named_parameters()), bits=2,
                       boundary_range=BR, qk_reparam=True,
                       model_type=model_type)
    selected = {n for n, m in got.items() if m is not None}
    assert selected == set(want)
    for n in selected:
        assert got[n].dtype == torch.float32
        np.testing.assert_array_equal(got[n].numpy(), want[n], err_msg=n)


def test_mask_apply_preserves_dtype():
    rng = np.random.default_rng(7)
    old, new, g = (torch.from_numpy(rng.normal(size=(8, 4))).to(
        torch.bfloat16) for _ in range(3))
    m = torch.from_numpy(rng.integers(0, 2, size=(8, 4))).float()
    masks = {"k": m, "other": None}
    mg = mask_grads({"k": g, "other": g}, masks)
    rp = restore_frozen({"k": old, "other": old}, {"k": new, "other": new},
                        masks)
    assert mg["k"].dtype == rp["k"].dtype == torch.bfloat16
    assert mg["other"] is g and rp["other"] is new
    frozen = m.numpy() > 0.5
    np.testing.assert_array_equal(mg["k"].float().numpy(),
                                  np.where(frozen, 0, g.float().numpy()))
    np.testing.assert_array_equal(
        rp["k"].float().numpy(),
        np.where(frozen, old.float().numpy(), new.float().numpy()))
    with x64():
        jg = jcga.mask_grads({"k": jnp.asarray(g.float().numpy(),
                                               jnp.bfloat16)},
                             {"k": jnp.asarray(m.numpy())})
    np.testing.assert_array_equal(np.asarray(jg["k"], np.float32),
                                  mg["k"].float().numpy())
