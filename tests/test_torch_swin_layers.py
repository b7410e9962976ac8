"""The Swin geometry and modules of `ofq_tpu_torch.models.swin` against
`ofq_tpu.models.swin`, on the CPU.

  * geometry (window partition and reverse, padding, the cyclic shift and
    its mask, the relative-position index): equal to the JAX functions,
    including a padded map (10x10, window 4) and a shift that is turned
    off (window >= map);
  * modules, in fp64 through the composed path: the float
    `SwinAttention`, `QSwinAttentionQKR` with and without a shift,
    `PatchMerging` float and quantized on an odd map, `SwinBlock`, and a
    Swin-T-width stage-0 block (dim 96, 3 heads, window 7) on a 14x14 map.
    Each case inits the Flax module, carries its variables over with
    `load_flax_params` into the port's module in fp64 (the relative-position
    bias table is created in fp64 under x64), checks the port's `calibrate` against Flax's
    data-dependent init (quantized modules), then compares the forward
    with every zero-initialised shift set to a random value (rtol 1e-10,
    as `test_torch_port_layers.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_common import (jit_x64_apply, jit_x64_init, load_into,
                                    perturb, x64)
from test_torch_port_layers import _check_fp64, _out

from ofq_tpu.models import swin as jswin
from ofq_tpu.quant import default_swin_qmodules, policy_from_args
from ofq_tpu_torch.models import swin as tswin
from ofq_tpu_torch.quant import QuantPolicy, w2a2_qkr_swin_policy

B = 2


def _map(seed, h, w, c, positive=False):
    x = np.random.default_rng(seed).normal(size=(B, h, w, c))
    return np.abs(x) if positive else x


def _jax_policy(depths=(1, 1)):
    return policy_from_args(wq_bitw=2, aq_bitw=2, qk_reparam=True,
                            qk_reparam_type=0,
                            qmodules=default_swin_qmodules(depths))


# ---------------------------------------------------------------- geometry
@pytest.mark.parametrize("w", [3, 4, 7])
def test_rel_pos_index(w):
    np.testing.assert_array_equal(tswin._rel_pos_index(w, w),
                                  jswin._rel_pos_index(w, w))


@pytest.mark.parametrize("pad_h,pad_w,window,shift", [
    (8, 8, 4, 2), (12, 12, 4, 2), (56, 56, 7, 3), (14, 21, 7, 3)])
def test_shift_attn_mask(pad_h, pad_w, window, shift):
    want = jswin._shift_attn_mask(pad_h, pad_w, window, shift)
    got = tswin._shift_attn_mask(pad_h, pad_w, window, shift)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_window_partition_and_reverse():
    x = _map(0, 8, 12, 5)
    got = tswin.window_partition(torch.from_numpy(x), 4)
    with x64():
        want = np.asarray(jswin.window_partition(jnp.asarray(x), 4))
    np.testing.assert_array_equal(got.numpy(), want)
    back = tswin.window_reverse(got, 4, B, 8, 12)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("h,w,window,shift", [
    (8, 8, 4, 2),     # no padding, shifted
    (10, 10, 4, 2),   # padded to 12x12, shifted
    (10, 10, 4, 0),   # padded, not shifted
    (3, 3, 4, 2),     # window >= the padded map: the shift is turned off
    (7, 7, 7, 3),     # Swin-T stage 3: one window, no shift
])
def test_pad_shift_and_back(h, w, window, shift):
    x = _map(1, h, w, 3)
    with x64():
        jx, jh, jw, js = jswin._pad_shift(jnp.asarray(x), window, shift)
        jback = jswin._unshift_unpad(jx, h, w, js)
    tx, th, tw, ts = tswin._pad_shift(torch.from_numpy(x), window, shift)
    assert (th, tw, ts) == (jh, jw, js)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    back = tswin._unshift_unpad(tx, h, w, ts)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    np.testing.assert_array_equal(back.numpy(), x)


# ----------------------------------------------------------------- modules
def _check_float_fp64(jmod, tmod, x, seed=0):
    """Float modules: the forward in fp64 with random biases."""
    variables = jit_x64_init(jmod, jax.random.key(seed), x)
    shifted = perturb(variables, np.random.default_rng(seed))
    yj = np.asarray(_out(jit_x64_apply(jmod, shifted, x)))
    load_into(tmod, shifted)
    with torch.no_grad():
        yt = tmod(torch.from_numpy(x)).numpy()
    assert yt.dtype == np.float64 and yt.shape == yj.shape
    np.testing.assert_allclose(yt, yj, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("h,shift", [(8, 0), (8, 2), (10, 2)])
def test_swin_attention_float(h, shift):
    x = _map(2, h, h, 24)
    _check_float_fp64(
        jswin.SwinAttention(dim=24, num_heads=3, window_size=4,
                            shift_size=shift),
        tswin.SwinAttention(24, 3, 4, shift).double(), x)


@pytest.mark.parametrize("quantize_softmax", [True, False])
@pytest.mark.parametrize("h,shift", [(8, 0), (8, 2), (10, 2)])
def test_qswin_attention_qkr(h, shift, quantize_softmax):
    x = _map(3, h, h, 24)
    kw = dict(weight_bits=2, input_bits=2, quantize_softmax=quantize_softmax)
    _check_fp64(
        jswin.QSwinAttentionQKR(dim=24, num_heads=3, window_size=4,
                                shift_size=shift, **kw),
        tswin.QSwinAttentionQKR(24, 3, 4, shift, **kw).double(), x)


def _cfg(**kw):
    return dataclasses.replace(tswin.SwinConfig(window_size=4), **kw)


def _jcfg(**kw):
    return dataclasses.replace(jswin.SwinConfig(window_size=4), **kw)


@pytest.mark.parametrize("h", [8, 7])
def test_patch_merging_quantized(h):
    """The odd map is padded; the reduction's input scale runs along the
    merged map's width (4 entries)."""
    x = _map(4, h, h, 12)
    pol = _jax_policy()
    jm = jswin.PatchMerging(dim=12, policy=pol, qpath="features.2.reduction")
    tm = tswin.PatchMerging(12, _cfg(), w2a2_qkr_swin_policy((1, 1)),
                            "features.2.reduction", (h + 1) // 2)
    _check_fp64(jm, tm, x)
    assert tuple(tm.reduction.input_quant.s.shape) == ((h + 1) // 2,)
    assert tm.reduction.bias is not None


@pytest.mark.parametrize("h", [8, 7])
def test_patch_merging_float(h):
    x = _map(5, h, h, 12)
    jm = jswin.PatchMerging(dim=12, policy=jswin.QuantPolicy(),
                            qpath="features.2.reduction")
    tm = tswin.PatchMerging(12, _cfg(), QuantPolicy(),
                            "features.2.reduction", (h + 1) // 2)
    _check_float_fp64(jm, tm, x)
    assert tm.reduction.bias is None


def _block_pair(dim, heads, window, shift, width, quantized, **cfg_kw):
    paths = dict(attn_path="features.1.1.attn", mlp_path="features.1.1.mlp")
    jpol = _jax_policy((2, 2)) if quantized else jswin.QuantPolicy()
    tpol = w2a2_qkr_swin_policy((2, 2)) if quantized else QuantPolicy()
    jm = jswin.SwinBlock(cfg=_jcfg(window_size=window, **cfg_kw),
                         policy=jpol, dim=dim, num_heads=heads, shift=shift,
                         **paths)
    tm = tswin.SwinBlock(_cfg(window_size=window, **cfg_kw), tpol, dim,
                         heads, shift, paths["attn_path"], paths["mlp_path"],
                         width)
    return jm, tm.double()


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_quantized(shift):
    jm, tm = _block_pair(24, 3, 4, shift, 8, True)
    _check_fp64(jm, tm, _map(6, 8, 8, 24))
    # the MLP's input scales run along the map's width
    assert tuple(tm.mlp.fc1.input_quant.s.shape) == (8,)


def test_swin_block_float():
    jm, tm = _block_pair(24, 3, 4, 2, 8, False)
    _check_float_fp64(jm, tm, _map(7, 8, 8, 24))


def test_swin_t_width_stage0_block():
    """Swin-T's stage-0 width (dim 96, 3 heads, window 7), shifted by 3,
    on a 14x14 map (2x2 windows)."""
    jm, tm = _block_pair(96, 3, 7, 3, 14, True)
    _check_fp64(jm, tm, _map(8, 14, 14, 96))
    assert tuple(tm.attn.quan_softmax.s.shape) == (49,)
    assert tuple(tm.attn.relative_position_bias_table.shape) == (169, 3)
