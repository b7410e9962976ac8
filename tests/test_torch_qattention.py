"""`QAttention`, the quantized attention without the query-key
reparameterization, against `ofq_tpu.nn.attention.QAttention`, on the
CPU, and the students that run it.

  * the module in every form, with the limits of `test_torch_train_layers
    .py` (output, dx and every parameter's gradient): the composition, the
    remat tail and `matmul_impl='pallas'` (JAX's kernel in interpret mode)
    in fp64 (rtol 1e-9; the LSQ scales' and shifts' gradients, summed in
    fp32 on both sides, 1e-5 of the largest of theirs and dx's); the fused
    tail (K2 and K3 per head, their plain versions against JAX's Pallas
    kernels in interpret mode) and 'int8' in fp32 (1e-4 relative, 1e-5 of
    max(1, |ref|)); full-LSQ linears (`lsq_weights`) composed in fp64 and
    fused in fp32; the composition, the fused tail, pallas and int8 in the
    bf16 stream at `test_torch_bf16_layers.py`'s limits;
  * K2's and K3's per-head plain versions against `_attn_core_fwd` /
    `_attn_core_bwd` in interpret mode at the model's K = d = 64 and a
    ragged N, fp32 and bf16, at `test_torch_qkr_scores.py`'s limits;
  * one step of the composed `deit_test_distilled` W2A2 student without
    QKR and of the `swin_test` one (`QSwinAttention`) against JAX's
    jitted step under x64 (`test_torch_kd_telemetry.assert_step`'s
    limits), and one step of the fused DeiT student in fp32 at
    `test_torch_train_slice_fused.py`'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16_layers import B8, _bf16_case, _check_bf16
from test_torch_kd_telemetry import _jax_deit_policy, assert_step, step_case
from test_torch_pallas_layers import jax_pallas_interpret  # noqa: F401
from test_torch_port_common import jax_interpret  # noqa: F401
from test_torch_qkr_scores import BF16_ULP, _np, _share_outside
from test_torch_train_layers import (C, H, N, _check_grads_fp64,
                                     _check_grads_fused_fp32, _tokens)
from test_torch_train_loop import _flat
from test_torch_train_slice import LR, START

from ofq_tpu.nn import attention as jattn
from ofq_tpu.ops.fused_attention import _attn_core_bwd, _attn_core_fwd
from ofq_tpu.quant import default_swin_qmodules, policy_from_args
from ofq_tpu_torch.nn import QAttention
from ofq_tpu_torch.ops import fused_attention as t_attn
from ofq_tpu_torch.quant import w2a2_deit_policy, w2a2_swin_policy
from ofq_tpu_torch.train import cosine_with_warmup_cooldown


def _pair(**kw):
    return (jattn.QAttention(num_heads=H, **kw),
            QAttention(C, H, N, **kw))


@pytest.mark.parametrize("impl,quantize_softmax", [
    ("composed", True), ("composed", False), ("remat", True),
    ("pallas", True)])
def test_qattention_grads_fp64(jax_pallas_interpret, impl, quantize_softmax):
    kw = dict(weight_bits=2, input_bits=2, quantize_softmax=quantize_softmax)
    if impl == "remat":
        kw["attn_impl"] = "remat"
    elif impl != "composed":
        kw["matmul_impl"] = impl
    _, _, gj = _check_grads_fp64(*_pair(**kw), _tokens(40))
    assert np.abs(gj["qkv.kernel"]).max() > 0


def test_qattention_int8_grads_fp32():
    """`matmul_impl='int8'` in fp32 (JAX's int8 VJP does not run under
    x64), at the fused branches' limits."""
    kw = dict(weight_bits=2, input_bits=2)
    jm, tm = _pair(matmul_impl="int8", **kw)
    _check_grads_fused_fp32(jattn.QAttention(num_heads=H, **kw), jm, tm,
                            _tokens(40))


@pytest.mark.parametrize("quantize_softmax", [True, False])
def test_qattention_fused_grads_fp32(jax_interpret, quantize_softmax):
    """The fused tail: K2 and K3 in their per-head form."""
    kw = dict(weight_bits=2, input_bits=2, quantize_softmax=quantize_softmax)
    jm, tm = _pair(matmul_impl="fused", attn_impl="fused", **kw)
    _check_grads_fused_fp32(jattn.QAttention(num_heads=H, **kw), jm, tm,
                            _tokens(41))


def test_qattention_full_lsq():
    """`lsq_weights`: LsqLinear qkv and proj, signed and --wq_asym."""
    for seed, asym in ((42, False), (43, True)):
        kw = dict(weight_bits=2, input_bits=2, lsq_weights=True,
                  wq_all_positive=asym)
        _, _, gj = _check_grads_fp64(*_pair(**kw), _tokens(seed))
        assert np.abs(gj["qkv.weight_quant.s"]).max() > 0


def test_qattention_full_lsq_fused_fp32(jax_interpret):
    kw = dict(weight_bits=2, input_bits=2, lsq_weights=True)
    jm, tm = _pair(matmul_impl="fused", attn_impl="fused", **kw)
    _check_grads_fused_fp32(jattn.QAttention(num_heads=H, **kw), jm, tm,
                            _tokens(44))


@pytest.mark.parametrize("impl", [None, "fused", "pallas", "int8"])
def test_qattention_bf16(jax_interpret, jax_pallas_interpret, impl):
    kw = dict(weight_bits=2, input_bits=2, compute_dtype="bfloat16",
              matmul_impl=impl, attn_impl=impl if impl == "fused" else None)
    _check_bf16(_bf16_case(*_pair(**kw), _tokens(45, shape=(B8, N, C)), 45))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_head_core_at_k64(dtype):
    """K2's and K3's plain versions in the per-head form at the model's
    K = d = 64 (N = 37, no multiple of 16) against the Pallas kernels."""
    rng = np.random.default_rng(46)
    Bc, Nc, Hc, d = 2, 37, 2, 64
    arrs = [rng.normal(size=(Bc, Nc, Hc, d)) * 0.5 for _ in range(2)] + [
        rng.normal(size=(Bc, Nc, Hc, d)) for _ in range(2)]
    ts = [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrs]
    s = torch.from_numpy((rng.random(Nc) * 0.02 + 0.01).astype(np.float32))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    js = [jnp.asarray(t.float().numpy()).astype(jdt) for t in ts]
    ulp = BF16_ULP if dtype == torch.bfloat16 else 0.0
    args = (2, d ** -0.5, True)
    got = t_attn.qkr_attention_fwd_reference(*ts[:3], s, *args)
    want, res = _attn_core_fwd(*js[:3], jnp.asarray(s.numpy()), *args, True)
    assert got.dtype == dtype
    assert _share_outside(got, want, ulp) <= 1e-3
    got = t_attn.qkr_attention_bwd_reference(*ts[:3], s, ts[3], *args)
    want = _attn_core_bwd(*args, True, res, js[3])
    assert got[0].shape == ts[0].shape  # dlhs per head, not summed
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == dtype
        assert _share_outside(a, b, ulp) <= 1e-3
    ds, ds_j = _np(got[3]), _np(want[3])
    np.testing.assert_allclose(ds, ds_j, rtol=1e-4,
                               atol=1e-4 * np.abs(ds_j).max())


# ------------------------------------------------------------ the steps
def test_non_qkr_deit_step_fp64():
    met, jmet, port, jparams = step_case(
        _jax_deit_policy(qk_reparam=False),
        w2a2_deit_policy(2, qk_reparam=False))
    assert_step(met, jmet, port, jparams)
    assert type(port.blocks_0.attn).__name__ == "QAttention"


def test_non_qkr_swin_step_fp64():
    depths = (1, 1)
    jpol = policy_from_args(wq_bitw=2, aq_bitw=2, qk_reparam=False,
                            qmodules=default_swin_qmodules(depths))
    met, jmet, port, jparams = step_case(
        jpol, w2a2_swin_policy(depths, qk_reparam=False), name="swin_test",
        depths=depths)
    assert_step(met, jmet, port, jparams)
    assert type(port.features_1_0.attn).__name__ == "QSwinAttention"


def test_non_qkr_fused_step_fp32(jax_interpret):
    """`test_torch_train_slice_fused.py`'s limits: loss and gradient norm
    to 1e-5 relative; at most 1 % of a leaf's elements farther than
    1e-3 * lr + 1e-6 * |p|, none farther than 2.1 * lr."""
    conf = dict(matmul_impl="fused", attn_impl="fused")
    met, jmet, port, jparams = step_case(
        _jax_deit_policy(qk_reparam=False),
        w2a2_deit_policy(2, qk_reparam=False), conf=conf, dtype=np.float32)
    assert abs(met["loss"] - jmet["loss"]) <= 1e-5 * abs(jmet["loss"])
    assert abs(met["grad_norm"] - jmet["grad_norm"]) <= (
        1e-5 * jmet["grad_norm"])
    lr = cosine_with_warmup_cooldown(5e-3, **LR)(START)
    got = {k: p.detach().numpy() for k, p in port.named_parameters()}
    for k, w in _flat(jparams).items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2.1 * lr, k
        assert np.mean(d > 1e-3 * lr + 1e-6 * np.abs(w)) <= 0.01, k
