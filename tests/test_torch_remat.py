"""Rematerialization against the same forward without it, on the CPU, with
dropout and drop-path on (masks from one seeded generator).

  * block remat (`DeiTConfig.remat`, `SwinConfig.remat_stages`): the
    checkpointed blocks' outputs and every gradient bit for bit equal to
    the plain model's from a generator seeded alike, the blocks' forwards
    run twice (the recompute), and the generator left where the plain
    model leaves it (the recompute replays the block's masks and puts the
    generator back);
  * the checkpointed attention tail (`attn_impl='remat'`, DeiT and Swin,
    bias and shift mask inside the checkpoint): bit for bit equal to the
    same tail with `torch.utils.checkpoint` replaced by a direct call, in
    fp32 and in the bf16 stream; with attention dropout in train mode the
    composition runs (bit for bit `attn_impl=None`);
  * `attn_impl='remat'` against JAX's remat tail in fp64, mask for mask
    (the limits of `test_torch_dropout.py`; the patched mask source
    ignores the generator, so block remat, whose recompute draws again, is
    held to the plain port above and not here).
"""

import numpy as np
import pytest
import torch

from test_torch_dropout import (RATES, SWIN, _assert_parity, _images,
                                _jitted_init, masks)  # noqa: F401
from test_torch_swin_model import _jax_policy as _jax_swin_policy
from test_torch_swin_model import _with_head
from test_torch_train_loop import DEPTH, NAME, _jax_policy

import ofq_tpu_torch.nn.attention as tattn
from ofq_tpu.models import deit as jdeit
from ofq_tpu.models import swin as jswin
from ofq_tpu_torch.calibrate import calibrate
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.quant import (QuantPolicy, w2a2_qkr_policy,
                                 w2a2_qkr_swin_policy)

DEPTHS = (2, 2)


def _model(name, quantized, dtype=torch.float32, **kw):
    if name == NAME:
        pol = w2a2_qkr_policy(DEPTH) if quantized else QuantPolicy()
    else:
        pol = w2a2_qkr_swin_policy(DEPTHS) if quantized else QuantPolicy()
        kw.setdefault("depths", DEPTHS)
    m = create_model(name, policy=pol, device="cpu", head_std=0.02,
                     generator=torch.Generator().manual_seed(0), **kw)
    if dtype == torch.float64:
        m.double()
    if quantized:
        calibrate(m, _images(5, 4))
    return m.train()


def _run(model, x, seed=3):
    """Outputs, every parameter's gradient of a seeded loss, the
    generator's state after the backward."""
    g = torch.Generator().manual_seed(seed)
    out = model(x, g)
    outs = out if isinstance(out, tuple) else (out,)
    w = np.random.default_rng(11)
    loss = sum((o * torch.from_numpy(w.normal(size=o.shape)).to(o.dtype)
                ).sum() for o in outs)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return ([o.detach() for o in outs],
            {n: gi for n, gi in zip(params, grads) if gi is not None},
            g.get_state())


def _assert_bit_equal(a, b):
    (oa, ga, sa), (ob, gb, sb) = a, b
    assert all(torch.equal(x, y) for x, y in zip(oa, ob))
    assert set(ga) == set(gb) and len(ga) > 10
    for n in ga:
        assert torch.equal(ga[n], gb[n]), n
    assert torch.equal(sa, sb)


def _count_forwards(model, names):
    seen = []
    for n in names:
        getattr(model, n).register_forward_pre_hook(
            lambda mod, a, n=n: seen.append(n))
    return seen


@pytest.mark.parametrize("quantized,conf", [
    (True, dict()), (True, dict(matmul_impl="fused", attn_impl="fused")),
    (True, dict(attn_impl="remat")), (False, dict())])
def test_deit_block_remat_bit_for_bit(quantized, conf):
    x = torch.from_numpy(_images(0, 4).astype(np.float32))
    plain = _model(NAME, quantized, **conf, **RATES)
    remat = _model(NAME, quantized, remat=True, **conf, **RATES)
    remat.load_state_dict(plain.state_dict())
    seen = _count_forwards(remat, remat.block_names)
    _assert_bit_equal(_run(plain, x), _run(remat, x))
    # each block ran in the forward and again in the recompute
    assert sorted(seen) == sorted(remat.block_names * 2)


@pytest.mark.parametrize("quantized,conf", [
    (True, dict()), (True, dict(attn_impl="remat")),
    (True, dict(compute_dtype="bfloat16", matmul_impl="pallas")),
    (False, dict())])
def test_swin_stage_remat_bit_for_bit(quantized, conf):
    x = torch.from_numpy(_images(0, 4).astype(np.float32))
    plain = _model(SWIN, quantized, **conf, **RATES)
    remat = _model(SWIN, quantized, remat_stages=(0, 1), **conf, **RATES)
    remat.load_state_dict(plain.state_dict())
    blocks = sorted(remat.remat_names)
    assert blocks == ["features_1_0", "features_1_1", "features_3_0",
                      "features_3_1"]
    seen = _count_forwards(remat, blocks)
    _assert_bit_equal(_run(plain, x), _run(remat, x))
    assert sorted(seen) == sorted(blocks * 2)
    # one stage only: the other's blocks run once
    one = _model(SWIN, quantized, remat_stages=(1,), **conf, **RATES)
    one.load_state_dict(plain.state_dict())
    assert sorted(one.remat_names) == ["features_3_0", "features_3_1"]
    _assert_bit_equal(_run(plain, x), _run(one, x))


def _direct(fn, *args, use_reentrant=None):
    return fn(*args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", [NAME, SWIN])
def test_attention_tail_remat_bit_for_bit(monkeypatch, name, dtype):
    """attn_impl='remat' with and without the checkpoint: the same bits;
    drop_rate and drop_path on, attention dropout 0 (so the tail runs)."""
    cd = None if dtype == "float32" else dtype
    rates = dict(drop_rate=0.1, drop_path_rate=0.2)
    x = torch.from_numpy(_images(0, 4).astype(np.float32))
    m = _model(name, True, attn_impl="remat", compute_dtype=cd, **rates)
    calls = []
    real = tattn.remat_attention_tail
    monkeypatch.setattr(tattn, "remat_attention_tail",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    if name == SWIN:
        import ofq_tpu_torch.models.swin as tswin
        monkeypatch.setattr(tswin, "remat_attention_tail",
                            tattn.remat_attention_tail)
    a = _run(m, x)
    n_attn = DEPTH if name == NAME else sum(DEPTHS)
    assert len(calls) == n_attn
    monkeypatch.setattr(tattn, "checkpoint", _direct)
    _assert_bit_equal(a, _run(m, x))


@pytest.mark.parametrize("name", [NAME, SWIN])
def test_attention_dropout_bypasses_the_remat_tail(name):
    x = torch.from_numpy(_images(0, 4).astype(np.float32))
    m = _model(name, True, attn_impl="remat", **RATES)
    ref = _model(name, True, **RATES)
    ref.load_state_dict(m.state_dict())
    attn = [mod for mod in m.modules() if hasattr(mod, "tail_eligible")]
    assert attn and not any(a.tail_eligible() for a in attn)
    _assert_bit_equal(_run(ref, x), _run(m, x))
    m.eval()
    assert all(a.tail_eligible() for a in attn)


def test_deit_remat_tail_matches_jax_fp64(masks):
    rates = dict(drop_rate=0.1, drop_path_rate=0.3)
    jm = jdeit.deit_model(NAME, _jax_policy(), attn_impl="remat", **rates)
    tm = create_model(NAME, policy=w2a2_qkr_policy(DEPTH), device="cpu",
                      attn_impl="remat", **rates).double()
    x = _images(0)
    from test_torch_train_slice import _with_heads
    v = _with_heads(_jitted_init(jm, x), np.random.default_rng(2))
    _assert_parity(masks, jm, tm, v, x,
                   n_calls=1 + 3 * DEPTH + 2 * (DEPTH - 1))


def test_swin_remat_tail_matches_jax_fp64(masks):
    rates = dict(drop_rate=0.1, drop_path_rate=0.3)
    kw = dict(depths=DEPTHS, attn_impl="remat", **rates)
    jm = jswin.swin_model(SWIN, _jax_swin_policy(DEPTHS), **kw)
    tm = create_model(SWIN, policy=w2a2_qkr_swin_policy(DEPTHS),
                      device="cpu", **kw).double()
    x = _images(0)
    v = _with_head(_jitted_init(jm, x), np.random.default_rng(1))
    n = sum(DEPTHS)
    _assert_parity(masks, jm, tm, v, x, n_calls=3 * n + 2 * (n - 1))
