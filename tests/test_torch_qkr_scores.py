"""The score tile that K2 and K3's pass A share (csrc/qkr_scores.cuh), on the
CPU.

1. The plain versions `qkr_attention_fwd_reference` and
   `qkr_attention_bwd_reference` against the JAX package's
   `_attn_core_fwd` and `_attn_core_bwd` (Pallas in interpret mode) on the
   same seeded inputs, at a contraction K = 128 deep (two of the
   tensor-core tile's 64-deep chunks, eight k16 steps) and N = 37 or 70
   keys (no multiple of 16; 70 spans both key halves of the tile's 128-key
   bucket), shared and per-head lhs, LSQ on and off, fp32 and the bf16
   stream.  Tolerances as `test_torch_fused_bf16_ops.py`: at most 0.1 %
   of the elements farther than one bf16 ulp of the larger magnitude (bf16
   only) plus 1e-5 * (1 + |ref|) (two fp32 summation orders, and a
   probability within an ulp of an LSQ boundary falling on the other
   side); ds rtol 1e-4 with a floor of 1e-4 of its largest entry.
2. The tensor-core form of K2-bf16's score tile that was measured on the
   H100 and left out (`PERF.md` section 7: the bf16 whole-step gradient
   rule refused it), emulated with the H100's `mma.sync` accumulator
   (`emulate_qkr_tc` below, built on `chip_smoke.mma_sum`; on the card
   K2-bf16's output and K3-bf16's pq matched it bit for bit) in each
   accumulation tried, one chain over K and a chain per 64-deep chunk
   added in fp32, held to K2's gate (`chip_smoke.k2_gate`: at most 0.1 %
   of the elements outside one bf16 ulp plus 1e-4 * (1 + |ref|), none
   farther than one LSQ level) against the plain version; the gate trips
   on the self-check's fault (a 16-deep slice of the scores' contraction
   left out).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofq_tpu.ops.fused_attention import _attn_core_bwd, _attn_core_fwd
from ofq_tpu_torch.ops import fused_attention as t_attn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

B, H, K, D = 2, 2, 128, 16
BF16_ULP = 2.0 ** -7
BITS, SM_SCALE = 2, 0.125


def _case(seed, N, shared, dtype):
    """Seeded inputs as numpy arrays rounded to the stream dtype (s fp32),
    and the same as torch tensors."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, N, K) if shared else (B, N, H, K)) * 0.5,
            rng.normal(size=(B, N, H, K)) * 0.5, rng.normal(size=(B, N, H, D)),
            rng.normal(size=(B, N, H, D))]
    ts = [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrs]
    s = torch.from_numpy((rng.random(N) * 0.02 + 0.01).astype(np.float32))
    s[0] = 1e-7  # below the 1e-5 floor
    js = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32) for t in ts]
    return ts[:3] + [s], ts[3], js[:3] + [jnp.asarray(s.numpy())], js[3]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _share_outside(got, want, ulp):
    a, b = _np(got), _np(want)
    lim = ulp * np.maximum(np.abs(a), np.abs(b)) + 1e-5 * (1 + np.abs(b))
    return float(np.mean(np.abs(a - b) > lim))


@pytest.mark.parametrize("N", [37, 70])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_match_pallas(N, shared, quantize, dtype):
    ts, g, js, gj = _case(40 + N, N, shared, dtype)
    ulp = BF16_ULP if dtype == torch.bfloat16 else 0.0
    out_j, res = _attn_core_fwd(*js, BITS, SM_SCALE, quantize, True)
    out_t = t_attn.qkr_attention_fwd_reference(*ts, BITS, SM_SCALE, quantize)
    assert out_t.dtype == dtype and out_t.shape == out_j.shape
    assert _share_outside(out_t, out_j, ulp) <= 1e-3
    want = _attn_core_bwd(BITS, SM_SCALE, quantize, True, res, gj)
    got = t_attn.qkr_attention_bwd_reference(*ts, g, BITS, SM_SCALE,
                                             quantize)
    for name, a, w in zip(("dlhs", "drhs", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape, name
        assert _share_outside(a, w, ulp) <= 1e-3, name
    ds, ds_j = got[3], _np(want[3])
    if quantize:
        assert np.abs(ds_j).max() > 0
        np.testing.assert_allclose(ds.numpy(), ds_j, rtol=1e-4,
                                   atol=1e-4 * np.abs(ds_j).max())
    else:
        assert not ds.any() and not np.any(ds_j)


def _tc_key_tiles(N):
    """The tile's 16-key tiles at N keys: the smallest of its buckets (4,
    8, 13, 16) that holds N."""
    return next(t for t in (4, 8, 13, 16) if N <= 16 * t)


def _lane_sums(e, h0):
    """A row's sum over one key half of the tensor-core score tile: e holds
    the half's 16 h0 keys on its last axis, key 8 t + 2 c + j in lane c's
    t-th pair; each lane sums its values in order of t then j (fp32), then
    the quad ((l0 + l1) + (l2 + l3))."""
    lanes = e.reshape(*e.shape[:-1], 2 * h0, 4, 2).transpose(-3, -2)
    lanes = lanes.reshape(*e.shape[:-1], 4, 4 * h0)
    part = torch.zeros(lanes.shape[:-1], dtype=torch.float32,
                       device=e.device)
    for i in range(4 * h0):
        part = part + lanes[..., i]
    return (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])


def tc_scores(lhs, rhs, promote=False):
    """The tensor-core tile's fp32 sums lhs . rhs^T, (B, H, N, N), by
    `chip_smoke.mma_sum` in k16 steps over K: one chain, or (promote) each
    64-deep chunk from zero and the chunks added in fp32 in order."""
    B, N, H, K = rhs.shape
    lhs_u = (lhs[:, None].expand(B, H, N, K) if lhs.dim() == 3
             else lhs.permute(0, 2, 1, 3))
    a, b = lhs_u.unsqueeze(3), rhs.permute(0, 2, 1, 3).unsqueeze(2)
    if not promote:
        return chip_smoke.mma_sum(a, b)
    acc = None
    for k0 in range(0, K, 64):
        part = chip_smoke.mma_sum(a[..., k0:k0 + 64], b[..., k0:k0 + 64])
        acc = part if acc is None else acc + part
    return acc


def emulate_qkr_tc(lhs, rhs, v, s, bits, sm_scale, quantize, promote=False):
    """K2-bf16 on the tensor cores as it was measured: 256 threads, warp w
    the 16 query rows 16 (w % 4) .. and key half w / 4; its sums by
    `chip_smoke.mma_sum`: the scores in k16 steps over K (promote:
    each 64-deep chunk from zero, the chunks added in fp32), times
    sm_scale in fp32; the softmax over the keys in two halves (16 h0 keys
    and the rest of 16 KS, KS = _tc_key_tiles(N), h0 = (KS + 1) // 2)
    with keys >= N at -inf, each half's sum as `_lane_sums`, the row's as
    half 0's + half 1's, p = e / sum; LSQ as the plain version; pq rounded
    to bf16; out = each half's pq v by `mma_sum` over its keys, half 0's +
    half 1's, rounded to bf16.  Returns (out (B, N, H, d), pq
    (B, H, N, N)), bf16; exp is the device's own (torch.exp)."""
    B, N, H, K = rhs.shape
    ks = _tc_key_tiles(N)
    h0 = (ks + 1) // 2
    split = 16 * h0
    sc = tc_scores(lhs, rhs, promote) * torch.tensor(
        sm_scale, dtype=torch.float32, device=rhs.device)
    sc = torch.cat([sc, torch.full((B, H, N, 2 * split - N), -torch.inf,
                                   device=sc.device)], dim=-1)
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    total = _lane_sums(e[..., :split], h0) + _lane_sums(e[..., split:], h0)
    p = e / total[..., None]
    if quantize:
        sn = torch.clamp_min(s.float(), 1e-5)[None, None, :, None]
        p = torch.round(torch.clamp(p / sn, 0.0, 2 ** bits - 1)) * sn
    pq = p.to(torch.bfloat16)
    vk = v.permute(0, 2, 3, 1)  # (B, H, d, N)
    vk = torch.cat([vk, torch.zeros(*vk.shape[:-1], 2 * split - N,
                                    dtype=vk.dtype, device=vk.device)], -1)
    o = None
    for hf in (slice(0, split), slice(split, 2 * split)):
        part = chip_smoke.mma_sum(pq[..., hf].unsqueeze(3),
                                  vk[..., hf].unsqueeze(2))
        o = part if o is None else o + part
    return o.permute(0, 2, 1, 3).to(torch.bfloat16), pq[..., :N]


@pytest.mark.parametrize("promote", [False, True])
@pytest.mark.parametrize("N", [37, 70])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("quantize", [True, False])
def test_tensor_core_tile_emulated_holds_k2_gate(promote, N, shared,
                                                 quantize):
    ts, _, _, _ = _case(60 + N, N, shared, torch.bfloat16)
    args = (*ts, BITS, SM_SCALE, quantize)
    emu, pq = emulate_qkr_tc(*args, promote=promote)
    ref = t_attn.qkr_attention_fwd_reference(*args)
    assert emu.dtype == torch.bfloat16 and emu.shape == ref.shape
    assert pq.shape == (B, H, N, N)
    chip_smoke.k2_gate("K2 emulated", emu, ref, ts[3], ts[2])


def test_emulated_accumulations_differ():
    """The two accumulations are different sums, both biased toward zero
    where round-to-nearest is not.  In units of 2^-24 sum_k |a_k b_k| (an
    fp32 rounding of the sum's scale), against the exact sum: every score
    within 4 units; the mean error toward the score's sign below -0.1 for
    one chain over K = 128 (eight cuts), between that and 0 for two
    64-deep chunks added with round-to-nearest, and within 0.05 of 0 for
    torch's fp32 sum."""
    ts, _, _, _ = _case(7, 70, True, torch.bfloat16)
    a, b = ts[0].double(), ts[1].double()
    exact = torch.einsum("bnk,bmhk->bhnm", a, b)
    unit = torch.einsum("bnk,bmhk->bhnm", a.abs(), b.abs()) * 2.0 ** -24
    sums = {promote: tc_scores(ts[0], ts[1], promote=promote)
            for promote in (False, True)}
    sums["rn"] = torch.einsum("bnk,bmhk->bhnm", ts[0].float(), ts[1].float())
    bias = {}
    for form, sc in sums.items():
        assert sc.dtype == torch.float32
        err = (sc.double() - exact) * torch.sign(exact) / unit
        assert float(err.abs().max()) <= 4, form
        bias[form] = float(err.mean())
    assert bias[False] < -0.1 and bias[False] < bias[True] < 0
    assert abs(bias["rn"]) < 0.05


def test_lane_sums_follow_the_tile():
    """A half's sum (`chip_smoke._lane_sums`, one 16-key tile: h0 = 1):
    lane c holds keys 2 c, 2 c + 1, 8 + 2 c, 9 + 2 c and sums them in that
    order, then the quad adds (l0 + l1) + (l2 + l3).  With 1 at key 0 and
    2^-24 at keys 1, 2, 4, 6 that order gives 1 + 2^-23 (lanes 2 and 3's
    halves meet before they reach 1), where summing the keys in turn gives
    1."""
    e = torch.zeros(16, dtype=torch.float32)
    e[0] = 1.0
    e[[1, 2, 4, 6]] = 2.0 ** -24
    lanes = [((e[2 * c] + e[2 * c + 1]) + e[8 + 2 * c]) + e[9 + 2 * c]
             for c in range(4)]
    want = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    got = _lane_sums(e, 1)
    assert float(got) == float(want) == 1.0 + 2.0 ** -23
    in_turn = torch.zeros((), dtype=torch.float32)
    for x in e:
        in_turn = in_turn + x
    assert float(in_turn) == 1.0


def test_k2_gate_trips_on_the_slice_fault():
    """The self-check's fault (`chip_smoke.k2_slice_fault`: the scores'
    contraction slice 16:32 left out) trips K2's gate on the plain
    version, and the unmodified plain version passes it."""
    ts, _, _, _ = _case(80, 70, True, torch.bfloat16)
    args = (*ts, BITS, SM_SCALE, True)
    ref = t_attn.qkr_attention_fwd_reference(*args)
    chip_smoke.k2_gate("K2", ref, ref, ts[3], ts[2])
    faulty = chip_smoke.k2_slice_fault(t_attn.qkr_attention_fwd_reference)
    with pytest.raises(chip_smoke.GateTripped):
        chip_smoke.k2_gate("K2", faulty(*args), ref, ts[3], ts[2])
