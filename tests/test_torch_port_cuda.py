"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips when no CUDA device is present (decided in
the fixture, never at import).  Imports no JAX, so on a machine without it
the file runs alone with the repo's conftest left out:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest -p no:cacheprovider
"""

import sys
from pathlib import Path

import pytest
import torch

from ofq_tpu_torch.ops import fused_attention as fa
from ofq_tpu_torch.ops import fused_qlinear as fq
from ofq_tpu_torch.quant.lsq import thresholds
from ofq_tpu_torch.quant.statsq import statsq_scale

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _k1_args(dev, M, n_tok, K, N, bits, all_positive, seed=0):
    g = torch.Generator().manual_seed(seed)
    lo, hi = thresholds(bits, all_positive)
    x = torch.randn(M, K, generator=g)
    if all_positive:
        x = x.abs()
    s = torch.randint(64, 256, (n_tok,), generator=g).float() / 128
    b_pre = torch.randint(-8, 9, (K,), generator=g).float() / 256
    # a third of the activations exactly on an LSQ rounding tie
    k = torch.randint(lo, hi, (M, K), generator=g).float()
    tie = s.repeat(M // n_tok)[:, None] * (k + 0.5) - b_pre
    x = torch.where(torch.rand(M, K, generator=g) < 1 / 3, tie, x)
    # half the columns exactly on StatsQ ties: mean|w| = 0.5, c * n integral
    n = 2 ** (bits - 1)
    w = torch.randn(K, N, generator=g) / K ** 0.5
    t = torch.randint(0, n // 2 + 1, (K // 2, N // 2), generator=g) / n
    sign = torch.randint(0, 2, (K, N // 2), generator=g) * 2 - 1
    w[:, : N // 2] = torch.cat([0.5 - t, 0.5 + t], 0) * sign
    x, s, b_pre, w = (a.to(dev) for a in (x, s, b_pre, w))
    sw = statsq_scale(w).contiguous()
    bvec = (torch.randn(N, generator=g) * 0.1).to(dev)
    return (x, s, n_tok, b_pre, w, sw, bvec, lo, hi, float(n))


@pytest.mark.parametrize("M,n_tok,K,N,bits,all_positive", [
    (2 * 198, 198, 384, 384, 2, False),
    (2 * 198, 198, 1536, 384, 2, True),
    (3 * 37, 37, 200, 72, 2, False),
    (4 * 10, 10, 48, 24, 4, False),
    (5 * 7, 7, 40, 20, 3, True),
])
def test_k1_bit_exact(dev, M, n_tok, K, N, bits, all_positive):
    args = _k1_args(dev, M, n_tok, K, N, bits, all_positive)
    before = fq.fused_qlinear_fwd.launches
    y = fq.fused_qlinear_fwd(*args)
    assert fq.fused_qlinear_fwd.launches == before + 1
    ref = fq.fused_qlinear_fwd_reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ref, rtol=0, atol=0)


@pytest.mark.parametrize("M,n_tok,K,N,bits,all_positive", [
    (64 * 198, 198, 384, 384, 2, False),    # DeiT-S proj, W2A2
    (64 * 198, 198, 384, 1536, 2, False),   # fc1 (a W code panel)
    (64 * 198, 198, 1536, 384, 2, True),    # fc2 (W codes streamed)
    (64 * 198, 198, 384, 384, 4, False),    # W4A4
    (3 * 37, 37, 200, 72, 2, False),        # ragged M, K, N
    (4 * 10, 10, 48, 24, 8, False),         # W8A8: codes by division
])
def test_k1_wgmma_bit_exact(dev, M, n_tok, K, N, bits, all_positive):
    """K1 on the tensor cores at the shapes of its paths (a W code panel
    and streamed W codes, codes by steps and by division): 0 elements
    differing from the plain version (integer sums below 2^24), one
    launch counted."""
    args = _k1_args(dev, M, n_tok, K, N, bits, all_positive, seed=1)
    before = fq.fused_qlinear_fwd.launches
    y = fq.fused_qlinear_fwd(*args)
    ref = fq.fused_qlinear_fwd_reference(*args)
    torch.cuda.synchronize()
    assert fq.fused_qlinear_fwd.launches == before + 1
    assert int((y != ref).sum()) == 0


def test_k1_plain_on_card_does_not_count(dev):
    args = _k1_args(dev, 2 * 5, 5, 16, 8, 2, False)
    before = fq.fused_qlinear_fwd.launches
    fq.fused_qlinear_fwd_reference(*args)
    assert fq.fused_qlinear_fwd.launches == before


def test_k1_rejects_bad_inputs(dev):
    x, *rest = _k1_args(dev, 2 * 5, 5, 16, 8, 2, False)
    with pytest.raises(ValueError, match="contiguous float32"):
        fq.fused_qlinear_fwd(x.double(), *rest)
    with pytest.raises(ValueError, match="contiguous float32"):
        fq.fused_qlinear_fwd(x.t().contiguous().t(), *rest)


def _k2_args(dev, B, N, H, K, d, shared, seed=0):
    g = torch.Generator().manual_seed(seed)
    lhs = torch.randn(*((B, N, K) if shared else (B, N, H, K)), generator=g)
    rhs = torch.randn(B, N, H, K, generator=g)
    v = torch.randn(B, N, H, d, generator=g)
    s = torch.rand(N, generator=g) * 0.02 + 0.005
    s[0] = 1e-7  # below the 1e-5 floor
    return [a.to(dev).contiguous() for a in (lhs, rhs, v, s)]


@pytest.mark.parametrize("B,N,H,K,d", [
    (2, 198, 6, 384, 64),   # DeiT-S QKR
    (3, 12, 3, 16, 8),      # small, ragged tiles
    (1, 70, 2, 40, 100),    # d > 64: two output column passes
])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("quantize", [True, False])
def test_k2_matches_plain(dev, B, N, H, K, d, shared, quantize):
    """Both sum in fp32 in different orders: at most 0.1 % of the elements
    move by up to one LSQ level (s_n * |v|), the rest agree to 1e-4."""
    lhs, rhs, v, s = _k2_args(dev, B, N, H, K, d, shared)
    args = (lhs, rhs, v, s, 2, d ** -0.5, quantize)
    before = fa.qkr_attention_fwd.launches
    out = fa.qkr_attention_fwd(*args)
    assert fa.qkr_attention_fwd.launches == before + 1
    ref = fa.qkr_attention_fwd_reference(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    diff = (out - ref).abs()
    assert (diff > 1e-4 * (1 + ref.abs())).float().mean() <= 1e-3
    assert diff.max() <= 2 * s.max() * v.abs().max()


def test_k2_rejects_too_many_keys(dev):
    lhs, rhs, v, s = _k2_args(dev, 1, 1000, 1, 8, 8, True)
    with pytest.raises(ValueError, match="shared memory"):
        fa.qkr_attention_fwd(lhs, rhs, v, s, 2, 0.5, True)


def _k3_close(got, ref):
    """Share of elements outside 1e-4 * (1 + |ref|)."""
    return float(((got - ref).abs() > 1e-4 * (1 + ref.abs())).float().mean())


@pytest.mark.parametrize("B,N,H,K,d", [
    (2, 198, 6, 384, 64),   # DeiT-S QKR
    (3, 12, 3, 16, 8),      # small, ragged tiles
    (1, 70, 2, 40, 100),    # d > 64: two output column tiles
])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("quantize", [True, False])
def test_k3_matches_plain(dev, B, N, H, K, d, shared, quantize):
    """The backward kernel against its plain version.  Both recompute the
    probabilities with fp32 sums in other orders, so a probability within
    an ulp of an LSQ boundary may fall on the other side (the K2
    precedent): at most 0.1 % of the elements of dlhs, drhs and dv
    outside 1e-4 * (1 + |ref|).  Such a flip moves one entry of ds by
    about |dpq|: at most 2 % of ds's entries outside 1e-4 * (1 + |ref|)."""
    _k3_against_plain(dev, B, N, H, K, d, shared, quantize)


@pytest.mark.parametrize("N", [50, 65, 197, 198])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("quantize", [True, False])
def test_k3_fp32_ragged_keys(dev, N, shared, quantize):
    """K3 fp32's register tiles at key counts around its tiles' edges (a
    128-row tile of passes B and C, 64 query rows and 224 keys a sweep in
    pass A, 16-byte scratch rows): N = 50, 65, 197 and DeiT-S's 198, under
    test_k3_matches_plain's rule."""
    _k3_against_plain(dev, 2, N, 6, 384 if shared else 64, 64, shared,
                      quantize)


def _k3_against_plain(dev, B, N, H, K, d, shared, quantize):
    lhs, rhs, v, s = _k2_args(dev, B, N, H, K, d, shared)
    g = torch.randn(B, N, H, d, generator=torch.Generator().manual_seed(3))
    args = (lhs, rhs, v, s, g.to(dev), 2, d ** -0.5, quantize)
    before = fa.qkr_attention_bwd.launches
    got = fa.qkr_attention_bwd(*args)
    assert fa.qkr_attention_bwd.launches == before + 1
    ref = fa.qkr_attention_bwd_reference(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dlhs", "drhs", "dv"), got, ref):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _k3_close(a, b) <= 1e-3, name
    ds, ds_ref = got[3], ref[3]
    if quantize:
        assert _k3_close(ds, ds_ref) <= 2e-2
    else:
        assert not ds.any()


def test_k3_is_the_backward_of_k2(dev):
    """Through autograd on the card, the core launches K2 forward and K3
    backward once each, and its gradients match the plain Function's."""
    lhs, rhs, v, s = _k2_args(dev, 2, 198, 6, 384, 64, True)
    g = torch.randn(2, 198, 6, 64, device=dev)
    outs = []
    for fwd, bwd in ((fa.qkr_attention_fwd, fa.qkr_attention_bwd),
                     (fa.qkr_attention_fwd_reference,
                      fa.qkr_attention_bwd_reference)):
        ts = [t.clone().requires_grad_() for t in (lhs, rhs, v, s)]
        f0, b0 = fa.qkr_attention_fwd.launches, fa.qkr_attention_bwd.launches
        out = fa.quantized_attention_core(*ts, bits=2, sm_scale=0.125,
                                          fwd=fwd, bwd=bwd)
        outs.append(torch.autograd.grad(out, ts, g))
        launched = (fa.qkr_attention_fwd.launches - f0,
                    fa.qkr_attention_bwd.launches - b0)
        assert launched == ((1, 1) if fwd is fa.qkr_attention_fwd
                            else (0, 0))
    torch.cuda.synchronize()
    for a, b in zip(outs[0][:3], outs[1][:3]):
        assert _k3_close(a, b) <= 1e-3


def _bf16_outside(got, ref):
    """Share of bf16 elements outside one bf16 ulp of the larger magnitude,
    2^-7 max(|got|, |ref|), plus the fp32 tests' 1e-4 * (1 + |ref|)."""
    a, b = got.float(), ref.float()
    lim = 2 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-4 * (1 + b.abs())
    return float(((a - b).abs() > lim).float().mean())


@pytest.mark.parametrize("B,N,H,K,d", [
    (2, 198, 6, 384, 64),   # DeiT-S QKR
    (3, 12, 3, 16, 8),      # small, ragged tiles
    (1, 70, 2, 40, 100),    # d > 64: two output column passes
])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("quantize", [True, False])
def test_k2_bf16_matches_plain(dev, B, N, H, K, d, shared, quantize):
    """K2 in the bf16 stream against its plain version: both widen the
    bf16 operands exactly and sum in fp32 in other orders, then round pq
    and out to bf16, so an element differs by one bf16 ulp where the two
    sums round either side of a boundary, and by up to one LSQ level
    where a probability falls on the other side of one (at most 0.1 % of
    the elements outside `_bf16_outside`'s limit)."""
    lhs, rhs, v, s = _k2_args(dev, B, N, H, K, d, shared)
    lhs, rhs, v = (t.to(torch.bfloat16) for t in (lhs, rhs, v))
    args = (lhs, rhs, v, s, 2, d ** -0.5, quantize)
    before = fa.qkr_attention_fwd.launches
    out = fa.qkr_attention_fwd(*args)
    assert fa.qkr_attention_fwd.launches == before + 1
    ref = fa.qkr_attention_fwd_reference(*args)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    assert _bf16_outside(out, ref) <= 1e-3
    assert float((out.float() - ref.float()).abs().max()) <= float(
        2 * s.max() * v.float().abs().max())


@pytest.mark.parametrize("B,N,H,K,d", [
    (2, 198, 6, 384, 64),   # DeiT-S QKR
    (64, 198, 6, 384, 64),  # DeiT-S QKR at the train step's batch
    (3, 12, 3, 16, 8),      # small, ragged tiles
    (1, 70, 2, 40, 100),    # d > 64: two output column tiles
    (2, 37, 2, 20, 12),     # N, K and d no multiple of 8
])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("quantize", [True, False])
def test_k3_bf16_matches_plain(dev, B, N, H, K, d, shared, quantize):
    """K3 in the bf16 stream against its plain version: dlhs, drhs and dv
    in bf16 under `_bf16_outside`'s limit (at most 0.1 % outside), ds in
    fp32 under the fp32 test's rule (at most 2 % of its entries outside
    1e-4 * (1 + |ref|))."""
    lhs, rhs, v, s = _k2_args(dev, B, N, H, K, d, shared)
    g = torch.randn(B, N, H, d, generator=torch.Generator().manual_seed(3))
    lhs, rhs, v, g = (t.to(dev, torch.bfloat16) for t in (lhs, rhs, v, g))
    args = (lhs, rhs, v, s, g, 2, d ** -0.5, quantize)
    before = fa.qkr_attention_bwd.launches
    got = fa.qkr_attention_bwd(*args)
    assert fa.qkr_attention_bwd.launches == before + 1
    ref = fa.qkr_attention_bwd_reference(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dlhs", "drhs", "dv"), got, ref):
        assert a.shape == b.shape and a.dtype == torch.bfloat16, name
        assert torch.isfinite(a.float()).all(), name
        assert _bf16_outside(a, b) <= 1e-3, name
    ds, ds_ref = got[3], ref[3]
    assert ds.dtype == torch.float32
    if quantize:
        assert _k3_close(ds, ds_ref) <= 2e-2
    else:
        assert not ds.any()


def test_raw_wrappers_refuse_grad_inputs_on_card(dev):
    lhs, rhs, v, s = _k2_args(dev, 1, 12, 2, 16, 8, True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.qkr_attention_fwd(lhs.requires_grad_(), rhs, v, s, 2, 0.5, True)


def _k45_args(dev, M, K, N, dtype, seed=0):
    """K4/K5 operands at one shape: activations (M, K) or upstream
    gradients (M, N) in `dtype`, a kernel with StatsQ ties in half its
    columns (mean|w| = 0.5, c * n integral), the detached scale."""
    from ofq_tpu_torch.ops import pallas_statsq as ps
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(K, N, generator=g) / K ** 0.5
    t = torch.randint(0, 2, (K // 2, N // 2), generator=g) / 2
    w[:, : N // 2] = torch.cat([0.5 - t, 0.5 + t], 0) * (
        torch.randint(0, 2, (K, N // 2), generator=g) * 2 - 1)
    x = (torch.randint(-2, 2, (M, K), generator=g) * 0.25
         + torch.randn(K, generator=g) * 0.05)
    gr = torch.randn(M, N, generator=g) * 1e-3
    w = w.to(dev)
    s = statsq_scale(w).contiguous()
    return (x.to(dev, dtype).contiguous(), gr.to(dev, dtype).contiguous(),
            w, s, ps._quant_tile(w, s, 2.0))


def _k45_close(y, ref, abs_sum):
    """fp32 sums in two orders: 1e-5 of the sum of |terms|; in bf16 also
    2^-7 * max(|y|, |ref|), at least one output ulp."""
    d = (y.float() - ref.float()).abs()
    lim = 1e-5 * abs_sum
    if y.dtype == torch.bfloat16:
        lim = lim + 2 ** -7 * torch.maximum(y.float().abs(),
                                            ref.float().abs())
    return bool((d <= lim).all())


@pytest.mark.parametrize("M,K,N", [
    (12672, 384, 384),     # DeiT-S proj
    (12672, 384, 1536),    # fc1
    (12672, 1536, 384),    # fc2
    (200704, 96, 96),      # Swin-T stage 0 proj
    (3136, 3072, 768),     # Swin-T stage 3 fc2, K = 3072
    (1000, 200, 72),       # ragged
    (37, 20, 24),          # K no multiple of 8 or of the 32-deep chunk
    # the edges of the product's tiles (128 rows; 128 or 96 columns;
    # 16-deep chunks): M past a row tile at N = K = 96, K = 40 and 36
    (130, 96, 96),
    (257, 40, 96),
    (129, 36, 96),
    (200704, 384, 96),     # Swin-T stage 0 fc2, N = 96
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_plain(dev, M, K, N, dtype):
    from ofq_tpu_torch.ops import pallas_statsq as ps
    x, _, w, s, wq = _k45_args(dev, M, K, N, dtype)
    before = ps.pallas_statsq_fwd.launches
    y = ps.pallas_statsq_fwd(x, w, s, 2.0)
    assert ps.pallas_statsq_fwd.launches == before + 1
    ref = ps.pallas_statsq_fwd_reference(x, w, s, 2.0)
    torch.cuda.synchronize()
    assert y.dtype == dtype and torch.isfinite(y).all()
    assert _k45_close(y, ref, ps._acc32(x.abs(), wq.abs()))


@pytest.mark.parametrize("M,K,N", [
    (12672, 1536, 384), (1000, 200, 72),
    # K5's output is (M, K), its contraction N: the tiles' edges
    (130, 96, 96), (257, 40, 96), (129, 96, 36), (3136, 96, 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_matches_plain(dev, M, K, N, dtype):
    from ofq_tpu_torch.ops import pallas_statsq as ps
    _, g, w, s, wq = _k45_args(dev, M, K, N, dtype)
    before = ps.pallas_statsq_dx.launches
    dx = ps.pallas_statsq_dx(g, w, s, 2.0, dtype)
    assert ps.pallas_statsq_dx.launches == before + 1
    ref = ps.pallas_statsq_dx_reference(g, w, s, 2.0, dtype)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and torch.isfinite(dx).all()
    assert _k45_close(dx, ref, ps._acc32(g.abs(), wq.abs().T))


@pytest.mark.parametrize("which", ["K4", "K5"])
@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("M,K,N", [(12672, 384, 1536), (129, 36, 96)])
def test_k45_levels_are_quant_tile(dev, which, bits, M, K, N):
    """The pre-pass's Q(W) (Q(W)^T for K5), read back from the scratch the
    launcher fills, equals `_quant_tile` on the card bit for bit, StatsQ
    ties included."""
    x, g, w, s, _ = _k45_args(dev, M, K, N, torch.bfloat16, seed=bits)
    from ofq_tpu_torch.ops import _build
    nl = float(2 ** (bits - 1))
    run = chip_smoke.raw_k45(_build.load("pallas_statsq"), which,
                             x if which == "K4" else g, w, s, nl)
    run()
    torch.cuda.synchronize()
    assert chip_smoke.levels_differing(run.levels, which, w, s, nl) == 0


@pytest.mark.parametrize("which", ["K4", "K5"])
@pytest.mark.parametrize("K,N", [(384, 384), (384, 1536), (1536, 384)])
@pytest.mark.parametrize("bf16", [False, True])
def test_k45_hold_two_blocks_at_deit_s(dev, which, K, N, bf16):
    """The product's exported launch at DeiT-S's shapes (M = 64 * 198):
    within the 227 KB a block may take, two blocks per SM (the runtime's
    occupancy, registers counted), and a grid that covers the output."""
    from ofq_tpu_torch.ops import pallas_statsq as ps
    M, C = 64 * 198, (N if which == "K4" else K)
    cfg = ps.launch_config(M, C, bf16)
    assert cfg["smem"] <= fa._MAX_SMEM and cfg["blocks_per_sm"] >= 2, cfg
    bm, bn = cfg["tile"]
    assert cfg["grid"] == (-(-C // bn), -(-M // bm)), cfg
    assert cfg["threads"] == bm * bn // 64, cfg


@pytest.mark.parametrize("source,part,op", [
    (source, part, op) for source, wanted in chip_smoke.TC_KERNELS.items()
    for part, op in wanted])
def test_tensor_core_kernels_hold_mma_instructions(dev, source, part, op):
    """K1 runs wgmma (HGMMA in its SASS), K3-bf16's dpq, cols and dlhs
    passes and K6-K8 mma.sync (HMMA), K6 TMA loads (UTMALDG), read with
    cuobjdump (chip_smoke.TC_KERNELS)."""
    from ofq_tpu_torch.ops import _build
    _build.load(source)
    counts = chip_smoke.mma_counts(_build._lib_path(source))
    found = {fn: c[op] for fn, c in counts.items() if part in fn}
    assert found and all(n > 0 for n in found.values()), found


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("K,N", [(384, 384), (1536, 96)])
def test_k4_codes_are_exact(dev, bits, K, N):
    """x = the identity puts each level alone in its output: y[k, n] =
    bf16(Q(W)[k, n]) = bf16(c[k, n] * s[n] / (2 n)), so the odd code c read
    back (y / (s / (2 n)), exact for |c| < 2^7) equals the plain version's
    at every (k, n), StatsQ ties included, at 1 to 6 bits."""
    from ofq_tpu_torch.ops import pallas_statsq as ps
    _, _, w, s, _ = _k45_args(dev, 8, K, N, torch.bfloat16, seed=4)
    nl = float(2 ** (bits - 1))
    eye = torch.eye(K, device=dev, dtype=torch.bfloat16)
    y = ps.pallas_statsq_fwd(eye, w, s, nl).float()
    c = torch.round(y / (s / (2 * nl)))
    lv = torch.round(torch.clamp(w / s, -1.0, 1.0 - 1e-6) * nl - 0.5)
    torch.cuda.synchronize()
    assert int((c != 2 * lv + 1).sum()) == 0


def test_k4_k5_raw_wrappers_refuse_grad_inputs(dev):
    from ofq_tpu_torch.ops import pallas_statsq as ps
    x, g, w, s, _ = _k45_args(dev, 64, 32, 16, torch.bfloat16)
    with pytest.raises(RuntimeError, match="requires grad"):
        ps.pallas_statsq_fwd(x.float().requires_grad_(), w, s, 2.0)
    with pytest.raises(RuntimeError, match="requires grad"):
        ps.pallas_statsq_dx(g, w.requires_grad_(), s, 2.0, g.dtype)


def test_k4_is_the_forward_of_the_pallas_matmul(dev):
    """Through autograd on the card, the pallas matmul launches K4 once
    (and no K5), and its output and gradients match the plain Function's."""
    from ofq_tpu_torch.ops import pallas_statsq as ps
    x, _, w, s, wq = _k45_args(dev, 2 * 198, 384, 384, torch.bfloat16)
    outs = []
    for fwd in (ps.pallas_statsq_fwd, ps.pallas_statsq_fwd_reference):
        xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
        f0, d0 = ps.pallas_statsq_fwd.launches, ps.pallas_statsq_dx.launches
        y = ps.pallas_statsq_matmul(xi, wi, 2, compute_dtype=torch.bfloat16,
                                    fwd=fwd)
        gy = torch.ones_like(y)
        outs.append((y,) + torch.autograd.grad(y, (xi, wi), gy))
        launched = (ps.pallas_statsq_fwd.launches - f0,
                    ps.pallas_statsq_dx.launches - d0)
        assert launched == ((1, 0) if fwd is ps.pallas_statsq_fwd
                            else (0, 0))
    torch.cuda.synchronize()
    assert _k45_close(outs[0][0], outs[1][0], ps._acc32(x.abs(), wq.abs()))
    # the backward is the same torch ops on both paths
    for a, b in zip(outs[0][1:], outs[1][1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def tail_within_gate(y, ref, q, k, v):
    """The K6-K8 gate (PERF.md section 2): every element of `y` within one
    bf16 ulp of itself, 2^-7 max(|y|, |ref|), plus 2^-8 sum_m p_m |v_m| (a
    probability that rounds to bf16 the other way), and at most 0.1 % of
    the elements differing at all.  Returns (ok, worst |diff| / limit,
    share differing)."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * (
        q.shape[-1] ** -0.5)
    p = torch.softmax(s, dim=-1)
    pv = torch.einsum("bhnm,bmhd->bnhd", p, v.float().abs())
    y32, r32 = y.float(), ref.float()
    d = (y32 - r32).abs()
    lim = 2 ** -7 * torch.maximum(y32.abs(), r32.abs()) + 2 ** -8 * pv
    worst = float((d / lim.clamp_min(1e-30)).max())
    share = float((d > 0).float().mean())
    return worst <= 1.0 and share <= 1e-3, worst, share


def _tail_args(dev, Bn, H=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(Bn, 49, H, 32, generator=g).to(dev, torch.bfloat16)
            for _ in range(3)]


@pytest.mark.parametrize("name,kw", [
    ("window_attn_units", dict(WB=16)),
    ("window_attn_units", dict(WB=64)),
    ("window_attn_packed", dict(WB=16)),
    ("window_attn_packed", dict(WB=16, P=12)),
    ("window_attn_packed", dict(WB=32, P=12)),
    ("window_attn_packed_aligned", dict(WB=16, P=4)),
    ("window_attn_packed_aligned", dict(WB=16, P=8)),
    ("window_attn_packed_aligned", dict(WB=16, P=12)),
])
def test_k678_match_plain(dev, name, kw):
    """K6-K8 at the lab's unit shape and parameters, 256 windows."""
    from ofq_tpu_torch.ops import window_attention as wa
    fn = getattr(wa, name)
    q, k, v = _tail_args(dev, 256)
    before = fn.launches
    y = fn(q, k, v, **kw)
    assert fn.launches == before + 1
    ref = wa.window_attn_tail_reference(q, k, v)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    ok, worst, share = tail_within_gate(y, ref, q, k, v)
    assert ok, (worst, share)


def test_k678_other_head_counts(dev):
    """H from the tensor: 6 heads (Swin-T stage 1) through all three."""
    from ofq_tpu_torch.ops import window_attention as wa
    q, k, v = _tail_args(dev, 32, H=6, seed=1)
    ref = wa.window_attn_tail_reference(q, k, v)
    for fn in (wa.window_attn_units, wa.window_attn_packed,
               wa.window_attn_packed_aligned):
        y = fn(q, k, v)
        torch.cuda.synchronize()
        assert tail_within_gate(y, ref, q, k, v)[0], fn.__name__


def test_k678_refuse_on_card(dev):
    from ofq_tpu_torch.ops import window_attention as wa
    q, k, v = _tail_args(dev, 16, H=12)
    with pytest.raises(ValueError, match="shared memory"):
        # 12 heads: two stages of 36 unit buffers, 295 936 B > 227 KB
        wa.window_attn_units(q, k, v)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(q.shape)  # contiguous, 2 bytes off alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        wa.window_attn_packed_aligned(shifted, k, v)
    with pytest.raises(RuntimeError, match="requires grad"):
        wa.window_attn_packed(q.float().requires_grad_().bfloat16(), k, v)


# K7 and K8 (tensor cores) at every lab parameter set, on 256 windows and
# on 403 blocks: 3 x 132 + 7, a partial last wave at 1, 2 or 3 blocks per SM
K78_CASES = [(name, kw) for key, name, kw in chip_smoke.K678_CASES
             if key in ("K7", "K8")]


@pytest.mark.parametrize("blocks", [None, 403])
@pytest.mark.parametrize("name,kw", K78_CASES)
def test_k78_tensor_cores_match_plain(dev, name, kw, blocks):
    from ofq_tpu_torch.ops import window_attention as wa
    fn = getattr(wa, name)
    Bn = 256 if blocks is None else kw["WB"] * blocks
    q, k, v = _tail_args(dev, Bn, seed=2)
    before = fn.launches
    y = fn(q, k, v, **kw)
    assert fn.launches == before + 1
    ref = wa.window_attn_tail_reference(q, k, v)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    ok, worst, share = tail_within_gate(y, ref, q, k, v)
    assert ok, (worst, share)


@pytest.mark.parametrize("name,kw", K78_CASES)
def test_k78_read_no_row_past_a_window(dev, name, kw):
    """q, k, v as contiguous leading slices of buffers filled with NaN past
    their end: the padded rows 49-63 are zero-filled in shared memory and
    never read from global memory, so the output stays finite."""
    from ofq_tpu_torch.ops import window_attention as wa
    fn = getattr(wa, name)
    clean = _tail_args(dev, 256, seed=3)
    spare = 2 * 49 * 3 * 32
    held = []
    for t in clean:
        buf = torch.full((t.numel() + spare,), float("nan"), device=dev,
                         dtype=torch.bfloat16)
        buf[:t.numel()] = t.reshape(-1)
        held.append(buf[:t.numel()].view(t.shape))
    y = fn(*held, **kw)
    ref = wa.window_attn_tail_reference(*clean)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all()
    ok, worst, share = tail_within_gate(y, ref, *clean)
    assert ok, (worst, share)


@pytest.mark.parametrize("form", sorted(chip_smoke.K6_FORMS))
def test_k6_ablation_forms_match_plain(dev, form):
    """K6's ablation forms under their gates (chip_smoke.form_gate), each
    counted as its own launch."""
    from ofq_tpu_torch.ops import window_attention as wa
    switches = chip_smoke.K6_FORMS[form]
    q, k, v = _tail_args(dev, 256, seed=4)
    before = wa.FORM_LAUNCHES[form].launches
    full = wa.window_attn_units.launches
    y = wa.window_attn_units(q, k, v, WB=16, **switches)
    assert wa.FORM_LAUNCHES[form].launches == before + 1
    assert wa.window_attn_units.launches == full
    ref = wa.window_attn_units_reference(q, k, v, **switches)
    torch.cuda.synchronize()
    chip_smoke._check_tail(f"K6 {form}", y, ref, q, k, v, form=form)


# K6 on the tensor cores with TMA loads, in every form
K6_SWITCHES = {"full": {}, **chip_smoke.K6_FORMS}


@pytest.mark.parametrize("blocks", [None, 403])
@pytest.mark.parametrize("WB", [16, 64])
@pytest.mark.parametrize("form", sorted(K6_SWITCHES))
def test_k6_forms_on_the_tensor_cores(dev, form, WB, blocks):
    """K6 in each form at WB 16 and 64 under its form's gate
    (chip_smoke.form_gate: nodots bit-exact), on 256 windows and on 403
    blocks (3 x 132 + 7: a partial last wave)."""
    from ofq_tpu_torch.ops import window_attention as wa
    switches = K6_SWITCHES[form]
    Bn = 256 if blocks is None else WB * blocks
    q, k, v = _tail_args(dev, Bn, seed=5)
    count = (wa.window_attn_units if form == "full"
             else wa.FORM_LAUNCHES[form])
    before = count.launches
    y = wa.window_attn_units(q, k, v, WB=WB, **switches)
    assert count.launches == before + 1
    ref = wa.window_attn_units_reference(q, k, v, **switches)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    chip_smoke._check_tail(f"K6 {form}", y, ref, q, k, v, form=form)


@pytest.mark.parametrize("form", sorted(K6_SWITCHES))
def test_k6_reads_no_row_past_its_windows(dev, form):
    """q, k, v as slices of NaN-filled buffers, starting one window in
    (9408 bytes: 16-byte aligned) and ending one window before the
    buffer's end: the tensor maps span exactly the slices' windows, so
    no NaN reaches the output."""
    from ofq_tpu_torch.ops import window_attention as wa
    switches = K6_SWITCHES[form]
    clean = _tail_args(dev, 256, seed=6)
    window = 49 * 3 * 32
    held = []
    for t in clean:
        buf = torch.full((t.numel() + 2 * window,), float("nan"),
                         device=dev, dtype=torch.bfloat16)
        buf[window:window + t.numel()] = t.reshape(-1)
        held.append(buf[window:window + t.numel()].view(t.shape))
    y = wa.window_attn_units(*held, WB=16, **switches)
    ref = wa.window_attn_units_reference(*clean, **switches)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all()
    chip_smoke._check_tail(f"K6 {form}", y, ref, *clean, form=form)


@pytest.mark.parametrize("H", [1, 2, 6])
@pytest.mark.parametrize("form", sorted(K6_SWITCHES))
def test_k6_other_head_counts(dev, form, H):
    """H from the tensor: the tensor maps' head extent and the warps
    (4 H, at most 16) follow it."""
    from ofq_tpu_torch.ops import window_attention as wa
    switches = K6_SWITCHES[form]
    q, k, v = _tail_args(dev, 64, H=H, seed=7)
    y = wa.window_attn_units(q, k, v, WB=16, **switches)
    ref = wa.window_attn_units_reference(q, k, v, **switches)
    torch.cuda.synchronize()
    chip_smoke._check_tail(f"K6 {form} H={H}", y, ref, q, k, v, form=form)


@pytest.mark.parametrize("what", ["window_attn_units", "window_attn_packed",
                                  "window_attn_packed_aligned"])
@pytest.mark.parametrize("H,P", [(1, 1), (3, 3), (3, 4), (3, 6), (3, 12),
                                 (6, 6), (12, 12)])
def test_window_launch_plans_are_the_librarys(dev, what, H, P):
    """`launch_plan`, the Python mirror the CPU tests read, equals the
    built library's launch export in shared memory, stages and warps; the
    runtime's blocks per SM of each kernel instance (every K6 form) are at
    most the mirror's by shared memory and threads, and at least one where
    the block's shared memory fits."""
    from ofq_tpu_torch.ops import window_attention as wa
    plan = wa.launch_plan(what, H, P)
    forms = ([wa.form_flags(**sw) for sw in K6_SWITCHES.values()]
             if what == "window_attn_units" else [7])
    for flags in forms:
        config = wa.launch_config(what, H, P, flags)
        assert config[:3] == plan[:3], flags
        assert config[3] <= plan[3], flags
        assert (config[3] >= 1) == (plan[0] <= fa._MAX_SMEM), flags


@pytest.mark.parametrize("N", [12, 50, 65, 197, 198, 384])
@pytest.mark.parametrize("bf16", [False, True])
def test_k3_launch_plan_is_the_librarys(dev, N, bf16):
    plan, config = fa.bwd_launch_plan(N, bf16), fa.bwd_launch_config(N, bf16)
    assert config[:3] == plan[:3]
    assert 1 <= config[3] <= plan[3]


@pytest.mark.parametrize("bf16", [False, True])
def test_k2_holds_two_blocks_at_deit_s(dev, bf16):
    """K2 at DeiT-S's N = 198 (the runtime's occupancy, registers
    counted): two blocks of 256 threads per SM in both streams."""
    smem, blocks = fa.fwd_launch_config(198, bf16)
    assert smem <= 113 * 1024 and blocks == 2


def test_k3_fp32_pass_a_holds_two_blocks_at_deit_s(dev):
    """Pass A in fp32 at N = 198 (113 664 bytes, __launch_bounds__(256,
    2)): the runtime's occupancy, registers counted, is two blocks."""
    assert fa.bwd_launch_config(198, False)[3] == 2


# ------------------------------------------ the int8 path's int product
@pytest.mark.parametrize("M,K,N", [(1, 8, 8), (16, 96, 288), (17, 96, 288),
                                   (198, 12, 10), (12672, 384, 2304),
                                   (3136, 3072, 768)])
@pytest.mark.parametrize("column_major", [False, True])
def test_int8_mm_exact_at_padded_shapes_and_layouts(dev, M, K, N,
                                                    column_major):
    """`int8_mm` (torch._int_mm) against its plain version, 0 elements
    differing, at the path's shapes and at those `_int_mm` refuses (M <= 16
    or not a multiple of 8, K or N not a multiple of 8), which the wrapper
    pads; B in either layout; each call counted once."""
    from ofq_tpu_torch.ops import int8_qlinear as iq
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    a = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    b = torch.randint(-15, 16, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    if column_major:
        b = b.t().contiguous().t()
    before = iq.int8_mm.launches
    y = iq.int8_mm(a, b)
    assert iq.int8_mm.launches == before + 1
    assert y.dtype == torch.int32 and tuple(y.shape) == (M, N)
    assert torch.equal(y, iq.int8_mm_reference(a, b))


def test_int8_mm_refuses_other_dtypes(dev):
    from ofq_tpu_torch.ops import int8_qlinear as iq
    a = torch.zeros(32, 8, device=dev)
    with pytest.raises(ValueError, match="int8"):
        iq.int8_mm(a, torch.zeros(8, 8, dtype=torch.int8, device=dev))
