"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips when no CUDA device is present (decided in
the fixture, never at import).  Imports no JAX, so on a machine without it
the file runs alone with the repo's conftest left out:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest -p no:cacheprovider
"""

import pytest
import torch

from ofq_tpu_torch.ops import fused_attention as fa
from ofq_tpu_torch.ops import fused_qlinear as fq
from ofq_tpu_torch.quant.lsq import thresholds
from ofq_tpu_torch.quant.statsq import statsq_scale

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
