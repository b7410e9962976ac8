"""The kernels' plain versions vs the JAX Pallas kernels in interpret mode.

K1: ofq_tpu_torch.ops.fused_qlinear vs ofq_tpu.ops.fused_qlinear.
K2: ofq_tpu_torch.ops.fused_attention vs ofq_tpu.ops.fused_attention.
On the CPU the wrappers must take the plain version and build nothing;
the CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofq_tpu.ops.fused_attention import \
    quantized_attention_core as jax_attention_core
from ofq_tpu.ops.fused_qlinear import fused_qlinear as jax_fused_qlinear
from ofq_tpu_torch.ops import _build
from ofq_tpu_torch.ops import fused_attention as t_attn
from ofq_tpu_torch.ops import fused_qlinear as t_fq

REPO = Path(__file__).resolve().parents[1]


def _qlinear_case(seed, B, N, K, F, all_positive, a_bits, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, K)).astype(np.float32)
    if all_positive:
        x = np.abs(x)
    w = (rng.normal(size=(K, F)) / np.sqrt(K)).astype(np.float32)
    s = (rng.integers(16, 96, size=(N,)) / 128).astype(np.float32)
    b_pre = (rng.integers(-8, 9, size=(K,)) / 256).astype(np.float32)
    b_post = (rng.normal(size=(K,)) * 0.05).astype(np.float32)
    bias = (rng.normal(size=(F,)) * 0.1).astype(np.float32)
    if ties:
        # (x + b_pre) / s = k + 0.5 exactly for a third of the entries
        lo = 0 if all_positive else -(2 ** (a_bits - 1))
        k = rng.integers(lo, 2 ** (a_bits - 1), size=(B, N, K))
        tie = (s[None, :, None] * (k + 0.5) - b_pre).astype(np.float32)
        mask = rng.random(size=x.shape) < 1 / 3
        x = np.where(mask, tie, x).astype(np.float32)
    return x, w, s, b_pre, b_post, bias


@pytest.mark.parametrize("name,B,N,K,F,all_positive,bits", [
    ("w2a2_signed", 2, 10, 64, 32, False, 2),
    ("w2a2_unsigned", 2, 10, 64, 32, True, 2),
    ("w4a4_signed", 2, 10, 64, 32, False, 4),
    ("ragged", 2, 10, 48, 24, False, 2),
    ("ragged_unsigned_w3", 3, 7, 40, 20, True, 3),
])
@pytest.mark.parametrize("ties", [False, True])
def test_k1_plain_matches_pallas(name, B, N, K, F, all_positive, bits, ties):
    x, w, s, b_pre, b_post, bias = _qlinear_case(
        sum(map(ord, name)), B, N, K, F, all_positive, bits, ties)
    kw = dict(w_bits=bits, a_bits=bits, all_positive=all_positive)
    yj = np.asarray(jax_fused_qlinear(
        *(jnp.asarray(a) for a in (x, w, s, b_pre, b_post, bias)),
        interpret=True, **kw))
    before = t_fq.fused_qlinear_fwd.launches
    yt = t_fq.fused_qlinear(
        *(torch.from_numpy(a) for a in (x, w, s, b_pre, b_post, bias)),
        **kw).numpy()
    assert t_fq.fused_qlinear_fwd.launches == before
    assert yt.shape == yj.shape == (B, N, F)
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)


def test_k1_no_bias():
    x, w, s, b_pre, b_post, _ = _qlinear_case(3, 2, 5, 32, 16, False, 2)
    yj = np.asarray(jax_fused_qlinear(
        *(jnp.asarray(a) for a in (x, w, s, b_pre, b_post)), None,
        w_bits=2, a_bits=2, interpret=True))
    yt = t_fq.fused_qlinear(
        *(torch.from_numpy(a) for a in (x, w, s, b_pre, b_post)), None,
        w_bits=2, a_bits=2).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)


def test_k1_reference_integer_core():
    """The plain version's product is exact integer arithmetic: the
    codes times the odd weight levels, then the epilogue."""
    x, w, s, b_pre, _, _ = _qlinear_case(4, 1, 6, 32, 8, False, 2)
    x2 = torch.from_numpy(x.reshape(-1, 32))
    sw = torch.from_numpy(2 * np.abs(w).mean(0, keepdims=True))
    y = t_fq.fused_qlinear_fwd_reference(
        x2, torch.from_numpy(s), 6, torch.from_numpy(b_pre),
        torch.from_numpy(w), sw, torch.zeros(8), -2, 1, 2.0)
    xi = np.clip(np.round((x.reshape(-1, 32) + b_pre) / np.tile(s, 1)[:, None]),
                 -2, 1)
    wi = 2 * np.round(np.clip(w / sw.numpy(), -1, 1 - 1e-6) * 2 - 0.5) + 1
    assert set(np.unique(wi)) <= {-3.0, -1.0, 1.0, 3.0}
    ref = (xi @ wi) * s[:, None] * (sw.numpy() / 4)
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-6, atol=1e-7)


B, N, H, K, D = 2, 12, 3, 16, 8


def _attn_case(seed, shared_lhs):
    rng = np.random.default_rng(seed)
    lhs = rng.normal(size=(B, N, K) if shared_lhs else (B, N, H, K))
    rhs = rng.normal(size=(B, N, H, K))
    v = rng.normal(size=(B, N, H, D))
    s = np.abs(rng.normal(size=(N,))) * 0.05 + 0.02
    s[0] = 1e-7  # below the 1e-5 floor
    return [a.astype(np.float32) for a in (lhs, rhs, v, s)]


@pytest.mark.parametrize("shared_lhs", [True, False])
@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("bits", [2, 4])
def test_k2_plain_matches_pallas(shared_lhs, quantize, bits):
    lhs, rhs, v, s = _attn_case(bits, shared_lhs)
    kw = dict(bits=bits, sm_scale=0.25, quantize_softmax=quantize)
    oj = np.asarray(jax_attention_core(
        *(jnp.asarray(a) for a in (lhs, rhs, v, s)), interpret=True, **kw))
    before = t_attn.qkr_attention_fwd.launches
    ot = t_attn.quantized_attention_core(
        *(torch.from_numpy(a) for a in (lhs, rhs, v, s)), **kw).numpy()
    assert t_attn.qkr_attention_fwd.launches == before
    assert ot.shape == oj.shape == (B, N, H, D)
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-5)


def test_k2_quantized_levels():
    """With quantization on, every probability the plain version uses is a
    multiple of its row's scale, in [0, 2^bits - 1]."""
    lhs, rhs, _, s = _attn_case(9, True)
    eye = np.zeros((B, N, H, N), np.float32)
    for m in range(N):
        eye[:, m, :, m] = 1.0  # v = one-hot keys: out[n, h, m] = pq[n, m]
    pq = t_attn.qkr_attention_fwd_reference(
        *(torch.from_numpy(a) for a in (lhs, rhs, eye, s)), 2, 0.25,
        True).numpy()
    levels = pq / np.maximum(s, 1e-5)[None, :, None, None]
    np.testing.assert_allclose(levels, np.round(levels), atol=1e-4)
    assert levels.min() >= -1e-6 and levels.max() <= 3 + 1e-4


def test_cpu_dispatch_builds_nothing(monkeypatch):
    """A CPU tensor takes the plain version: the kernel library is never
    loaded or built."""
    def refuse(*a, **kw):
        raise AssertionError("kernel build/load reached on a CPU tensor")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    x, w, s, b_pre, b_post, bias = _qlinear_case(1, 2, 4, 16, 8, False, 2)
    t_fq.fused_qlinear(*(torch.from_numpy(a) for a in
                         (x, w, s, b_pre, b_post, bias)), w_bits=2, a_bits=2)
    lhs, rhs, v, s = _attn_case(1, True)
    t_attn.quantized_attention_core(
        *(torch.from_numpy(a) for a in (lhs, rhs, v, s)), bits=2,
        sm_scale=0.25)


def test_import_builds_nothing(tmp_path):
    """Importing every module of the package starts no compiler and loads
    no kernel library."""
    code = textwrap.dedent("""
        import subprocess
        def refuse(*a, **kw):
            raise AssertionError("a process was started at import")
        subprocess.Popen = refuse
        import ofq_tpu_torch, ofq_tpu_torch.ops, ofq_tpu_torch.serve
        import ofq_tpu_torch.calibrate, ofq_tpu_torch.convert
        import ofq_tpu_torch.models, ofq_tpu_torch.nn, ofq_tpu_torch.quant
        import ofq_tpu_torch.cli.runner, ofq_tpu_torch.train.checkpoint
        from ofq_tpu_torch.ops import _build
        assert _build._LIBS == {}, _build._LIBS
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_nvcc_flags():
    """The build targets sm_90a, and never uses fast math (approximate
    division and flushed denormals would move rounding decisions)."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "-gencode=arch=compute_90a,code=sm_90a" in flags
    assert "-O3" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "__expf(" not in src and "roundf(" not in src
        assert "extern \"C\"" in src
