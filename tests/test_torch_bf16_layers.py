"""The layers of the bf16 stream against the Flax modules of `ofq_tpu.nn`,
on the CPU.

  * the bf16 stream (`compute_dtype='bfloat16'`, fp32 parameters; the
    float teacher's layers with bf16 parameters) against XLA's compiled
    JAX, module by module, on 8 images: `QLinear` composed and pallas,
    `QMlp`, `QAttentionQKR` (the QKR chain and the composed tail), a
    `Block`, and `Dense`, `Mlp`, `Attention`, `PatchEmbedConv` of the
    teacher.  Products and sums run in other orders (XLA also keeps some
    bf16 intermediates in fp32 and sums the softmax VJP in bf16 steps, and
    its GELU differs from torch's in a fifth of the bf16 outputs), so a
    bf16 value may round the other way and, now and then, move an LSQ
    level downstream; one moved level changes a whole token row of the
    layer's output by ~10 % (in attention, every query row of its image)
    and every gradient that sums over tokens.  Held (the first limit is
    the binding one): the LSQ outputs (every `LsqAct`), at most BF16_FLIPS
    of their elements on another level than JAX's (counted); the output
    and dx at most BF16_MOVED of their elements off by more than
    2^-6 * |ref| + 2^-7 * max|ref| (two bf16 ulps of the element plus one
    of the tensor's largest); every tensor within a relative L2 distance
    of BF16_L2.  The gradients of the shifts and scales that sum over every
    token (`move*`, `s`) are measured against max(their own, dx's) norm,
    as in fp64 (`move_qkx_aft`'s cancels to rounding noise under the
    softmax).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pallas_layers import jax_pallas_interpret  # noqa: F401
from test_torch_port_common import load_into, perturb, to_numpy_tree
from test_torch_train_layers import C, H, N, _out, _tokens
from test_torch_train_loop import _jax_policy

from ofq_tpu.models import deit as jdeit
from ofq_tpu.nn import attention as jattn
from ofq_tpu.nn import conv as jconv
from ofq_tpu.nn import linear as jlin
from ofq_tpu.nn import quantizers as jquant
from ofq_tpu_torch.convert import flatten_flax_tree
from ofq_tpu_torch.models.deit import Block, DeiTConfig
from ofq_tpu_torch.nn import (Attention, Dense, LsqAct, Mlp,
                              PatchEmbedConv, QAttentionQKR, QLinear, QMlp)
from ofq_tpu_torch.quant import w2a2_qkr_policy

BF16 = torch.bfloat16
# the limits; measured on these cases: flips at most 0.14 % (a Block),
# moved at most 7 %, relative L2 at most 9.3 % (a Block's parameters) and
# 0.8 % where no level moved
BF16_FLIPS = 0.005
BF16_MOVED = 0.15
BF16_L2 = 2 ** -2
B8 = 8  # images in a bf16 case


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else (
        np.asarray(t.astype(jnp.float32)))


def assert_bf16_close(got, want, what, ref=None, moved=BF16_MOVED):
    """Relative L2 distance <= BF16_L2 and at most `moved` of the elements
    moved (module docstring); `ref` stands in for `want` as the scale when
    larger.  Returns (relative L2, moved share)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    ref = want if ref is None else _np(ref)
    scale = max(float(np.abs(want).max()), float(np.abs(ref).max()))
    norm = max(float(np.linalg.norm(want)),
               float(np.linalg.norm(ref)) * np.sqrt(want.size / ref.size))
    if scale == 0:
        assert not np.any(got), what
        return 0.0, 0.0
    l2 = float(np.linalg.norm(got - want)) / norm
    far = float(np.mean(np.abs(got - want)
                        > 2 ** -6 * np.abs(want) + 2 ** -7 * scale))
    assert l2 <= BF16_L2 and far <= moved, (what, l2, far)
    return l2, far


def _bf16_case(jmod, tmod, x, seed, param_dtype=np.float32,
               names=("bias",)):
    """Flax variables (init in fp32, zero shifts set to seeded values,
    parameters in `param_dtype`), one seeded bf16 cotangent; the compiled
    JAX VJP and the port's autograd on the same bf16 (or, for an image,
    fp32) input.  Returns {name: (port, jax)} for the output, dx and every
    parameter gradient, and the share of LSQ outputs on another level."""
    xj = jnp.asarray(np.asarray(x, np.float32))
    if x.ndim == 3:  # a token stream: bf16
        xj = xj.astype(jnp.bfloat16)
    variables = perturb(to_numpy_tree(jmod.init(
        {"params": jax.random.key(seed)}, xj.astype(jnp.float32))),
        np.random.default_rng(seed), names=names)
    pj = jax.tree.map(lambda a: jnp.asarray(a, param_dtype),
                      variables["params"])

    def run(p, xx, g):
        y, pull = jax.vjp(lambda p, xx: _out(jmod.apply({"params": p}, xx)),
                          p, xx)
        return (y,) + pull(g)
    y_shape = jax.eval_shape(lambda p, xx: _out(jmod.apply({"params": p},
                                                           xx)), pj, xj)
    g = np.random.default_rng(seed + 100).normal(size=y_shape.shape)
    gj = jnp.asarray(g, y_shape.dtype)
    yj, gpj, gxj = jax.jit(run)(pj, xj, gj)
    _, inter = jax.jit(lambda p, xx: jmod.apply(
        {"params": p}, xx, capture_intermediates=lambda m, name: isinstance(
            m, jquant.LsqAct) and name == "__call__",
        mutable=["intermediates"]))(pj, xj)
    codes_j = {k.replace("/", ".").rsplit(".__call__", 1)[0]: v
               for k, v in flatten_flax_tree(to_numpy_tree(
                   inter.get("intermediates", {}))).items()}

    load_into(tmod, variables, torch.float32)
    if param_dtype != np.float32:
        tmod.to(BF16)
    tmod.train()
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        BF16 if x.ndim == 3 else torch.float32).requires_grad_()
    params = dict(tmod.named_parameters())
    codes_t = {}
    hooks = [m.register_forward_hook(
        lambda mod, a, out, name=name: codes_t.__setitem__(name, out))
        for name, m in tmod.named_modules() if isinstance(m, LsqAct)]
    y = _out(tmod(xt))
    for h in hooks:
        h.remove()
    assert sorted(codes_t) == sorted(k.rsplit(".", 1)[0] if k.endswith(
        ".0") else k for k in codes_j), (sorted(codes_t), sorted(codes_j))
    moved = sum(int(np.sum(_np(codes_t[k]) != np.asarray(
        codes_j.get(k, codes_j.get(k + ".0")), np.float32)))
        for k in codes_t)
    total = sum(codes_t[k].numel() for k in codes_t)
    assert y.dtype == {jnp.bfloat16: BF16, jnp.float32: torch.float32}[
        y_shape.dtype.type], (y.dtype, y_shape.dtype)
    grads = torch.autograd.grad(
        y, [xt] + list(params.values()),
        torch.from_numpy(np.array(gj.astype(jnp.float32))).to(y.dtype),
        allow_unused=True)
    want = {k.replace("/", "."): v for k, v in
            flatten_flax_tree(to_numpy_tree(gpj)).items()}
    out = {"y": (y, yj), "x": (grads[0], gxj)}
    for (k, p), gt in zip(params.items(), grads[1:]):
        assert (gt.dtype if gt is not None else p.dtype) == p.dtype, k
        out[k] = (torch.zeros_like(p) if gt is None else gt,
                  jnp.asarray(want[k]))
    return out, (moved / total if total else 0.0)


def _check_bf16(case):
    cases, flips = case
    assert flips <= BF16_FLIPS, flips
    dx = cases["x"][1]
    for k, (a, b) in cases.items():
        summed = k.rsplit(".", 1)[-1] == "s" or "move" in k
        assert_bf16_close(a, b, k, dx if summed else None,
                          BF16_MOVED if k in ("x", "y") else 1.0)
    return flips


@pytest.mark.parametrize("impl", [None, "pallas"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_qlinear_bf16(jax_pallas_interpret, impl, symmetric):
    kw = dict(weight_bits=2, input_bits=2, symmetric=symmetric,
              matmul_impl=impl)
    cases = _bf16_case(
        jlin.QLinear(16, compute_dtype="bfloat16", **kw),
        QLinear(C, 16, N, compute_dtype="bfloat16", **kw),
        _tokens(30, shape=(B8, N, C), positive=not symmetric), 30)
    assert cases[0]["y"][0].dtype == cases[0]["x"][0].dtype == BF16
    # the pallas VJP returns dW in fp32, the composition rounds it to bf16
    # on the way back through its cast (as JAX's does)
    _check_bf16(cases)


def test_qmlp_bf16(jax_pallas_interpret):
    kw = dict(weight_bits=2, input_bits=2, matmul_impl="pallas")
    _check_bf16(_bf16_case(
        jlin.QMlp(hidden_features=48, out_features=C,
                  compute_dtype="bfloat16", **kw),
        QMlp(C, 48, C, N, compute_dtype="bfloat16", **kw),
        _tokens(31, shape=(B8, N, C)), 31))


@pytest.mark.parametrize("impl", [None, "pallas"])
def test_qattention_qkr_bf16(jax_pallas_interpret, impl):
    """The QKR chain (v and qkx products, the 4-D LSQ chain) and the
    composed tail (softmax, LSQ, @v) in bf16."""
    kw = dict(weight_bits=2, input_bits=2, matmul_impl=impl)
    _check_bf16(_bf16_case(
        jattn.QAttentionQKR(num_heads=H, compute_dtype="bfloat16", **kw),
        QAttentionQKR(C, H, N, compute_dtype="bfloat16", **kw),
        _tokens(32, shape=(B8, N, C)), 32))


def test_block_bf16(jax_pallas_interpret):
    """One pre-norm block: LayerNorm pinned to bf16, QKR attention, QMlp,
    residuals in bf16."""
    jcfg = jdeit.DeiTConfig(img_size=16, patch_size=8, embed_dim=C,
                            depth=2, num_heads=H, matmul_impl="pallas",
                            compute_dtype="bfloat16")
    tcfg = DeiTConfig(img_size=16, patch_size=8, embed_dim=C, depth=2,
                      num_heads=H, matmul_impl="pallas",
                      compute_dtype="bfloat16")
    x = _tokens(33, shape=(B8, tcfg.n_tokens, C))
    _check_bf16(_bf16_case(
        jdeit.Block(cfg=jcfg, policy=_jax_policy(), index=0),
        Block(tcfg, w2a2_qkr_policy(2), 0), x, 33))


def test_teacher_layers_bf16_params():
    """The float teacher of bench.py: bf16 parameters, bf16 stream; the
    patch embedding sees the fp32 image and stays fp32."""
    for seed, (jm, tm, x) in enumerate((
            (fnn.Dense(16), Dense(C, 16), _tokens(34, shape=(B8, N, C))),
            (jlin.Mlp(hidden_features=48, out_features=C), Mlp(C, 48, C),
             _tokens(35, shape=(B8, N, C))),
            (jattn.Attention(num_heads=H), Attention(C, H),
             _tokens(36, shape=(B8, N, C))),
            (jconv.PatchEmbedConv(features=C, patch_size=(8, 8)),
             PatchEmbedConv(3, C, (8, 8)),
             _tokens(37, shape=(B8, 16, 16, 3))))):
        cases = _bf16_case(jm, tm, x, 40 + seed, param_dtype=jnp.bfloat16)
        want_dtype = torch.float32 if x.ndim == 4 else BF16
        assert cases[0]["y"][0].dtype == want_dtype
        _check_bf16(cases)
