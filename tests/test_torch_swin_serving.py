"""Serving the port's Swin W2A2 QKR student in the bf16 stream on the CPU:
`matmul_impl='pallas'` (K4's plain version) against XLA's compiled JAX
with the Pallas kernel in interpret mode, at `swin_test` size with
depths (2, 2) (a shifted block), and `Predictor.from_flax_npz` for Swin.

Products and sums run in other orders, so a few LSQ levels move, and the
random-weight student carries them on from block to block (see
`test_torch_pallas_slice.py`; measured here: 0.03 % of the LSQ outputs
of the first block on another level, 45 % of the last's).  So each block
(and patch merging) is held alone, against the JAX module applied alone
to the same bf16 input (inside the jitted model XLA fuses a block's last
op into the next block's LayerNorm and skips the bf16 rounding between
them, so the captured intermediates are not the next block's input):
its first LSQ output (after the LayerNorm) at most BF16_FIRST_FLIPS on
another level than JAX's, and all its LSQ outputs together at most
BF16_BLOCK_FLIPS (inside a block a moved level of x moves its token's v
and qkx, and a moved score its query row); the logits end to end within
a relative L2 distance of BF16_LOGITS_L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_pallas_layers import jax_pallas_interpret  # noqa: F401
from test_torch_pallas_slice import _codes_port, _flat_paths
from test_torch_port_common import to_jax_tree, to_numpy_tree
from test_torch_swin_model import (CLASSES, NAME, _images, _models,
                                   _with_head)

from ofq_tpu.models import swin as jswin
from ofq_tpu.nn import quantizers as jquant
from ofq_tpu_torch.convert import flatten_flax_tree, load_flax_params
from ofq_tpu_torch.nn import LsqAct
from ofq_tpu_torch.quant import w2a2_qkr_swin_policy
from ofq_tpu_torch.serve import Predictor

# the limits (module docstring); measured over four seeds: a block's first
# LSQ output 0 elements on another level, all its LSQ outputs at most
# 0.16 %, logits at most 0.031
BF16_FIRST_FLIPS = 1e-3
BF16_BLOCK_FLIPS = 5e-3
BF16_LOGITS_L2 = 0.1


def _init(jm, x, seed=0):
    """Flax's data-dependent init of `jm` on `x` in fp32 (the LSQ scales
    calibrated on the batch), jitted, as numpy."""
    return to_numpy_tree(jax.jit(
        lambda k, xx: jm.init({"params": k}, xx, train=False))(
            jax.random.key(seed), jnp.asarray(x)))


def _jax_codes(mod, v, x):
    """`mod.apply(v, x)` jitted: its output and every LsqAct output inside
    it, by port module name (Flax path with '.')."""
    out, inter = jax.jit(lambda vv, xx: mod.apply(
        vv, xx, mutable=["intermediates"],
        capture_intermediates=lambda m, n: isinstance(m, jquant.LsqAct)
        and n == "__call__"))(v, x)
    flat = flatten_flax_tree(to_numpy_tree(inter["intermediates"]))
    return out, {k.replace("/", ".").rsplit(".__call__", 1)[0]: a
                 for k, a in flat.items()}


def _jax_blocks(jm):
    """The JAX model's blocks and patch mergings as modules of their own,
    by Flax name."""
    cfg, pol = jm.cfg, jm.policy
    out, dim, feat = {}, cfg.embed_dim, 1
    for stage, depth in enumerate(cfg.depths):
        for blk in range(depth):
            out[f"features_{feat}_{blk}"] = jswin.SwinBlock(
                cfg=cfg, policy=pol, dim=dim, num_heads=cfg.num_heads[stage],
                shift=0 if blk % 2 == 0 else cfg.window_size // 2,
                attn_path=f"features.{feat}.{blk}.attn",
                mlp_path=f"features.{feat}.{blk}.mlp")
        feat += 1
        if stage < len(cfg.depths) - 1:
            out[f"features_{feat}"] = jswin.PatchMerging(
                dim=dim, policy=pol, qpath=f"features.{feat}.reduction",
                ln_eps=cfg.ln_eps, compute_dtype=cfg.compute_dtype,
                matmul_impl=cfg.matmul_impl)
            feat += 1
            dim *= 2
    return out


def _block_codes(block, prefix, x):
    """Every LsqAct output of one port block on the input `x`, in call
    order."""
    out = {}
    hooks = [m.register_forward_hook(
        lambda mod, a, y, name=f"{prefix}.{n}": out.__setitem__(name, y))
        for n, m in block.named_modules() if isinstance(m, LsqAct)]
    with torch.no_grad():
        y = block(x)
    for h in hooks:
        h.remove()
    return y, out


def test_bf16_pallas_against_xla(jax_pallas_interpret):
    """Each block alone on the same input as JAX's, and the logits end to
    end (limits in the module docstring)."""
    x = _images(4, 8).astype(np.float32)
    kw = dict(matmul_impl="pallas", compute_dtype="bfloat16")
    jm, tm = _models(True, (2, 2), **kw)
    j32, _ = _models(True, (2, 2))
    variables = _with_head(_init(j32, x), np.random.default_rng(5))
    v = to_jax_tree(variables, np.float32)
    load_flax_params(tm, variables)
    got, _ = _codes_port(tm, x)
    want = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
        v, jnp.asarray(x))[0])
    assert got.dtype == torch.float32
    l2 = float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want))
    assert l2 <= BF16_LOGITS_L2, l2

    # the input of every block: the port's own stream, in bf16
    seen = []
    hooks = [getattr(tm, n).register_forward_hook(
        lambda mod, a, y: seen.append(a[0])) for n in tm.block_names]
    with torch.no_grad():
        tm(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    shares = {}
    for (name, jblock), xin in zip(_jax_blocks(jm).items(), seen):
        assert xin.dtype == torch.bfloat16
        y, codes = _block_codes(getattr(tm, name), "", xin)
        yj, codes_j = _jax_codes(jblock, {"params": v["params"][name]},
                                 jnp.asarray(xin.float().numpy(),
                                             jnp.bfloat16))
        yj = yj[0] if isinstance(yj, tuple) else yj
        assert y.dtype == torch.bfloat16 and str(yj.dtype) == "bfloat16"
        assert {k.lstrip(".") for k in codes} == set(codes_j), name
        moved = [int(np.sum(c.float().numpy()
                            != np.asarray(codes_j[k.lstrip(".")],
                                          np.float32)))
                 for k, c in codes.items()]
        shares[name] = (moved[0] / next(iter(codes.values())).numel(),
                        sum(moved) / sum(c.numel() for c in codes.values()))
    assert list(shares) == tm.block_names
    assert max(a for a, _ in shares.values()) <= BF16_FIRST_FLIPS, shares
    assert max(b for _, b in shares.values()) <= BF16_BLOCK_FLIPS, shares


def test_predictor_from_flax_npz(tmp_path):
    """Serving a Swin model: `Predictor.from_flax_npz` builds the pallas
    bf16 configuration; its probabilities are the model's softmax."""
    x = _images(6, 3).astype(np.float32)
    jm, _ = _models(True)
    variables = _with_head(_init(jm, x, 1), np.random.default_rng(7))
    path = tmp_path / "w.npz"
    np.savez(path, **_flat_paths(variables))
    pred = Predictor.from_flax_npz(
        str(path), model_name=NAME, policy=w2a2_qkr_swin_policy((1, 1)),
        matmul_impl="pallas", attn_impl=None, compute_dtype="bfloat16",
        batch_size=4, device="cpu")
    probs = pred.predict(x)
    assert probs.shape == (3, CLASSES) and np.isfinite(probs).all()
    with torch.no_grad():
        want = torch.softmax(pred.model(torch.from_numpy(
            np.pad(x, ((0, 1), (0, 0), (0, 0), (0, 0))))), -1)
    np.testing.assert_allclose(probs, want[:3].numpy(), rtol=0, atol=0)
