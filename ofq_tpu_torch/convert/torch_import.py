"""Convert the original repository's (torch) checkpoints into nested
numpy trees keyed by the Flax paths (port of
`ofq_tpu/convert/torch_import.py:29-383`).

Covers three checkpoint flavours:
  * float timm DeiT checkpoints (deit_*_distilled_patch16_224): the
    `--pretrained_initialized` QAT warm starts,
  * the original repository's QAT checkpoints (CheckpointSaver
    `*.pth.tar` with quantizer state: LSQ `s`, LearnableBias, StatsQ
    clip_val): eval parity,
  * torchvision Swin-T checkpoints.

The mapping is rule-based with layout fixups: a torch Linear (out, in)
becomes a Flax-layout (in, out) kernel, a torch conv OIHW becomes HWIO,
and `split_qkv_for_qkr` splits a fused qkv for QKR models.  The trees are
the JAX package's, leaf for leaf, so `convert.load_flax_params` takes them
into a port model with no transposes (after `merge_pretrained` onto the
model's own tree, as the runner does).  Pure numpy past `torch.load`; a
spatial patch-embedding bias stored at another resolution is resampled as
`jax.image.resize(..., "bilinear")` does (`_jax_bilinear_resize`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The state dict of a `.pth`/`.pth.tar`/`.pt`/`.bin` file (under
    `state_dict`, `model` or `state_dict_ema` when nested), `module.`
    prefixes dropped, as numpy arrays (bf16 as fp32).  Loaded with
    `weights_only=True`: tensors and plain containers only."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "state_dict_ema"):
        if isinstance(obj, dict) and key in obj:
            obj = obj[key]
            break
    out = {}
    for k, v in obj.items():
        k = k.removeprefix("module.")
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                v = v.float()
            out[k] = v.numpy()
    return out


def _set(tree: dict, path: list[str], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _linear(sd, prefix, dst, tree, bias=True):
    _set(tree, dst + ["kernel"], sd[prefix + ".weight"].T)
    if bias and prefix + ".bias" in sd:
        _set(tree, dst + ["bias"], sd[prefix + ".bias"])


def _norm(sd, prefix, dst, tree):
    _set(tree, dst + ["scale"], sd[prefix + ".weight"])
    _set(tree, dst + ["bias"], sd[prefix + ".bias"])


def _maybe(sd, key, dst, tree, transform=None):
    if key in sd:
        v = sd[key]
        if transform is not None:
            v = transform(v)
        _set(tree, dst, v)
        return True
    return False


def _qlinear(sd, prefix, dst, tree):
    """Reference QLinear / LSQ_w_and_act_QLinear / plain Linear -> ours."""
    _linear(sd, prefix, dst, tree)
    _maybe(sd, f"{prefix}.move_b4.bias", dst + ["move_b4", "bias"], tree)
    _maybe(sd, f"{prefix}.move_aft.bias", dst + ["move_aft", "bias"], tree)
    _maybe(sd, f"{prefix}.input_quant_fn.s", dst + ["input_quant", "s"], tree)
    _maybe(sd, f"{prefix}.lsqw_fn.s", dst + ["weight_quant", "s"], tree)


def _attention(sd, prefix, dst, tree, img_tokens: int | None = None):
    """QAttention / float attention / QKR, detected from present keys."""
    qkr = f"{prefix}.q.weight" in sd
    if qkr:
        _set(tree, dst + ["q_kernel"], sd[f"{prefix}.q.weight"].T)
        _set(tree, dst + ["k_kernel"], sd[f"{prefix}.k.weight"].T)
        _set(tree, dst + ["v_kernel"], sd[f"{prefix}.v.weight"].T)
        _set(tree, dst + ["v_bias"], sd[f"{prefix}.v.bias"])
        _maybe(sd, f"{prefix}.quant_x_4_qkv.move_b4.bias",
               dst + ["quant_x_move_b4", "bias"], tree)
        _maybe(sd, f"{prefix}.quant_x_4_qkv.move_aft.bias",
               dst + ["quant_x_move_aft", "bias"], tree)
        _maybe(sd, f"{prefix}.quant_x_4_qkv.input_quant_fn.s",
               dst + ["quant_x", "s"], tree)
        _maybe(sd, f"{prefix}.move_qkx_b4.bias", dst + ["move_qkx_b4", "bias"], tree)
        _maybe(sd, f"{prefix}.move_qkx_aft.bias", dst + ["move_qkx_aft", "bias"], tree)
        _maybe(sd, f"{prefix}.quan_a_qkx_fn.s", dst + ["quan_qkx", "s"], tree)
        _maybe(sd, f"{prefix}.move_v_b4.bias", dst + ["move_v_b4", "bias"], tree)
        _maybe(sd, f"{prefix}.move_v_aft.bias", dst + ["move_v_aft", "bias"], tree)
        _maybe(sd, f"{prefix}.quan_a_v_fn.s", dst + ["quan_v", "s"], tree)
        _maybe(sd, f"{prefix}.quan_a_softmax_fn.s", dst + ["quan_softmax", "s"], tree)
    else:
        _qlinear(sd, f"{prefix}.qkv", dst + ["qkv"], tree)
        _maybe(sd, f"{prefix}.move_qkv_b4.bias", dst + ["move_qkv_b4", "bias"], tree)
        for name, ours in (("quan_a_q_fn", "quan_q"), ("quan_a_k_fn", "quan_k"),
                           ("quan_a_v_fn", "quan_v"),
                           ("quan_a_softmax_fn", "quan_softmax")):
            _maybe(sd, f"{prefix}.{name}.s", dst + [ours, "s"], tree)
        for mv in ("move_q_aft", "move_k_aft", "move_v_aft"):
            _maybe(sd, f"{prefix}.{mv}.bias", dst + [mv, "bias"], tree)
    _qlinear(sd, f"{prefix}.proj", dst + ["proj"], tree)


def _bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of `jax.image.resize`'s "bilinear" along one
    axis: the triangle kernel at half-pixel centres, widened by the
    downscale factor (antialiasing), each column normalised, and zero for
    a sample outside the input."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv = np.float32(1.0) / scale
    kscale = max(inv, np.float32(1.0))
    f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    x = np.abs(f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / kscale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (f >= -0.5) & (f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _jax_bilinear_resize(b: np.ndarray, shape: tuple) -> np.ndarray:
    """`jax.image.resize(b, shape, method="bilinear")` of a 2-D array,
    contracted in fp64 and rounded to fp32."""
    wh = _bilinear_weights(b.shape[0], shape[0]).astype(np.float64)
    ww = _bilinear_weights(b.shape[1], shape[1]).astype(np.float64)
    out = np.einsum("hw,hH,wW->HW", np.asarray(b, np.float64), wh, ww)
    return out.astype(np.float32)


def _patch_embed(sd, prefix, dst, tree, img_size: int):
    """Conv patchify: torch OIHW -> HWIO; LSQ_QConv2d quantizer state."""
    w = sd[f"{prefix}.weight"]
    _set(tree, dst + ["kernel"], w.transpose(2, 3, 1, 0))
    _maybe(sd, f"{prefix}.bias", dst + ["bias"], tree)
    _maybe(sd, f"{prefix}.lsqw_fn.s", dst + ["weight_quant", "s"], tree)
    _maybe(sd, f"{prefix}.input_quant_fn.s", dst + ["input_quant", "s"], tree)

    def spatial_bias(v):
        # stored flat at the checkpoint's own resolution; resample if the
        # target img_size differs (reference hardcodes 224*224,
        # qlinear.py:163)
        side = int(round(math.sqrt(v.size)))
        b = v.reshape(side, side)
        if side != img_size:
            b = _jax_bilinear_resize(b, (img_size, img_size))
        return b

    for mv in ("move_b4", "move_aft"):
        _maybe(sd, f"{prefix}.{mv}.bias", dst + [mv, "bias"], tree,
               transform=spatial_bias)


def convert_bn_stats(sd: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """BatchNorm running statistics of a --replace-ln-by-bn checkpoint
    (reference src/utils/utils.py swap; torch keys `<site>.running_mean`/
    `.running_var`) -> a flax 'batch_stats' tree mirroring convert_deit's
    module naming ({site}/{mean,var}).  Returns {} for plain-LN
    checkpoints; `num_batches_tracked` is intentionally dropped (our
    TorchBatchNorm uses fixed momentum, as the reference's BatchNorm
    does — it never enables the momentum=None running-average mode)."""
    tree: Dict[str, Any] = {}
    for k, v in sd.items():
        if not (k.endswith(".running_mean") or k.endswith(".running_var")):
            continue
        leaf = "mean" if k.endswith(".running_mean") else "var"
        site = k.rsplit(".", 1)[0]
        if site == "features.0.2":
            # torchvision Swin patch-embed LN -> our 'patch_norm'
            # (mirrors convert_swin's params mapping)
            _set(tree, ["patch_norm", leaf], np.asarray(v))
            continue
        parts = site.split(".")
        dst: list[str] = []
        i = 0
        while i < len(parts):
            # torch 'blocks.N.<site>' -> flax 'blocks_N/<site>' (DeiT);
            # torchvision Swin 'features.F.B.<site>' -> 'features_F_B'
            if (parts[i] in ("blocks", "features") and i + 1 < len(parts)
                    and parts[i + 1].isdigit()):
                name = f"{parts[i]}_{parts[i + 1]}"
                i += 2
                while i < len(parts) and parts[i].isdigit():
                    name += f"_{parts[i]}"
                    i += 1
                dst.append(name)
            else:
                dst.append(parts[i])
                i += 1
        _set(tree, dst + [leaf], np.asarray(v))
    return tree


def convert_deit(sd: Mapping[str, np.ndarray], *, depth: int = 12,
                 img_size: int = 224) -> Dict[str, Any]:
    """Reference DeiT checkpoint (FP or OFQ-quantized) -> Flax params dict."""
    tree: Dict[str, Any] = {}
    _maybe(sd, "cls_token", ["cls_token"], tree)
    _maybe(sd, "dist_token", ["dist_token"], tree)
    _maybe(sd, "pos_embed", ["pos_embed"], tree)
    _patch_embed(sd, "patch_embed.proj", ["patch_embed"], tree, img_size)
    for i in range(depth):
        src = f"blocks.{i}"
        dst = [f"blocks_{i}"]
        _norm(sd, f"{src}.norm1", dst + ["norm1"], tree)
        _norm(sd, f"{src}.norm2", dst + ["norm2"], tree)
        _attention(sd, f"{src}.attn", dst + ["attn"], tree)
        _qlinear(sd, f"{src}.mlp.fc1", dst + ["mlp", "fc1"], tree)
        _qlinear(sd, f"{src}.mlp.fc2", dst + ["mlp", "fc2"], tree)
        # --act-layer prelu: torch nn.PReLU stores 'act.weight' (1,)
        # (reference ACT_LAYER_MAPPINGS, train.py:391-396)
        _maybe(sd, f"{src}.mlp.act.weight", dst + ["mlp", "act", "alpha"],
               tree)
    _norm(sd, "norm", ["norm"], tree)
    for head in ("head", "head_dist"):
        if f"{head}.weight" in sd:
            _qlinear(sd, head, [head], tree)
    return tree


def convert_swin(sd: Mapping[str, np.ndarray], *,
                 depths=(2, 2, 6, 2), img_size: int = 224) -> Dict[str, Any]:
    """torchvision/OFQ Swin checkpoint -> Flax params dict."""
    tree: Dict[str, Any] = {}
    _patch_embed(sd, "features.0.0", ["patch_embed"], tree, img_size)
    _norm(sd, "features.0.2", ["patch_norm"], tree)
    feat_idx = 1
    for stage, depth in enumerate(depths):
        for blk in range(depth):
            src = f"features.{feat_idx}.{blk}"
            dst = [f"features_{feat_idx}_{blk}"]
            _norm(sd, f"{src}.norm1", dst + ["norm1"], tree)
            _norm(sd, f"{src}.norm2", dst + ["norm2"], tree)
            _attention(sd, f"{src}.attn", dst + ["attn"], tree)
            _maybe(sd, f"{src}.attn.relative_position_bias_table",
                   dst + ["attn", "relative_position_bias_table"], tree)
            # torchvision MLP: mlp.0 / mlp.3 are the two linears; the
            # quantized QMLP_swin renames them fc1/fc2.
            if f"{src}.mlp.fc1.weight" in sd:
                _qlinear(sd, f"{src}.mlp.fc1", dst + ["mlp", "fc1"], tree)
                _qlinear(sd, f"{src}.mlp.fc2", dst + ["mlp", "fc2"], tree)
                _maybe(sd, f"{src}.mlp.act.weight",
                       dst + ["mlp", "act", "alpha"], tree)
            else:
                _linear(sd, f"{src}.mlp.0", dst + ["mlp", "fc1"], tree)
                _linear(sd, f"{src}.mlp.3", dst + ["mlp", "fc2"], tree)
        feat_idx += 1
        if stage < len(depths) - 1:
            src = f"features.{feat_idx}"
            dst = [f"features_{feat_idx}"]
            _norm(sd, f"{src}.norm", dst + ["norm"], tree)
            _qlinear(sd, f"{src}.reduction", dst + ["reduction"], tree)
            feat_idx += 1
    _norm(sd, "norm", ["norm"], tree)
    _qlinear(sd, "head", ["head"], tree)
    return tree


def split_qkv_for_qkr(params: Dict[str, Any]) -> Dict[str, Any]:
    """FP warm start for a QKR model: split each fused qkv kernel into
    q/k/v thirds (reference attention.py:130-138).  Operates on a
    converted *float* tree in place.

    Walks the tree STRUCTURALLY (any module whose 'attn' child carries a
    fused 'qkv'), so it covers DeiT's `blocks_i/attn` and Swin's
    `features_f_b/attn` alike — the old depth-indexed walk silently
    skipped Swin, leaving every attention projection at random init on a
    QKR warm start."""

    def walk(node):
        if not isinstance(node, dict):
            return
        attn = node.get("attn")
        if (isinstance(attn, dict) and "qkv" in attn
                and "q_kernel" not in attn):
            k = attn.pop("qkv")
            kern = k["kernel"]  # (C, 3C)
            C = kern.shape[0]
            attn["q_kernel"] = kern[:, :C]
            attn["k_kernel"] = kern[:, C:2 * C]
            attn["v_kernel"] = kern[:, 2 * C:]
            if "bias" in k:
                attn["v_bias"] = k["bias"][2 * C:]
        for v in node.values():
            walk(v)

    walk(params)
    return params


def _infer_num_tokens(old_len: int, new_len: int) -> int:
    """Prefix-token count (cls / cls+dist): the p in {2, 1, 0} for which
    both lengths minus p are perfect squares."""
    for p in (2, 1, 0):
        a, b = old_len - p, new_len - p
        if a > 0 and b > 0 and int(math.isqrt(a)) ** 2 == a \
                and int(math.isqrt(b)) ** 2 == b:
            return p
    raise ValueError(f"cannot infer prefix tokens for {old_len}->{new_len}")


def _bicubic_1d_weights(n_in: int, n_out: int):
    """Sample positions + tap weights of torch's upsample_bicubic2d
    (align_corners=False, antialias=False): cubic convolution with
    A=-0.75, half-pixel source centers, border-clamped taps.  Returns
    (idx (n_out, 4) int, w (n_out, 4) float64)."""
    A = -0.75
    scale = n_in / n_out
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    x0 = np.floor(x)
    t = x - x0

    def k1(d):  # |d| <= 1
        return ((A + 2.0) * d - (A + 3.0)) * d * d + 1.0

    def k2(d):  # 1 < |d| < 2
        return ((A * d - 5.0 * A) * d + 8.0 * A) * d - 4.0 * A

    w = np.stack([k2(t + 1.0), k1(t), k1(1.0 - t), k2(2.0 - t)], axis=1)
    idx = x0[:, None].astype(np.int64) + np.arange(-1, 3)[None, :]
    return np.clip(idx, 0, n_in - 1), w


def torch_bicubic_resize(grid: np.ndarray, gs_new: tuple) -> np.ndarray:
    """(H, W, C) -> (gs_new[0], gs_new[1], C), bit-matching torch's
    F.interpolate(mode='bicubic', align_corners=False) in float64
    (reference resize_pos_embed, deit_vision_transformer.py:449-468,
    uses exactly that call)."""
    g = np.asarray(grid, np.float64)
    ih, wh = _bicubic_1d_weights(g.shape[0], gs_new[0])
    g = np.einsum("ot,otwc->owc", wh, g[ih])          # (H', W, C)
    iw, ww = _bicubic_1d_weights(grid.shape[1], gs_new[1])
    g = np.einsum("ot,othc->ohc", ww, g.transpose(1, 0, 2)[iw])
    return g.transpose(1, 0, 2)                       # (H', W', C)


def resize_pos_embed(posemb: np.ndarray, new_len: int,
                     num_tokens: int | None = None) -> np.ndarray:
    """Bicubic-resample a (1, N_old, C) position embedding grid to a new
    token count (reference: deit_vision_transformer.py:449-468).  Prefix
    tokens (cls/dist) are carried over unscaled; their count is inferred
    when not given.  The interpolation reproduces torch's
    F.interpolate(mode='bicubic', align_corners=False) exactly — NOT
    jax.image.resize, whose Keys kernel (a=-0.5) and antialiasing differ."""
    if num_tokens is None:
        num_tokens = _infer_num_tokens(posemb.shape[1], new_len)
    tok, grid = posemb[:, :num_tokens], posemb[0, num_tokens:]
    gs_old = int(math.isqrt(grid.shape[0]))
    gs_new = int(math.isqrt(new_len - num_tokens))
    if gs_old == gs_new:
        return posemb
    g = torch_bicubic_resize(grid.reshape(gs_old, gs_old, -1),
                             (gs_new, gs_new))
    g = g.astype(posemb.dtype).reshape(1, gs_new * gs_new, -1)
    return np.concatenate([tok, g], axis=1)


def merge_pretrained(init_params: Dict[str, Any],
                     loaded: Dict[str, Any]) -> Dict[str, Any]:
    """Overlay loaded leaves onto an initialized tree (strict=False analog,
    train.py:515-516): leaves present in both are replaced when shapes
    match; quantizer params missing from an FP checkpoint keep their
    calibration init."""

    def overlay(dst, src):
        out = dict(dst)
        for k, v in src.items():
            if k not in dst:
                continue
            if isinstance(v, dict) and isinstance(dst[k], dict):
                out[k] = overlay(dst[k], v)
            elif not isinstance(v, dict):
                want = tuple(np.shape(dst[k]))
                have = tuple(np.shape(v))
                if want == have:
                    out[k] = np.asarray(v, dtype=np.float32)
                elif (k == "pos_embed" and len(want) == 3 and len(have) == 3
                      and want[-1] == have[-1]):
                    # grid-size mismatch: bicubic-resample like the
                    # reference's resize_pos_embed (deit_vision_
                    # transformer.py:449-468); keep the init value when the
                    # resample cannot produce the wanted length (e.g.
                    # distilled <-> non-distilled prefix mismatch)
                    try:
                        resized = resize_pos_embed(
                            np.asarray(v, np.float32), want[1]
                        ).astype(np.float32)
                        if resized.shape == want:
                            out[k] = resized
                    except ValueError:
                        pass
        return out

    return overlay(init_params, loaded)
