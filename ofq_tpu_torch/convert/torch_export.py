"""Export the port's parameter trees as the original repository's torch
state dicts (port of `ofq_tpu/convert/torch_export.py:186-353`).

The inverse of `torch_import`: a model trained in the port goes back to
the original repository's ecosystem as a standard `.pth.tar`
(`{"state_dict": ...}`, the CheckpointSaver layout its `eval.py --resume`
reads with a strict=False load, train.py:515-516).  The trees are the
Flax-path trees of `convert.model_variables` (or the JAX package's): the
output is the JAX package's export of the same values, key for key.

Layout fixups mirror the importer in reverse: (in, out) kernels -> torch
(out, in) `weight`, HWIO conv -> OIHW, QKR q/k/v -> separate `q./k./v.`
Linears, spatial patch-embed move biases (H, W) -> the flat (H*W,) the
original stores (qlinear.py:163).

Reference-only state the Flax tree does not carry is reconstructed:
  * `*.statsq_fn.clip_val` / `qk_quant.clip_val` / `v_quant.clip_val`:
    requires_grad=False constants pinned at 2.0 (statsq.py:126-128) —
    emitted as 2.0 so strict loads succeed and the clamp matches our
    compile-time [-1, 1-1e-6] clip.
  * `patch_embed.proj.input_quant_fn.signed`: the 4img signedness buffer
    (lsq.py:310) — taken from our 'quant_stats' collection when given,
    else 1.0 (normalized image streams always contain negatives).
  * Swin `relative_position_index` / shift masks: static geometry the
    reference rebuilds at construction — intentionally NOT emitted
    (load with strict=False, or construction defaults already match).

Detection is structural, like the importer: a module node with
`input_quant`/`move_b4` children is a quantized QLinear (statsq weights
unless a `weight_quant` LSQ scale is present), `q_kernel` marks QKR
attention, a fused `qkv` child the plain/float one.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

_CLIP_VAL = np.asarray([2.0], np.float32)  # statsq.py:126-128, fixed


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):  # a tensor, bf16 included
        v = v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def _is_quantized_linear(node: Mapping[str, Any]) -> bool:
    return any(k in node for k in ("input_quant", "move_b4", "weight_quant"))


def _linear(node: Mapping[str, Any], prefix: str, out: Dict[str, np.ndarray]):
    out[f"{prefix}.weight"] = _np(node["kernel"]).T
    if "bias" in node:
        out[f"{prefix}.bias"] = _np(node["bias"])


def _qlinear(node: Mapping[str, Any], prefix: str,
             out: Dict[str, np.ndarray]):
    """Inverse of torch_import._qlinear + the statsq clip_val constant."""
    _linear(node, prefix, out)
    if "move_b4" in node:
        out[f"{prefix}.move_b4.bias"] = _np(node["move_b4"]["bias"])
    if "move_aft" in node:
        out[f"{prefix}.move_aft.bias"] = _np(node["move_aft"]["bias"])
    if "input_quant" in node:
        out[f"{prefix}.input_quant_fn.s"] = _np(node["input_quant"]["s"])
    if "weight_quant" in node:
        out[f"{prefix}.lsqw_fn.s"] = _np(node["weight_quant"]["s"])
    elif _is_quantized_linear(node):
        # StatsQ weights carry no learnable state; the reference module
        # still persists its fixed clip_val buffer
        out[f"{prefix}.statsq_fn.clip_val"] = _CLIP_VAL.copy()


def _attention(node: Mapping[str, Any], prefix: str,
               out: Dict[str, np.ndarray]):
    """Inverse of torch_import._attention (QKR / plain, float / quantized)."""
    if "q_kernel" in node:  # QKR: split q/k/v Linears (attention.py:130-138)
        out[f"{prefix}.q.weight"] = _np(node["q_kernel"]).T
        out[f"{prefix}.k.weight"] = _np(node["k_kernel"]).T
        out[f"{prefix}.v.weight"] = _np(node["v_kernel"]).T
        out[f"{prefix}.v.bias"] = _np(node["v_bias"])
        if "quant_x_move_b4" in node:
            out[f"{prefix}.quant_x_4_qkv.move_b4.bias"] = _np(
                node["quant_x_move_b4"]["bias"])
        if "quant_x_move_aft" in node:
            out[f"{prefix}.quant_x_4_qkv.move_aft.bias"] = _np(
                node["quant_x_move_aft"]["bias"])
        if "quant_x" in node:
            out[f"{prefix}.quant_x_4_qkv.input_quant_fn.s"] = _np(
                node["quant_x"]["s"])
        for ours, theirs in (("move_qkx_b4", "move_qkx_b4"),
                             ("move_qkx_aft", "move_qkx_aft"),
                             ("move_v_b4", "move_v_b4"),
                             ("move_v_aft", "move_v_aft")):
            if ours in node:
                out[f"{prefix}.{theirs}.bias"] = _np(node[ours]["bias"])
        for ours, theirs in (("quan_qkx", "quan_a_qkx_fn"),
                             ("quan_v", "quan_a_v_fn"),
                             ("quan_softmax", "quan_a_softmax_fn")):
            if ours in node:
                out[f"{prefix}.{theirs}.s"] = _np(node[ours]["s"])
        # the QKR W_qk / v-linear StatsQ quantizers' fixed buffers
        # (attention.py:190-210): QKR attention always StatsQ-quantizes
        # its weight products, independent of the activation quantizers,
        # so emit unconditionally (q_kernel itself marks a quantized tree)
        out[f"{prefix}.qk_quant.clip_val"] = _CLIP_VAL.copy()
        out[f"{prefix}.v_quant.clip_val"] = _CLIP_VAL.copy()
    else:
        _qlinear(node["qkv"], f"{prefix}.qkv", out)
        if "move_qkv_b4" in node:
            out[f"{prefix}.move_qkv_b4.bias"] = _np(
                node["move_qkv_b4"]["bias"])
        for ours, theirs in (("quan_q", "quan_a_q_fn"),
                             ("quan_k", "quan_a_k_fn"),
                             ("quan_v", "quan_a_v_fn"),
                             ("quan_softmax", "quan_a_softmax_fn")):
            if ours in node:
                out[f"{prefix}.{theirs}.s"] = _np(node[ours]["s"])
        for mv in ("move_q_aft", "move_k_aft", "move_v_aft"):
            if mv in node:
                out[f"{prefix}.{mv}.bias"] = _np(node[mv]["bias"])
    _qlinear(node["proj"], f"{prefix}.proj", out)


def _mlp_act(mlp: Mapping[str, Any], prefix: str,
             out: Dict[str, np.ndarray]):
    """--act-layer prelu stores 'act.weight' in the reference (torch
    nn.PReLU, train.py:391-396).  RPReLU has no reference checkpoint
    layout (the reference's rprelu path never constructs its submodules,
    qlinear.py:110-131) — refuse rather than silently dropping learned
    params."""
    act = mlp.get("act")
    if not isinstance(act, dict):
        return
    if "move1" in act:
        raise NotImplementedError(
            "rprelu act params have no reference state_dict layout "
            "(the reference's rprelu path is non-functional); export "
            "is only defined for prelu/parameter-free activations")
    if "alpha" in act:
        out[f"{prefix}.act.weight"] = _np(act["alpha"])


def _norm(node: Mapping[str, Any], prefix: str, out: Dict[str, np.ndarray],
          stats: Optional[Mapping[str, Any]] = None):
    out[f"{prefix}.weight"] = _np(node["scale"])
    out[f"{prefix}.bias"] = _np(node["bias"])
    if stats is not None:
        # --replace-ln-by-bn site: the reference's BatchNorm persists
        # running stats + num_batches_tracked (torch _BatchNorm buffers;
        # the counter is unused under fixed momentum — emitted as 0 so
        # strict loads succeed)
        out[f"{prefix}.running_mean"] = _np(stats["mean"])
        out[f"{prefix}.running_var"] = _np(stats["var"])
        out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _patch_embed(node: Mapping[str, Any], prefix: str,
                 out: Dict[str, np.ndarray],
                 signed: Optional[float]):
    """Inverse of torch_import._patch_embed: HWIO -> OIHW, (H, W) spatial
    move biases -> the flat layout (qlinear.py:163)."""
    out[f"{prefix}.weight"] = _np(node["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in node:
        out[f"{prefix}.bias"] = _np(node["bias"])
    if "weight_quant" in node:
        out[f"{prefix}.lsqw_fn.s"] = _np(node["weight_quant"]["s"])
    if "input_quant" in node:
        out[f"{prefix}.input_quant_fn.s"] = _np(node["input_quant"]["s"])
        # LsqQuantizer4img's persistent signedness buffer (lsq.py:310);
        # ours lives in the 'quant_stats' collection
        out[f"{prefix}.input_quant_fn.signed"] = np.asarray(
            [1.0 if signed is None else float(signed)], np.float32)
    for mv in ("move_b4", "move_aft"):
        if mv in node:
            out[f"{prefix}.{mv}.bias"] = _np(node[mv]["bias"]).reshape(-1)


def _patch_embed_signed(quant_stats: Optional[Mapping[str, Any]]
                        ) -> Optional[float]:
    if not quant_stats:
        return None
    node = quant_stats.get("patch_embed", {}).get("input_quant", {})
    return float(np.asarray(node["signed"])) if "signed" in node else None


def export_deit(params: Mapping[str, Any], *,
                quant_stats: Optional[Mapping[str, Any]] = None,
                batch_stats: Optional[Mapping[str, Any]] = None
                ) -> Dict[str, np.ndarray]:
    """ofq_tpu DeiT param tree -> reference state_dict (FP or quantized,
    plain or distilled, QKR or fused-qkv — detected from the tree).
    `batch_stats` (a --replace-ln-by-bn run's running statistics) emits
    the reference BatchNorm buffers per swapped site."""
    bs = batch_stats or {}
    out: Dict[str, np.ndarray] = {}
    for tok in ("cls_token", "dist_token", "pos_embed"):
        if tok in params:
            out[tok] = _np(params[tok])
    _patch_embed(params["patch_embed"], "patch_embed.proj", out,
                 _patch_embed_signed(quant_stats))
    depth = sum(1 for k in params if k.startswith("blocks_"))
    for i in range(depth):
        blk = params[f"blocks_{i}"]
        blk_bs = bs.get(f"blocks_{i}", {})
        _norm(blk["norm1"], f"blocks.{i}.norm1", out,
              stats=blk_bs.get("norm1"))
        _norm(blk["norm2"], f"blocks.{i}.norm2", out,
              stats=blk_bs.get("norm2"))
        _attention(blk["attn"], f"blocks.{i}.attn", out)
        _qlinear(blk["mlp"]["fc1"], f"blocks.{i}.mlp.fc1", out)
        _qlinear(blk["mlp"]["fc2"], f"blocks.{i}.mlp.fc2", out)
        _mlp_act(blk["mlp"], f"blocks.{i}.mlp", out)
    _norm(params["norm"], "norm", out, stats=bs.get("norm"))
    for head in ("head", "head_dist"):
        if head in params:
            _qlinear(params[head], head, out)
    return out


def export_swin(params: Mapping[str, Any], *,
                depths=(2, 2, 6, 2),
                quant_stats: Optional[Mapping[str, Any]] = None,
                batch_stats: Optional[Mapping[str, Any]] = None
                ) -> Dict[str, np.ndarray]:
    """ofq_tpu Swin param tree -> reference state_dict.  Static geometry
    buffers (relative_position_index, shift masks) are rebuilt by the
    reference at construction and are not emitted — load with
    strict=False (the reference's own resume behavior, train.py:515)."""
    bs = batch_stats or {}
    out: Dict[str, np.ndarray] = {}
    _patch_embed(params["patch_embed"], "features.0.0", out,
                 _patch_embed_signed(quant_stats))
    _norm(params["patch_norm"], "features.0.2", out,
          stats=bs.get("patch_norm"))
    feat_idx = 1
    for stage, depth in enumerate(depths):
        for blk_i in range(depth):
            blk = params[f"features_{feat_idx}_{blk_i}"]
            prefix = f"features.{feat_idx}.{blk_i}"
            blk_bs = bs.get(f"features_{feat_idx}_{blk_i}", {})
            _norm(blk["norm1"], f"{prefix}.norm1", out,
                  stats=blk_bs.get("norm1"))
            _norm(blk["norm2"], f"{prefix}.norm2", out,
                  stats=blk_bs.get("norm2"))
            _attention(blk["attn"], f"{prefix}.attn", out)
            out[f"{prefix}.attn.relative_position_bias_table"] = _np(
                blk["attn"]["relative_position_bias_table"])
            mlp = blk["mlp"]
            if _is_quantized_linear(mlp["fc1"]):
                _qlinear(mlp["fc1"], f"{prefix}.mlp.fc1", out)
                _qlinear(mlp["fc2"], f"{prefix}.mlp.fc2", out)
                _mlp_act(mlp, f"{prefix}.mlp", out)
            else:  # float torchvision MLP Sequential indices
                _linear(mlp["fc1"], f"{prefix}.mlp.0", out)
                _linear(mlp["fc2"], f"{prefix}.mlp.3", out)
        feat_idx += 1
        if stage < len(depths) - 1:
            merge = params[f"features_{feat_idx}"]
            _norm(merge["norm"], f"features.{feat_idx}.norm", out,
                  stats=bs.get(f"features_{feat_idx}", {}).get("norm"))
            _qlinear(merge["reduction"], f"features.{feat_idx}.reduction",
                     out)
            feat_idx += 1
    _norm(params["norm"], "norm", out, stats=bs.get("norm"))
    _qlinear(params["head"], "head", out)
    return out


def export_state_dict(params: Mapping[str, Any], *, model_type: str,
                      depths=(2, 2, 6, 2),
                      quant_stats: Optional[Mapping[str, Any]] = None,
                      batch_stats: Optional[Mapping[str, Any]] = None
                      ) -> Dict[str, np.ndarray]:
    if model_type == "swin":
        return export_swin(params, depths=depths, quant_stats=quant_stats,
                           batch_stats=batch_stats)
    return export_deit(params, quant_stats=quant_stats,
                       batch_stats=batch_stats)


def save_pth_tar(state_dict: Mapping[str, np.ndarray], path: str, *,
                 arch: str = "", epoch: int = 0) -> str:
    """Write the CheckpointSaver-layout `.pth.tar` the reference's
    `--resume` path consumes (torch CPU tensors under 'state_dict')."""
    import torch

    torch.save({
        "state_dict": {k: torch.from_numpy(np.array(v, copy=True))
                       for k, v in state_dict.items()},
        "arch": arch,
        "epoch": epoch,
    }, path)
    return path


def swin_depths_from_params(params: Mapping[str, Any]) -> tuple:
    """Derive per-stage block counts from features_<f>_<b> keys (stage
    feature indices 1,3,5,7; PatchMerging nodes are features_<f>)."""
    stage_blocks: Dict[int, int] = {}
    for k in params:
        parts = k.split("_")
        if k.startswith("features_") and len(parts) == 3:
            f_i, b_i = int(parts[1]), int(parts[2])
            stage_blocks[f_i] = max(stage_blocks.get(f_i, 0), b_i + 1)
    return tuple(stage_blocks[f] for f in sorted(stage_blocks))


def export_experiment_torch(exp_dir: str, out_path: str, *,
                            use_best: bool = True, device="cuda") -> str:
    """Load a trained experiment directory (args.yaml + the port's
    checkpoints; the EMA weights when it trained with `--model-ema`) and
    write an original-layout `.pth.tar`.  Runs on CUDA unless
    `device="cpu"`."""
    import os

    import yaml

    from ..serve import Predictor
    from .flax import model_variables

    p = Predictor.from_experiment(exp_dir, batch_size=1, use_best=use_best,
                                  device=device)
    variables = model_variables(p.model)
    with open(os.path.join(exp_dir, "args.yaml")) as f:
        saved = yaml.safe_load(f)
    model_type = saved.get("model_type", "deit")
    params = variables["params"]
    depths = (swin_depths_from_params(params) if model_type == "swin"
              else (2, 2, 6, 2))
    sd = export_state_dict(params, model_type=model_type, depths=depths,
                           quant_stats=variables.get("quant_stats"),
                           batch_stats=variables.get("batch_stats"))
    # stamp the RESTORED checkpoint's epoch (best-k retention can pick a
    # mid-run epoch), not the configured total
    return save_pth_tar(sd, out_path, arch=saved.get("model", ""),
                        epoch=p.epoch or 0)


def main(argv=None, device="cuda"):
    import argparse

    ap = argparse.ArgumentParser(
        description="Export a trained ofq_tpu_torch experiment as an "
                    "original-layout torch .pth.tar")
    ap.add_argument("exp_dir", help="experiment directory (args.yaml + "
                    "checkpoints)")
    ap.add_argument("out", help="output .pth.tar path")
    ap.add_argument("--latest", action="store_true",
                    help="export the latest checkpoint instead of best")
    a = ap.parse_args(argv)
    path = export_experiment_torch(a.exp_dir, a.out,
                                   use_best=not a.latest, device=device)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
