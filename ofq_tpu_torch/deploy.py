"""Deployment export: packed integer weights (port of `ofq_tpu/deploy.py`).

A QAT checkpoint stores fp32 master weights; a W2A2 model uses 2-bit codes
times per-channel scales.  `export_packed` freezes that into a compact
artifact, a flat dict for `np.savez`, in the JAX package's format:

  * StatsQ kernels (qkv, proj, fc1, fc2, reduction, QKR's v) -> mid-rise
    codes k = round(clip(w/s, -1, 1-1e-6) * n - 0.5) in [-n, n-1],
    n = 2^(b-1), packed b bits each, and the per-output-channel scale
    s = 2 mean|w|.  The decode s * ((k + 0.5) / n) gives the training-time
    fake-quant values.
  * QKR q/k kernels -> the quantized per-head product W_qk, stored as codes
    under `w_qk_frozen`; the q/k kernels are dropped.
  * LSQ-weight layers (the W8 heads, and every block kernel of a full-LSQ
    `--wq-mode lsq` model at the weight bits, unsigned with `--wq_asym`)
    -> codes with their learned scale (idempotent under re-quantization).
  * everything else passes through in fp32.

The encode runs the port's own ops (`statsq_b4_round`, the W_qk einsum of
`nn/attention.py`) on the tensors' own device, so an artifact's codes are
the port's live codes there (the JAX package runs them through XLA for the
same reason: numpy's divide and reductions move boundary weights onto
another level).  The decode is numpy: it divides only by the power of two
n and multiplies by s.

`restore_packed` inverts it into a param tree for a policy with
`weight_frozen=True` (weight fake-quant skipped: StatsQ is not idempotent),
and with `int_core=True` also writes the artifact's scales as the sibling
params `kernel_scale` / `v_kernel_scale` / `w_qk_scale` for
`frozen_int_bits` serving; a full-LSQ kernel's learned `weight_quant.s`
passes through and gives its codes there (`ops/int8_qlinear.py:
frozen_lsq_weight_int`).
"""

from __future__ import annotations

import json
from typing import Mapping, Optional

import numpy as np
import torch

from .quant.statsq import statsq_b4_round

_STATSQ_PARENTS = ("qkv", "proj", "fc1", "fc2", "reduction")


def pack_codes(codes: np.ndarray, bits: int) -> np.ndarray:
    """Pack unsigned codes (< 2^bits) into a dense uint8 bitstream, exactly
    `bits` bits per code."""
    assert 1 <= bits <= 8
    flat = codes.astype(np.uint8).ravel()
    b = np.unpackbits(flat[:, None], axis=1)[:, 8 - bits:]
    return np.packbits(b.ravel())


def unpack_codes(packed: np.ndarray, bits: int, size: int) -> np.ndarray:
    b = np.unpackbits(np.asarray(packed, np.uint8))[:size * bits]
    b = b.reshape(size, bits)
    out = np.zeros(size, np.uint8)
    for i in range(bits):
        out |= b[:, i].astype(np.uint8) << (bits - 1 - i)
    return out


def _f32(w) -> torch.Tensor:
    """A leaf as an fp32 tensor on its own device (numpy: the CPU)."""
    if torch.is_tensor(w):
        return w.detach().to(torch.float32)
    return torch.from_numpy(np.array(w, np.float32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _statsq_encode(w, bits: int, reduce_axis: int):
    """Codes k + n (uint8) and the scale (keepdims), from the op sequence of
    the port's live StatsQ."""
    b4, s = statsq_b4_round(_f32(w), bits, reduce_axis=reduce_axis)
    n = float(2 ** (bits - 1))
    return (_np(torch.round(b4)) + n).astype(np.uint8), _np(s).astype(
        np.float32)


def _statsq_decode(codes: np.ndarray, s: np.ndarray, bits: int) -> np.ndarray:
    n = float(2 ** (bits - 1))
    k = codes.astype(np.float32) - n
    return (s * ((k + 0.5) / n)).astype(np.float32)


def _lsq_encode(w, s, bits: int, axis: int, all_positive: bool = False):
    """LSQ weight codes with the learned scale (kept as its own param), the
    ops of the port's `lsq_quantize`; a size-1 scale is per tensor."""
    w32 = _f32(w)
    s32 = _f32(s).to(w32.device)
    if s32.numel() == 1:
        sb = torch.clamp_min(s32.reshape(()), 1e-5)
    else:
        shape = [1] * w32.ndim
        shape[axis] = s32.shape[0]
        sb = torch.clamp_min(s32.reshape(shape), 1e-5)
    thd_neg, thd_pos = ((0, 2 ** bits - 1) if all_positive
                        else (-(2 ** (bits - 1)), 2 ** (bits - 1) - 1))
    k = torch.round(torch.clamp(w32 / sb, thd_neg, thd_pos))
    return (_np(k) - thd_neg).astype(np.uint8), _np(sb).astype(np.float32)


def _lsq_decode(codes, sb, bits, all_positive: bool = False):
    thd_neg = 0 if all_positive else -(2 ** (bits - 1))
    return (sb * (codes.astype(np.float32) + thd_neg)).astype(np.float32)


def _walk(tree, prefix=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    else:
        yield prefix, tree


def _set(tree, path, value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def model_tree(model: torch.nn.Module) -> dict:
    """A port model's parameters and buffers as a nested dict keyed by the
    Flax tree path (the port's names split at '.'), detached, on the
    model's device: what `export_packed` takes."""
    tree: dict = {}
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        _set(tree, tuple(name.split(".")), t.detach())
    return tree


def export_packed(params: Mapping, *, weight_bits: int, qk_reparam: bool,
                  num_heads: Optional[int] = None, head_dim: int = 64,
                  wq_mode: str = "statsq", wq_asym: bool = False) -> dict:
    """Pack a trained param tree (nested dict of numpy arrays or tensors:
    the JAX 'params' collection, or `model_tree(model)`) into integer codes,
    scales and fp32 passthroughs; a flat dict of numpy arrays that
    `restore_packed` inverts.  QKR's H is `num_heads`, else C // head_dim
    (DeiT: 64; Swin: 32, whose C varies by stage)."""
    if not 2 <= weight_bits <= 8:
        # at 1 bit, w = -s rounds to code -2 (round half to even on -1.5),
        # below [-n, n-1], and the uint8 cast would wrap
        raise ValueError(f"packed export supports 2..8 weight bits, got "
                         f"{weight_bits}")
    out = {}
    meta = {"weight_bits": weight_bits, "qk_reparam": qk_reparam,
            "wq_mode": wq_mode, "wq_asym": wq_asym, "entries": {}}
    flat = list(_walk(params))
    names = {p: v for p, v in flat}
    for path, w in flat:
        key = "/".join(path)
        leaf, parent = path[-1], (path[-2] if len(path) > 1 else "")
        if qk_reparam and leaf in ("q_kernel", "k_kernel"):
            if leaf == "k_kernel":
                continue  # handled with q_kernel
            q = _f32(w)
            k = _f32(names[path[:-1] + ("k_kernel",)]).to(q.device)
            C = q.shape[0]
            H = num_heads if num_heads else max(C // head_dim, 1)
            d = C // H
            # the live path's product (`nn/attention.py:_w_qk`)
            w_qk = torch.einsum("ihd,jhd->hij", q.reshape(C, H, d),
                                k.reshape(C, H, d)).reshape(H * C, C)
            codes, s = _statsq_encode(w_qk, weight_bits, reduce_axis=-1)
            base = "/".join(path[:-1]) + "/w_qk_frozen"
            out[base + ".codes"] = pack_codes(codes, weight_bits)
            out[base + ".scale"] = s
            meta["entries"][base] = {
                "kind": "statsq", "bits": weight_bits,
                "shape": [H, C, C], "enc_shape": [H * C, C]}
            continue
        if leaf == "v_kernel" and qk_reparam:
            codes, s = _statsq_encode(w, weight_bits, reduce_axis=0)
        elif (leaf == "kernel" and parent in _STATSQ_PARENTS
                and _lsq_weight_scale(names, path) is not None):
            # a full-LSQ block kernel: its learned scale, the weight bits
            if wq_mode != "lsq":
                raise ValueError(
                    f"param tree has an LSQ weight scale under {key} but "
                    f"wq_mode={wq_mode!r}; pass wq_mode='lsq' (and wq_asym "
                    "for --wq_asym runs)")
            codes, sb = _lsq_encode(w, _lsq_weight_scale(names, path),
                                    weight_bits, axis=-1,
                                    all_positive=wq_asym)
            out[key + ".codes"] = pack_codes(codes, weight_bits)
            out[key + ".scale"] = sb
            meta["entries"][key] = {
                "kind": "lsq", "bits": weight_bits, "all_positive": wq_asym,
                "shape": list(w.shape), "enc_shape": list(w.shape)}
            continue
        elif (leaf == "kernel" and parent in _STATSQ_PARENTS
                and _in_quantized_module(names, path)):
            # StatsQ'd QLinear kernels; float Dense kernels pass through
            codes, s = _statsq_encode(w, weight_bits, reduce_axis=0)
        elif leaf == "kernel" and _lsq_weight_scale(names, path) is not None:
            codes, sb = _lsq_encode(w, _lsq_weight_scale(names, path), 8,
                                    axis=-1)
            out[key + ".codes"] = pack_codes(codes, 8)
            meta["entries"][key] = {
                "kind": "lsq", "bits": 8, "shape": list(w.shape),
                "enc_shape": list(w.shape), "scale_shape": list(sb.shape)}
            out[key + ".scale"] = sb
            continue
        else:
            out[key] = _np(w) if torch.is_tensor(w) else np.asarray(w)
            continue
        out[key + ".codes"] = pack_codes(codes, weight_bits)
        out[key + ".scale"] = s
        meta["entries"][key] = {
            "kind": "statsq", "bits": weight_bits, "shape": list(w.shape),
            "enc_shape": list(w.shape)}
    out["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                    dtype=np.uint8)
    return out


def _in_quantized_module(names, path) -> bool:
    """A QLinear kernel has sibling quantizer params (input_quant/s) in its
    module; a float Dense kernel does not."""
    mod = path[:-1]
    return any(p[:len(mod)] == mod and "input_quant" in p for p in names)


def _lsq_weight_scale(names, path):
    return names.get(path[:-1] + ("weight_quant", "s"))


def restore_packed(exported: Mapping, *, int_core: bool = False) -> dict:
    """Invert `export_packed`: a nested param tree of numpy arrays with
    dequantized kernels and `w_qk_frozen` entries, for a
    `QuantPolicy(weight_frozen=True)` model; `int_core=True` also writes the
    artifact's StatsQ scales (`<kernel>_scale`, `w_qk_scale`) for
    `frozen_int_bits` serving."""
    meta = json.loads(bytes(np.asarray(exported["__meta__"])).decode())
    tree: dict = {}
    done = set()
    for key, info in meta["entries"].items():
        bits = info["bits"]
        enc_shape = info["enc_shape"]
        size = int(np.prod(enc_shape))
        codes = unpack_codes(np.asarray(exported[key + ".codes"]), bits,
                             size).reshape(enc_shape)
        s = np.asarray(exported[key + ".scale"])
        path = tuple(key.split("/"))
        if info["kind"] == "statsq":
            w = _statsq_decode(codes, s, bits).reshape(info["shape"])
            if int_core:
                scale_leaf = ("w_qk_scale" if path[-1] == "w_qk_frozen"
                              else path[-1] + "_scale")
                _set(tree, path[:-1] + (scale_leaf,),
                     np.asarray(s, np.float32))
        else:
            w = _lsq_decode(codes, s, bits,
                            all_positive=info.get("all_positive", False)
                            ).reshape(info["shape"])
        _set(tree, path, np.asarray(w, np.float32))
        done.update((key + ".codes", key + ".scale"))
    for key, v in exported.items():
        if key in done or key == "__meta__" or key.endswith((".codes",
                                                             ".scale")):
            continue
        _set(tree, tuple(key.split("/")), np.asarray(v))
    return tree


def drop_block_lsq_scales(tree: dict) -> dict:
    """A restored tree without the full-LSQ block kernels' `weight_quant`
    scales: the fp frozen model holds none (its `LsqWeight` at 32 bits is
    the identity on the restored levels, as JAX's), only the integer core
    reads them."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            v = drop_block_lsq_scales(v)
            if k in _STATSQ_PARENTS and "kernel" in v:
                v.pop("weight_quant", None)
        out[k] = v
    return out


def artifact_meta(exported: Mapping) -> dict:
    return json.loads(bytes(np.asarray(exported["__meta__"])).decode())


def artifact_nbytes(exported: Mapping) -> int:
    return sum(np.asarray(v).nbytes for v in exported.values())
