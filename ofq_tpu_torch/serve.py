"""Inference serving (port of `ofq_tpu/serve.py:27-100`).

    from ofq_tpu_torch.serve import Predictor
    p = Predictor.from_flax_npz("w2a2_deit_s.npz",
                                model_name="deit_small_distilled_patch16_224",
                                policy=w2a2_qkr_policy(12))
    probs = p.predict(images_nhwc)          # (B, 1000) softmax

A frozen packed artifact (`deploy.export_packed`, saved with `np.savez`)
serves through the integer core:

    exported = dict(np.load("w2a2_deit_s_packed.npz"))
    p = Predictor.from_packed(exported,
                              model_name="deit_small_distilled_patch16_224",
                              policy=w2a2_qkr_policy(12), int_core=True,
                              compute_dtype="bfloat16")

A full-LSQ artifact (`--wq-mode lsq`, a policy whose `lsq_weights` holds)
serves the same way, its integer codes rebuilt from the learned weight
scales.  A batch shorter than `batch_size` is padded to it and the result trimmed,
so every call runs the same shapes.  Runs on CUDA unless `device="cpu"`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .convert import load_flax_params
from .deploy import artifact_meta, drop_block_lsq_scales, restore_packed
from .models.registry import create_model, resolve_device
from .ops.int8_qlinear import int8_eligible, lsq_int8_eligible
from .quant.policy import QuantPolicy


class Predictor:
    def __init__(self, model: torch.nn.Module, *, batch_size: int,
                 img_size: int, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.img_size = img_size

    @classmethod
    def from_flax_npz(cls, npz_path: str, *, model_name: str,
                      policy: QuantPolicy, matmul_impl: str = "fused",
                      attn_impl: str | None = "fused", compute_dtype=None,
                      batch_size: int = 64, device="cuda",
                      **overrides) -> "Predictor":
        """A predictor for JAX variables saved as a flat `.npz` keyed by
        '/'-joined Flax paths (see `convert.load_flax_params`; a BN
        student's running statistics, `batch_stats`, serve in eval mode).
        The bf16 stream of bench.py's pallas configuration:
        `matmul_impl="pallas", attn_impl=None, compute_dtype="bfloat16"`;
        of its fused one: the defaults with `compute_dtype="bfloat16"`.
        `overrides` replace further config fields (e.g.
        `norm_layer="batchnorm"`)."""
        model = create_model(model_name, policy=policy, device=device,
                             matmul_impl=matmul_impl, attn_impl=attn_impl,
                             compute_dtype=compute_dtype, **overrides)
        load_flax_params(model, npz_path)
        return cls(model, batch_size=batch_size,
                   img_size=model.cfg.img_size, device=device)

    @classmethod
    def from_packed(cls, exported, *, model_name: str, policy: QuantPolicy,
                    int_core: bool = True, compute_dtype=None,
                    batch_size: int = 64, device="cuda") -> "Predictor":
        """A predictor for a packed artifact (a dict of arrays, or the path
        of its `.npz`) of the W2A2 student trained under `policy`.  The
        model is built frozen (`weight_frozen=True`, and with `int_core`
        `frozen_int_bits` = the artifact's weight bits: its products run on
        the codes rebuilt from the stored scales), in `bench.py`'s
        configuration (composed attention tail; `compute_dtype` as given)
        and loaded strictly, the image quantizer's state with it (an
        artifact of `deploy.model_tree`; the JAX package's exports hold the
        params collection alone: restore those with `restore_packed` and
        load them with their `quant_stats`)."""
        if isinstance(exported, (str, bytes)) or hasattr(exported,
                                                         "__fspath__"):
            with np.load(exported) as npz:
                exported = dict(npz)
        meta = artifact_meta(exported)
        bits = meta["weight_bits"]
        lsq = policy.lsq_weights
        asym = not policy.weight.symmetric
        if bool(meta["qk_reparam"]) != policy.qk_reparam or \
                meta["wq_mode"] != ("lsq" if lsq else "statsq") or \
                bool(meta.get("wq_asym", False)) != asym or \
                bits != policy.weight.bit:
            raise ValueError(
                f"artifact (W{bits}, qk_reparam={meta['qk_reparam']}, "
                f"wq_mode={meta['wq_mode']!r}, wq_asym="
                f"{meta.get('wq_asym', False)}) does not match the policy "
                f"(W{policy.weight.bit}, qk_reparam={policy.qk_reparam}, "
                f"full-LSQ {lsq}, wq_asym={asym})")
        if int_core and lsq and (policy.qk_reparam or not lsq_int8_eligible(
                bits, policy.act.bit, True, asym)):
            raise ValueError(f"int_core serves full-LSQ artifacts without "
                             f"QKR at W2..W{7 if asym else 8} / A<=7, got "
                             f"W{bits}A{policy.act.bit}, qk_reparam="
                             f"{policy.qk_reparam}")
        if int_core and not lsq and not int8_eligible(bits, policy.act.bit,
                                                      True):
            # outside these widths the layers would serve the fp frozen
            # path under an int-core name
            raise ValueError(f"int_core serves W2..W4 / A<=7 artifacts, got "
                             f"W{bits}A{policy.act.bit}")
        frozen = dataclasses.replace(
            policy, weight_frozen=True,
            frozen_int_bits=bits if int_core else None)
        model = create_model(model_name, policy=frozen, device=device,
                             compute_dtype=compute_dtype)
        tree = restore_packed(exported, int_core=int_core)
        if lsq and not int_core:
            tree = drop_block_lsq_scales(tree)
        load_flax_params(model, tree)
        return cls(model, batch_size=batch_size,
                   img_size=model.cfg.img_size, device=device)

    def predict(self, images: np.ndarray) -> np.ndarray:
        """images: (B, H, W, 3) float32 NHWC, already normalized, with
        B <= batch_size.  Returns (B, classes) softmax probabilities."""
        n = images.shape[0]
        if n > self.batch_size:
            raise ValueError(f"batch of {n} > batch_size {self.batch_size}")
        pad = self.batch_size - n
        x = np.pad(np.asarray(images, np.float32),
                   ((0, pad), (0, 0), (0, 0), (0, 0)))
        with torch.inference_mode():
            xt = torch.from_numpy(x).to(self.device)
            probs = torch.softmax(self.model(xt), dim=-1)
            return probs[:n].cpu().numpy()
