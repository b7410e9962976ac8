"""Inference serving (port of `ofq_tpu/serve.py:27-100`).

    from ofq_tpu_torch.serve import Predictor
    p = Predictor.from_flax_npz("w2a2_deit_s.npz",
                                model_name="deit_small_distilled_patch16_224",
                                policy=w2a2_qkr_policy(12))
    probs = p.predict(images_nhwc)          # (B, 1000) softmax

A batch shorter than `batch_size` is padded to it and the result trimmed,
so every call runs the same shapes.  Runs on CUDA unless `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch

from .convert import load_flax_params
from .models.registry import create_model, resolve_device
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
                      batch_size: int = 64, device="cuda") -> "Predictor":
        """A predictor for JAX variables saved as a flat `.npz` keyed by
        '/'-joined Flax paths (see `convert.load_flax_params`).  The bf16
        stream of bench.py's pallas configuration:
        `matmul_impl="pallas", attn_impl=None, compute_dtype="bfloat16"`;
        of its fused one: the defaults with `compute_dtype="bfloat16"`."""
        model = create_model(model_name, policy=policy, device=device,
                             matmul_impl=matmul_impl, attn_impl=attn_impl,
                             compute_dtype=compute_dtype)
        load_flax_params(model, npz_path)
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
