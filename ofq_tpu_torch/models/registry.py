"""Model registry (port of `ofq_tpu/models/registry.py:21-32`): the DeiT
and Swin names."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..quant.policy import QuantPolicy
from . import deit, swin
from .deit import init_weights


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller asks for
    the CPU; a missing CUDA device raises instead of falling back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ofq_tpu_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return device


def create_model(name: str, *, policy: QuantPolicy, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 head_std: Optional[float] = None,
                 **overrides) -> nn.Module:
    """Build a model by reference name on `device` (default "cuda").

    Weights are random with the JAX initializers, drawn from `generator`
    (a fresh generator seeded with 0 when None); load trained weights with
    `convert.load_flax_params` and set the LSQ scales with
    `calibrate.calibrate` or from the checkpoint.  `overrides` replace
    `DeiTConfig` or `SwinConfig` fields (e.g. `matmul_impl="pallas",
    compute_dtype="bfloat16"`).
    """
    dev = resolve_device(device)
    if name in deit.VARIANTS:
        model = deit.deit_model(name, policy, **overrides)
    elif name in swin.VARIANTS:
        model = swin.swin_model(name, policy, **overrides)
    else:
        raise KeyError(f"unknown model {name!r}; known: "
                       f"{sorted(deit.VARIANTS) + sorted(swin.VARIANTS)}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator, head_std=head_std)
    return model.to(dev).eval()
