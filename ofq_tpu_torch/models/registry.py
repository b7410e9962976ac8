"""Model registry (port of `ofq_tpu/models/registry.py`): the DeiT and
Swin names, and constructors registered under names of their own
(`register_model`), which `create_model` consults first."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..quant.policy import QuantPolicy
from . import deit, swin
from .deit import init_weights


# name -> constructor(policy=..., **overrides) -> nn.Module
_REGISTRY: Dict[str, Callable[..., nn.Module]] = {}

# the reference names `list_models` always lists (JAX's static list)
_STATIC = ("deit_tiny_distilled_patch16_224",
           "deit_small_distilled_patch16_224", "deit_tiny_patch16_224",
           "deit_small_patch16_224", "deit_base_distilled_patch16_224",
           "swin_t")


def register_model(name: str):
    """A decorator: `fn(policy=..., **overrides)`, returning a model with
    uninitialised parameters, becomes what `create_model(name, ...)`
    builds (the registry is consulted before the DeiT and Swin
    tables)."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def list_models() -> list[str]:
    """The reference model names and the registered ones, sorted."""
    return sorted(set(_STATIC) | set(_REGISTRY))


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
    if name in _REGISTRY:
        model = _REGISTRY[name](policy=policy, **overrides)
    elif name in deit.VARIANTS:
        model = deit.deit_model(name, policy, **overrides)
    elif name in swin.VARIANTS:
        model = swin.swin_model(name, policy, **overrides)
    else:
        raise KeyError(f"unknown model {name!r}; known: "
                       f"{sorted(deit.VARIANTS) + sorted(swin.VARIANTS)}"
                       f" and the registered {sorted(_REGISTRY)}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator, head_std=head_std)
    return model.to(dev).eval()
