"""Train state (port of `ofq_tpu/train/state.py`): the parameters by name,
the AdamW state, the step and epoch counts, the EMA and `extra`, the
auxiliary state the step threads through (None, or {"oscillation": {name:
OscillationState}} for the oscillation hook, `oscillation_hook.py`).
A BatchNorm's running statistics are buffers of the model, not part of
the state: the step's train-mode forward updates them.

With fp32 (or fp64) masters, `params` holds the model's own parameter
tensors, not copies: a train step updates them in place (and the image
quantizer's `signed` buffer in the model), where JAX returns a new tree.
With bf16 masters (`master_dtype="bfloat16"`), `params` holds bf16 copies,
the masters, and the model keeps fp32 working parameters that every step
fills from them, an exact upcast (`loop.py`).

Under tensor parallelism `tp` is the model's `parallel.Layout`: the
masters (fp32 or bf16), moments, EMA and oscillation states of a sliced
parameter are this rank's slices (`parallel.shard_params` sets it, or
`create` on a sharded model; checkpoints gather and cut by it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .optim import AdamW, AdamWState


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]
    opt_state: AdamWState
    step: int = 0
    epoch: int = 0
    # fp32 accumulators by parameter name, or None without an EMA
    ema_params: Optional[dict[str, torch.Tensor]] = None
    # auxiliary state, e.g. {"oscillation": {name: OscillationState}}
    extra: Optional[dict[str, Any]] = None
    # the tensor-parallel layout of the parameters, or None
    tp: Optional[Any] = None

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: AdamW,
               ema: bool = False, master_dtype=None,
               extra: Optional[dict[str, Any]] = None) -> "TrainState":
        """The state at step 0.  The Adam moments live in at least fp32 and
        the EMA in fp32, whatever the masters' dtype.  `master_dtype=
        "bfloat16"` rounds the masters to bf16 and writes the rounded
        values back into the model's working parameters."""
        params = dict(model.named_parameters())
        if master_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"master_dtype={master_dtype!r}: None or "
                             "'float32' (the model's parameters), "
                             "'bfloat16'")
        tp = getattr(model, "tp_layout", None)
        if master_dtype == "bfloat16":
            with torch.no_grad():
                masters = {n: p.detach().to(torch.bfloat16)
                           for n, p in params.items()}
                for n, p in params.items():
                    p.copy_(masters[n])
            params = masters
        return cls(params=params, opt_state=optimizer.init(params), step=0,
                   ema_params=({n: p.detach().to(torch.float32, copy=True)
                                for n, p in params.items()} if ema else None),
                   extra=extra, tp=tp)
