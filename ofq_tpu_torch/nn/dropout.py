"""Dropout and drop-path with masks drawn from an explicit generator (port of
Flax's `nn.Dropout` and `ofq_tpu/models/deit.py:_drop_path`), and the
rematerialized block that replays them.

Every mask of the port comes from one function, `bernoulli`, in the order
the forward asks for them: the counterpart of `jax.random.bernoulli`
(uniform < p), drawn from the `torch.Generator` the caller hands to the
model's forward.  There is no default stream: a site with a rate above 0
in train mode raises without a generator, and a generator on another
device than the tensor raises.  Under tensor parallelism a mask over a
tensor sharded over the mesh's model group (the attention probabilities'
heads, the MLP's hidden columns: `shard=(axis, mesh)`) is drawn at the
global shape and cut to this rank's slice; a mask over a replicated
tensor is drawn alike on every model rank, from generators seeded alike.
The arithmetic is JAX's: the kept values
are divided by `keep` rounded to the tensor's dtype (a weakly typed
constant in JAX), so a bf16 stream divides by bf16(keep).

`checkpointed` runs a block under `torch.utils.checkpoint`, which saves
and restores the default CPU and CUDA generators only: the block's
function puts the caller's generator back to its state at the block's
start before the recompute and returns it where it was afterwards, so
the recompute draws the forward's masks (JAX's remat replays its keys).
While the recompute runs, every submodule of the block that has a
`recomputing` flag (a BatchNorm) has it set: it normalizes with the batch
statistics as before but leaves its running statistics alone, so they
are updated once per forward, as under JAX's `nn.remat`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import own_rows
from ..quant.ste import weak_scalar


def bernoulli(shape: tuple[int, ...], keep: float,
              generator: torch.Generator, shard=None) -> torch.Tensor:
    """A boolean mask of `shape`, True with probability `keep`, drawn from
    `generator` on its device.  In a data-parallel step `shape` is this
    rank's rows of a batch-major tensor: the mask is drawn at the global
    batch's shape (JAX draws one mask over the global shape from one key)
    and this rank keeps its own rows.  `shard=(axis, mesh)`: `shape` is
    this rank's slice along `axis` of a tensor sharded over the model
    group; the mask is drawn at the axis's global length and cut."""
    def draw(full):
        return torch.rand(full, generator=generator,
                          device=generator.device)

    if shard is not None:
        axis, mesh = shard
        axis %= len(shape)
        n, parts = shape[axis], mesh.model_parallel
        whole = draw

        def draw(full):
            full = tuple(full)
            t = whole(full[:axis] + (n * parts,) + full[axis + 1:])
            return t.narrow(axis, mesh.model_index * n, n)

    return own_rows(draw, shape) < keep


def check_generator(x: torch.Tensor, generator: Optional[torch.Generator],
                    what: str) -> None:
    """Raise unless `generator` is a generator on `x`'s device."""
    if generator is None:
        raise ValueError(
            f"{what} draws a mask in train mode and needs a torch.Generator "
            f"on {x.device} (the model's `generator` argument)")
    g = generator.device
    if g.type != x.device.type or (
            g.index is not None and x.device.index is not None
            and g.index != x.device.index):
        raise ValueError(f"{what}: the generator lives on {g}, the tensor on "
                         f"{x.device}; a CUDA tensor needs a CUDA generator")


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], *,
            train: bool, shard=None) -> torch.Tensor:
    """Flax's `nn.Dropout(rate)`: in train mode `where(mask, x / keep, 0)`
    with one mask entry per element, zeros at rate 1; the identity in eval
    mode or at rate 0 (nothing drawn).  `shard` as in `bernoulli`."""
    if not train or rate == 0.0:
        return x
    check_generator(x, generator, f"dropout (rate {rate})")
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = (bernoulli(tuple(x.shape), keep, generator) if shard is None
            else bernoulli(tuple(x.shape), keep, generator, shard=shard))
    return torch.where(mask, x / weak_scalar(keep, x.dtype),
                       torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator], *,
              train: bool) -> torch.Tensor:
    """Stochastic depth on a residual branch (`_drop_path`): one mask entry
    per sample, of shape (B, 1, ..., 1), `where(mask, x / keep, 0)`."""
    if not train or rate == 0.0:
        return x
    check_generator(x, generator, f"drop-path (rate {rate})")
    keep = 1.0 - rate
    mask = bernoulli((x.shape[0],) + (1,) * (x.ndim - 1), keep, generator)
    return torch.where(mask, x / weak_scalar(keep, x.dtype), 0.0)


def checkpointed(fn: Callable, x: torch.Tensor,
                 generator: Optional[torch.Generator],
                 owner: Optional[nn.Module] = None) -> torch.Tensor:
    """`fn(x, generator)` with its activations recomputed in the backward
    (`torch.utils.checkpoint`, non-reentrant), the recompute drawing the
    same masks from `generator` as the forward did, with the `recomputing`
    flag of every submodule of `owner` that has one set while it runs."""
    start = None if generator is None else generator.get_state()
    calls = []

    def recompute(x):
        if start is None:
            return fn(x, None)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return fn(x, generator)
        finally:
            generator.set_state(now)

    def run(x):
        if not calls:
            calls.append(True)
            return fn(x, generator)
        flagged = ([] if owner is None else
                   [m for m in owner.modules() if hasattr(m, "recomputing")])
        for m in flagged:
            m.recomputing = True
        try:
            return recompute(x)
        finally:
            for m in flagged:
                m.recomputing = False

    return checkpoint(run, x, use_reentrant=False)
