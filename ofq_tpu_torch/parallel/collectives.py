"""The collectives of data-parallel training: what GSPMD inserted into the
JAX package's jitted step because its batch axis was sharded, written out
over a `torch.distributed` process group.

  * `all_reduce_mean`: the gradient mean over the data group, the
    gradients flattened into one bucket per dtype and device (as DDP
    buckets them), reduced once each;
  * `all_reduce_sum` / `agree`: the metric and eval-count reductions, and
    one flag that every rank must act on alike (the SIGTERM decision);
  * `broadcast_`: rank 0's state onto every rank (`mesh.shard_params`);
  * `sum_over_ranks`: an all-reduce autograd sees through (its backward
    all-reduces the cotangent), for the batch statistics of BatchNorm;
  * `reduce_from_data` / `copy_to_data`: the data group's g and f (an
    all-reduce forward with the identity backward; the identity forward
    with an all-reduced cotangent), for the Gram losses' squared sums,
    whose norms span the global batch (`train/losses.py`);
  * `data_parallel(mesh)`: the step's context.  While it is open the
    modules whose arithmetic reads the batch see the global batch: the
    LSQ gradient scale takes `batch_shape(x.shape)` (through
    `quant.lsq.act_grad_scale_factor`), BatchNorm normalizes
    with the global batch's statistics, each dropout mask is drawn at the
    global shape and cut to this rank's rows, and the image quantizer's
    sticky sign is the global batch's;
  * `flip_partner`: the rows of the global batch's reverse that pair with
    this rank's rows (mixup and cutmix).

Each runs over the mesh's data group (`mesh.group`, of `mesh.data_world`
ranks; at `model_parallel` > 1 not the world: the ranks of one model
group hold one batch), except `agree`, over the whole world.  Only
`all_reduce`, `broadcast` and `barrier` are used: the collectives that
both NCCL and gloo run on CUDA tensors, so that two ranks can share one
card over gloo.  Every function takes the world of one process (no
process group) as the identity.
"""

from __future__ import annotations

import contextlib
from typing import Iterable

import torch
import torch.distributed as dist

# the mesh of the data-parallel step in flight, set only inside
# `data_parallel`: the modules that read the batch sit deep in the model
# (BatchNorm, dropout, the LSQ chains inside the kernels' autograd
# functions), below any argument the step could pass.  A module global, not
# a thread-local: CUDA backward functions run on autograd's device threads.
_ACTIVE = None


@contextlib.contextmanager
def data_parallel(mesh):
    """Open the step's context on `mesh` (None, or a data group of 1:
    nothing changes)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh if mesh is not None and mesh.data_world > 1 else None
    try:
        yield
    finally:
        _ACTIVE = prev


def active_mesh():
    """The mesh of the open data-parallel context, or None."""
    return _ACTIVE


def batch_shape(shape) -> tuple:
    """The global shape of a batch-major tensor of this rank's shape: the
    leading axis times the data group of the open context."""
    shape = tuple(shape)
    m = _ACTIVE
    if m is None:
        return shape
    return (shape[0] * m.data_world,) + shape[1:]


def _distributed(mesh) -> bool:
    """Whether `mesh`'s data group holds more than this process."""
    return (mesh is not None and dist.is_initialized()
            and mesh.data_world > 1)


def _buckets(tensors: list) -> dict:
    out: dict = {}
    for i, t in enumerate(tensors):
        out.setdefault((t.dtype, t.device), []).append(i)
    return out


def _bucketed(tensors: list, op) -> list:
    """Apply the in-place collective `op` to one flat buffer per (dtype,
    device) of `tensors`; returns the results, in order, as new tensors
    of the inputs' shapes."""
    out = list(tensors)
    for idx in _buckets(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        op(flat)
        for i, piece in zip(idx, torch.split(
                flat, [tensors[i].numel() for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


def all_reduce_mean(grads: dict, mesh) -> dict:
    """{name: gradient} averaged over the data group: summed in one
    all-reduce per dtype bucket, then divided by the group's size (every
    rank gets the same bits)."""
    if not _distributed(mesh):
        return grads
    names = list(grads)

    def op(flat):
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.data_world)

    return dict(zip(names, _bucketed([grads[n] for n in names], op)))


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """`t` summed over the data group (a new tensor; no gradient)."""
    if not _distributed(mesh):
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=mesh.group)
    return t


def all_reduce_max_(t: torch.Tensor, mesh) -> torch.Tensor:
    """`t`, in place, the elementwise maximum over the data group."""
    if _distributed(mesh):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t


def agree(flag: bool, mesh) -> bool:
    """True on every rank of the world when `flag` is True on any."""
    if mesh is None or not dist.is_initialized() or mesh.world == 1:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


def broadcast_(tensors: Iterable[torch.Tensor], mesh, src: int = 0) -> None:
    """Copy rank `src`'s values (a global rank of the data group) into
    `tensors` on every rank of the data group, in place."""
    # bool tensors travel as their bytes (gloo reduces no bool)
    tensors = [t.view(torch.uint8) if t.dtype == torch.bool else t
               for t in tensors if t is not None]
    if not _distributed(mesh) or not tensors:
        return
    with torch.no_grad():
        got = _bucketed(tensors, lambda flat: dist.broadcast(
            flat, src=src, group=mesh.group))
        for t, g in zip(tensors, got):
            t.copy_(g)


def barrier(mesh=None) -> None:
    """Wait for every rank (of `mesh`'s group; the default group when
    None); a no-op without a process group."""
    if dist.is_initialized():
        dist.barrier(group=None if mesh is None else mesh.group)


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the cotangent: each
    rank's loss reaches every rank's inputs through the sum, so the input
    gradient gathers every rank's term (SyncBatchNorm's rule; the
    gradient mean over the ranks then divides by the world)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over_ranks(t: torch.Tensor, mesh) -> torch.Tensor:
    """`t` summed over the data group, differentiably."""
    if not _distributed(mesh):
        return t
    return _SumOverRanks.apply(t, mesh.group)


class _ReduceFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.detach().to(torch.promote_types(t.dtype, torch.float32),
                            copy=True).contiguous()
        dist.all_reduce(out, group=group)
        return out.to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def reduce_from_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """`t` summed over the data group (in at least fp32); its cotangent
    passed on as it is, so that each rank's share of a global term's
    gradient reaches its own rows."""
    if not _distributed(mesh):
        return t
    return _ReduceFromData.apply(t, mesh.group)


def copy_to_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """`t` itself; its cotangent summed over the data group (a value every
    rank computed alike from global sums, read by each rank's rows)."""
    if not _distributed(mesh) or not t.requires_grad:
        return t
    return _CopyToData.apply(t, mesh.group)


def flip_partner(t: torch.Tensor, mesh) -> torch.Tensor:
    """The rows that the global batch's reverse puts in place of this
    rank's rows: global row i pairs with row B - 1 - i, so the rows of
    data index r come from data index W - 1 - r, reversed.  They are
    fetched by an all-reduce over the data group of a zero-filled buffer
    of the global batch into which each rank writes its own rows."""
    if not _distributed(mesh):
        return t.flip(0)
    W, r = mesh.data_world, mesh.data_index
    buf = torch.zeros((W,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    buf[r] = t
    dist.all_reduce(buf, group=mesh.group)
    return buf[W - 1 - r].flip(0)


def own_rows(draw, shape: tuple) -> torch.Tensor:
    """`draw(shape)` at the global shape of a batch-major `shape`, cut to
    this rank's rows (every rank draws the same global tensor from a
    generator seeded alike); `draw(shape)` itself outside a data-parallel
    context."""
    m = _ACTIVE
    if m is None:
        return draw(tuple(shape))
    n = shape[0]
    full = draw((n * m.data_world,) + tuple(shape[1:]))
    return full[m.data_index * n:(m.data_index + 1) * n]
