"""The data-parallel mesh (port of `ofq_tpu/parallel/mesh.py`).

The JAX package runs one jitted program over a `Mesh` with a 'data' axis
(the batch sharded; GSPMD inserts the gradient all-reduce, what DDP's
NCCL all-reduce did in the original) and an optional 'model' axis
(Megatron tensor parallelism, laid out by `param_spec`).  The port runs
one process per card: its `Mesh` is this process's place in the data
group (world size, rank, local rank, device, process group), and the
reductions over the global batch are written out (`collectives.py`).

Only the 'data' axis is ported.  The 'model' axis needs every quantizer
shard-aware (the row-parallel StatsQ scale and the LSQ `ds` over sharded
activations all-reduced before the kernels see them): `make_mesh` refuses
`model_parallel > 1` (ROADMAP.md, Queue 1 item 7.2b).  `param_spec` is
kept, a pure function over the port's Flax-path parameter names, for that
slice.  `shard_params` under the 'data' axis replicates: rank 0's state
is broadcast to every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from . import collectives
from .multihost import local_rank, process_count, process_index

TP_SLICE = "ROADMAP.md, Queue 1 item 7.2b"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data group: `world` ranks, this one
    `rank` (`local_rank` on its host), running on `device`; `group` is
    the data group's process group (None: the default group, or no
    process group at all in a single-process run)."""
    world: int
    rank: int
    local_rank: int
    device: torch.device
    group: Any = None


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, *,
              device="cuda") -> Mesh:
    """The data-parallel mesh of this process: every process of the
    process group (one when there is none) on the 'data' axis.
    `n_devices`, when given, must be the world size.  A CUDA `device`
    without an index becomes `cuda:LOCAL_RANK`."""
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: the port shards the batch "
            f"only; tensor parallelism over a 'model' axis is the next "
            f"slice ({TP_SLICE})")
    world = process_count()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group "
                         f"holds {world} processes")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    return Mesh(world=world, rank=process_index(), local_rank=local_rank(),
                device=dev,
                group=dist.group.WORLD if dist.is_initialized() else None)


# Kernels sharded over the 'model' axis by name: column-parallel producers
# (out axis sharded) feed row-parallel consumers (in axis sharded), so each
# block needs one all-reduce (the Megatron layout).
def param_spec(name: str, shape) -> tuple:
    """The partition spec of parameter `name` (a Flax path joined by '.',
    as the port names its parameters) of `shape`: one entry per leading
    axis, "model" where that axis is sharded over the 'model' axis, None
    where it is not; () is replicated.  JAX's `param_spec` as a tuple."""
    names = name.split(".")
    spec: tuple = ()
    if len(names) >= 2:
        parent, leaf = names[-2], names[-1]
        if leaf == "kernel" and parent in ("qkv", "fc1"):
            spec = (None, "model")        # column parallel
        elif leaf == "kernel" and parent in ("proj", "fc2"):
            spec = ("model", None)        # row parallel
        elif leaf == "bias" and parent in ("qkv", "fc1"):
            spec = ("model",)
        elif leaf in ("q_kernel", "k_kernel", "v_kernel"):
            spec = (None, "model")
        elif leaf == "v_bias":
            spec = ("model",)
    if len(spec) > len(tuple(shape)):
        raise ValueError(f"{name}: spec {spec} for shape {tuple(shape)}")
    return spec


def _state_tensors(state, model=None) -> list:
    out = list(state.params.values())
    out += list(state.opt_state.mu.values()) + list(
        state.opt_state.nu.values())
    if state.ema_params is not None:
        out += list(state.ema_params.values())
    for st in ((state.extra or {}).get("oscillation") or {}).values():
        out += [t for t in st if torch.is_tensor(t)]
    if model is not None:
        masters = state.params
        out += [p.data for n, p in model.named_parameters()
                if p is not masters.get(n)]
        out += list(model.buffers())
    return out


def shard_params(state, mesh: Mesh, model: Optional[torch.nn.Module] = None):
    """Replicate `state` over the 'data' axis: rank 0's parameters,
    optimizer state (moments and count), step, epoch, EMA and oscillation
    states, and `model`'s buffers (BatchNorm's running statistics, the
    image quantizer's sign) and working parameters, broadcast to every
    rank in place.  A single process keeps its state.  Returns `state`."""
    if not dist.is_initialized():
        return state
    counters = torch.tensor([state.opt_state.count, state.step, state.epoch],
                            dtype=torch.int64, device=mesh.device)
    collectives.broadcast_(_state_tensors(state, model) + [counters], mesh)
    count, step, epoch = (int(v) for v in counters.tolist())
    state.opt_state = dataclasses.replace(state.opt_state, count=count)
    state.step, state.epoch = step, epoch
    return state
