"""The (data x model) mesh (port of `ofq_tpu/parallel/mesh.py`).

The JAX package runs one jitted program over a `Mesh` with a 'data' axis
(the batch sharded; GSPMD inserts the gradient all-reduce, what DDP's
NCCL all-reduce did in the original) and a 'model' axis (Megatron tensor
parallelism, laid out by `param_spec`).  The port runs one process per
card: its `Mesh` is this process's place in JAX's device grid,
`np.arange(world).reshape(world // model_parallel, model_parallel)`: rank
r sits at data index r // model_parallel and model index
r % model_parallel, so the consecutive ranks {d * mp, ..., d * mp + mp -
1} form one model group and the ranks of one model index across the
data indices one data group.  The reductions over the global batch run
over the data group (`collectives.py`); those of the 'model' axis, inside
the model's autograd graph, over the model group (`tensor.py`).

`shard_params` replicates the state over the data group (its first
rank's state is broadcast to the others) and, at `model_parallel` > 1,
keeps this rank's slices of the model and the state first
(`tensor.shard_model`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from . import collectives
from .multihost import local_rank, process_count, process_index
from .tensor import shard_model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the mesh: `world` ranks in all, this one
    `rank` (`local_rank` on its host), running on `device`; `group` is
    its data group's process group and `model_group` its model group's
    (None: the default group, or no process group at all, in a run of one
    process; a `model_parallel` of 1 has no model group)."""
    world: int
    rank: int
    local_rank: int
    device: torch.device
    group: Any = None
    model_parallel: int = 1
    model_group: Any = None

    @property
    def data_world(self) -> int:
        """The ranks of the 'data' axis: the data group's size."""
        return self.world // self.model_parallel

    @property
    def data_index(self) -> int:
        """This rank's place on the 'data' axis (its rows of the batch)."""
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        """This rank's place on the 'model' axis (its heads and columns)."""
        return self.rank % self.model_parallel


def _groups(world: int, mp: int, rank: int) -> tuple:
    """(data group, model group) of `rank`: every rank creates every
    group, in the same order (`dist.new_group` is collective)."""
    data = model = None
    for m in range(mp):
        g = dist.new_group([d * mp + m for d in range(world // mp)])
        if rank % mp == m:
            data = g
    for d in range(world // mp):
        g = dist.new_group(list(range(d * mp, (d + 1) * mp)))
        if rank // mp == d:
            model = g
    return data, model


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, *,
              device="cuda") -> Mesh:
    """The mesh of this process over every process of the process group
    (one when there is none): `model_parallel` consecutive ranks per model
    group.  `n_devices`, when given, must be the world size;
    `model_parallel` must divide it (ValueError).  A CUDA `device` without
    an index becomes `cuda:LOCAL_RANK`."""
    world = process_count()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group "
                         f"holds {world} processes")
    mp = int(model_parallel)
    if mp < 1 or world % mp:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the world of {world} processes")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    rank = process_index()
    group = model_group = None
    if dist.is_initialized():
        group = dist.group.WORLD
        if mp > 1:
            group, model_group = _groups(world, mp, rank)
    return Mesh(world=world, rank=rank, local_rank=local_rank(), device=dev,
                group=group, model_parallel=mp, model_group=model_group)


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
    """Lay `state` out on the mesh: at `model_parallel` > 1 keep this
    rank's slices of `model` and of the state first (`tensor.shard_model`
    and `Layout.shard_state`: the state's parameters become the model's
    sliced ones, its moments are cut, `state.tp` holds the layout), then
    replicate over the data group: its first rank's parameters, optimizer
    state (moments and count), step, epoch, EMA and oscillation states,
    and `model`'s buffers (BatchNorm's running statistics, the image
    quantizer's sign) and working parameters, broadcast to the group's
    other ranks in place.  A single process keeps its state.  Returns
    `state`."""
    if mesh.model_parallel > 1:
        if model is None:
            raise ValueError("tensor parallelism shards the model: pass it")
        state = shard_model(model, mesh).shard_state(state, model)
    if not dist.is_initialized() or mesh.data_world == 1:
        return state
    counters = torch.tensor([state.opt_state.count, state.step, state.epoch],
                            dtype=torch.int64, device=mesh.device)
    # the data group's first rank: data index 0, this rank's model index
    collectives.broadcast_(_state_tensors(state, model) + [counters], mesh,
                           src=mesh.model_index)
    count, step, epoch = (int(v) for v in counters.tolist())
    state.opt_state = dataclasses.replace(state.opt_state, count=count)
    state.step, state.epoch = step, epoch
    return state
