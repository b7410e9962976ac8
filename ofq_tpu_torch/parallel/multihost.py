"""Multi-process bring-up (port of `ofq_tpu/parallel/multihost.py`).

The JAX package runs one SPMD program over every host: each host calls
`jax.distributed.initialize()`, loads its slice of the global batch and
assembles the slices into global arrays.  The port runs one process per
card, launched by torchrun (`torchrun --nproc_per_node N -m
ofq_tpu_torch.cli.train ...`), and joins them into one
`torch.distributed` process group here.

`local_to_global` (JAX's assembly of the host-local slices into one
globally sharded array) has no counterpart: each rank's batch stays on its
own card, and the reductions over the global batch that GSPMD inserted
under `jit` are written out instead (`collectives.py`: the gradient mean,
the batch statistics, the metrics and eval counts, the LSQ gradient
scale's global shape).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

_logger = logging.getLogger("ofq_tpu_torch")


def _launch_env_markers() -> list[str]:
    """The environment variables that declare a multi-process launch: a
    `WORLD_SIZE` above 1, or a rendezvous address (torchrun sets
    `MASTER_ADDR` for every launch, one process included)."""
    markers = []
    if int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        markers.append("WORLD_SIZE")
    if os.environ.get("MASTER_ADDR"):
        markers.append("MASTER_ADDR")
    return markers


def backend_for(device) -> str:
    """The process group's backend for the device the caller asked for:
    NCCL on CUDA, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_rank() -> int:
    """This process's card on its host (torchrun's `LOCAL_RANK`)."""
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None,
                         device="cuda") -> None:
    """Idempotent `torch.distributed` bring-up.

    The rank, world size and rendezvous come from torchrun's `RANK`,
    `WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT`, or from the explicit
    arguments (`coordinator_address` as "host:port").  A process with
    neither is a single-process run: a no-op.  The backend follows
    `device` (NCCL for CUDA, gloo for the CPU) unless `backend` names
    one; it never changes because the first one failed.  On CUDA the
    process's current card becomes `cuda:LOCAL_RANK`.

    A failed init on a declared multi-process launch (explicit
    multi-process arguments, a `WORLD_SIZE` above 1 or `MASTER_ADDR` in
    the environment) raises: carrying on would run N independent
    trainings that all believe they are rank 0 and write one checkpoint
    directory."""
    if dist.is_initialized():
        return
    explicit_multi = (num_processes not in (None, 1)
                      or coordinator_address is not None
                      or process_id not in (None, 0))
    env = _launch_env_markers()
    if not (explicit_multi or env):
        _logger.debug("multihost: single process, no process group")
        return
    backend = backend or backend_for(device)
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1") or 1))
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0") or 0))
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    try:
        if backend == "nccl":
            torch.cuda.set_device(local_rank())
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank)
    except Exception as e:
        raise RuntimeError(
            f"torch.distributed.init_process_group ({backend}) failed on "
            "what is declared a multi-process launch "
            f"({'explicit args' if explicit_multi else env}); refusing to "
            "continue as independent single-process trainings") from e
    _logger.info("multihost: rank %d/%d (%s), local rank %d", rank, world,
                 backend, local_rank())


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_batch_slice(global_batch: int, mesh=None) -> tuple[int, int]:
    """(per-rank batch, offset) of this rank's rows in the global batch:
    split over every process, or with `mesh` over its data group (the
    ranks of a model group take the same rows)."""
    n, i = ((process_count(), process_index()) if mesh is None
            else (mesh.data_world, mesh.data_index))
    assert global_batch % n == 0, (global_batch, n)
    per = global_batch // n
    return per, per * i
