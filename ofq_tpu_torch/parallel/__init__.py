"""Data-parallel training over torch.distributed (port of
`ofq_tpu/parallel/`): the 'data' axis of the JAX package's mesh, one
process per card, the global-batch reductions in `collectives`."""

from . import collectives
from .mesh import Mesh, make_mesh, param_spec, shard_params
from .multihost import backend_for, host_batch_slice, initialize_multihost

__all__ = [
    "Mesh", "backend_for", "collectives", "host_batch_slice",
    "initialize_multihost", "make_mesh", "param_spec", "shard_params",
]
