"""Data and tensor parallelism over torch.distributed (port of
`ofq_tpu/parallel/`): the (data x model) mesh, one process per card, the
global-batch reductions of the 'data' axis in `collectives` and the
Megatron sharding of the 'model' axis in `tensor`."""

from . import collectives
from .mesh import Mesh, make_mesh, param_spec, shard_params
from .multihost import backend_for, host_batch_slice, initialize_multihost
from .tensor import Layout, copy_to_model, reduce_from_model, shard_model

__all__ = [
    "Layout", "Mesh", "backend_for", "collectives", "copy_to_model",
    "host_batch_slice", "initialize_multihost", "make_mesh", "param_spec",
    "reduce_from_model", "shard_model", "shard_params",
]
