"""Checkpoint conversion (port of `ofq_tpu/convert/`).

  * `flax`: JAX variables (Flax tree paths) into a port model, and the
    JAX train state's optimizer, EMA and oscillation states into the
    port's `TrainState`;
  * `torch_import`: the original repository's `.pth.tar` state dicts
    into nested numpy trees keyed by the Flax paths, which
    `load_flax_params` takes with no transposes;
  * `torch_export`: the inverse, a port model's trees into the original
    repository's layout.
"""

from .flax import (COLLECTIONS, buffer_collection, flatten_flax_tree,
                   load_ema_params, model_variables, nest,
                   load_flax_params, load_optax_adamw_state,
                   load_oscillation_states)
from .torch_export import (export_deit, export_experiment_torch,
                           export_state_dict, export_swin, save_pth_tar,
                           swin_depths_from_params)
from .torch_import import (convert_bn_stats, convert_deit, convert_swin,
                           load_torch_state_dict, merge_pretrained,
                           resize_pos_embed, split_qkv_for_qkr)

__all__ = [
    "COLLECTIONS", "buffer_collection", "convert_bn_stats", "convert_deit", "convert_swin",
    "export_deit", "export_experiment_torch", "export_state_dict",
    "export_swin", "flatten_flax_tree", "load_ema_params", "load_flax_params",
    "load_optax_adamw_state", "load_oscillation_states",
    "load_torch_state_dict", "merge_pretrained", "model_variables", "nest", "resize_pos_embed",
    "save_pth_tar", "split_qkv_for_qkr", "swin_depths_from_params",
]
