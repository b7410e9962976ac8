"""CGA, confidence-guided annealing (port of `ofq_tpu/train/cga.py`): the
finetune's freeze, mask and restore around the optimizer step.

  1. freeze masks from the pre-update weights (`outer_freeze_mask`),
  2. the selected kernels' gradients zeroed where frozen (`mask_grads`),
  3. after the update, the frozen entries' old values put back
     (`restore_frozen`), which also undoes AdamW's weight decay on them.

AdamW's moments still decay for frozen entries (their gradient is zero),
and the masks are recomputed every step from the live weights.  Selection
works on the port's parameter names, the Flax tree paths with '.' for '/'
(`blocks_3.attn.v_kernel`, `blocks_3.mlp.fc1.kernel`).  Masks are exact
fp32 0/1, so both selects are `where`s that keep the tensor's dtype.
Under tensor parallelism (`layout`, the state's `parallel.Layout`) each
selected kernel is this rank's slice: its mask is the single process's
mask of the whole kernel, cut (the level range over the model group, the
group's scale for a row-parallel kernel).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from ..quant.statsq import outer_freeze_mask


def is_cga_kernel(name: str, *, qk_reparam: bool,
                  model_type: str = "deit") -> bool:
    """Whether CGA freezes the parameter `name`.  QKR freezes `v_kernel`
    and the kernels of fc1, fc2 and proj (never q_kernel or k_kernel);
    without QKR, fc1, fc2, qkv and proj.  Swin adds `reduction` and drops
    the test that DeiT's selection lies inside `blocks_*`."""
    names = name.split(".")
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if model_type != "swin" and not any(n.startswith("blocks_")
                                        for n in names):
        return False
    if leaf == "v_kernel" and qk_reparam:
        return True
    if leaf != "kernel":
        return False
    if qk_reparam:
        allowed = ("fc1", "fc2", "proj") + (
            ("reduction",) if model_type == "swin" else ())
        return parent in allowed
    return parent in ("fc1", "fc2", "qkv", "proj")


def freeze_masks(params: Mapping[str, torch.Tensor], *, bits: int,
                 boundary_range: float, qk_reparam: bool,
                 model_type: str = "deit", layout=None
                 ) -> dict[str, Optional[torch.Tensor]]:
    """name -> fp32 freeze mask (1 = frozen) for the CGA-selected
    parameters, None elsewhere."""
    def mask(n, w):
        cut = None if layout is None else layout.cuts.get(n)
        if cut is None:
            return outer_freeze_mask(w, bits, boundary_range)
        return outer_freeze_mask(w, bits, boundary_range, mesh=layout.mesh,
                                 row_parallel=cut.row_parallel)

    return {n: (mask(n, w) if is_cga_kernel(n, qk_reparam=qk_reparam,
                                            model_type=model_type) else None)
            for n, w in params.items()}


def mask_grads(grads: Mapping[str, torch.Tensor],
               masks: Mapping[str, Optional[torch.Tensor]]
               ) -> dict[str, torch.Tensor]:
    """`where(mask, 0, g)` on the selected parameters, in g's dtype."""
    return {n: g if masks.get(n) is None else g.masked_fill(masks[n] > 0.5, 0)
            for n, g in grads.items()}


def restore_frozen(old_params: Mapping[str, torch.Tensor],
                   new_params: Mapping[str, torch.Tensor],
                   masks: Mapping[str, Optional[torch.Tensor]]
                   ) -> dict[str, torch.Tensor]:
    """`where(mask, old, new)` on the selected parameters, in their
    dtype."""
    return {n: new if masks.get(n) is None
            else torch.where(masks[n] > 0.5, old_params[n], new)
            for n, new in new_params.items()}
