"""Data-dependent LSQ scale initialisation (the port's counterpart of the
JAX package's `model.init` on a calibration batch, and of
`cli/runner.py:recalibrate_missing_scales`).

One forward through the composed path: every LSQ quantizer, in call order,
sets its scale by `init_scale` from the input it sees and then quantizes
with it, so later quantizers see the already-quantized activations -- the
sequential order of Flax's data-dependent init.  The image quantizer's
`signed` state is set from the batch.  The fused kernels are bypassed for
this forward, so the softmax scale is fitted on the composition.  A
BatchNorm normalizes with its running statistics and updates nothing,
whatever mode the model is in (JAX's `model.init(..., train=False)`; a
fresh model's are mean 0, var 1).
"""

from __future__ import annotations

import numpy as np
import torch


def calibrate(model: torch.nn.Module, images) -> torch.nn.Module:
    """Set every LSQ scale of `model` from `images` ((B, H, W, 3) NHWC,
    numpy or tensor) in one forward on the model's device."""
    flagged = [m for m in model.modules() if hasattr(m, "calibrating")]
    p = next(model.parameters())
    x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images)
                        else images).to(device=p.device, dtype=p.dtype)
    try:
        for m in flagged:
            m.calibrating = True
        with torch.no_grad():
            model(x)
    finally:
        for m in flagged:
            m.calibrating = False
    return model
