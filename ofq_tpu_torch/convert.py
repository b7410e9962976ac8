"""Carry weights across from the JAX package.

The port's parameter and buffer names are the Flax tree paths with '.' for
'/' (`blocks_3/attn/quan_qkx/s` -> `blocks_3.attn.quan_qkx.s`) and its
kernels keep Flax's `(in, out)` layout, so loading is a flatten-and-copy
with no transposes.  The loader is strict both ways: a key the model lacks,
a model entry the tree lacks, or a shape mismatch raises.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

# Flax variable collections the port holds: parameters and the image
# quantizer's sticky `signed` state.
COLLECTIONS = ("params", "quant_stats")


def flatten_flax_tree(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict of arrays -> {'a/b/c': ndarray}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_flax_tree(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _port_entries(flat: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """'/'-joined Flax paths, with or without a leading collection name,
    -> port state-dict names."""
    out = {}
    for path, v in flat.items():
        head, _, rest = path.partition("/")
        if head in COLLECTIONS and rest:
            path = rest
        name = path.replace("/", ".")
        if name in out:
            raise ValueError(f"{path}: given twice (in two collections)")
        out[name] = v
    return out


def load_flax_params(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Fill every parameter and buffer of `model` from JAX variables.

    `tree` is a nested dict of numpy arrays -- the Flax variables
    ({'params': ..., 'quant_stats': ...}) or the params tree alone -- or a
    flat mapping such as a loaded `.npz`, keyed by '/'-joined Flax paths
    (with or without the collection name).  Values are copied into the
    model's own dtype and device.
    """
    if isinstance(tree, (str, bytes)) or hasattr(tree, "__fspath__"):
        with np.load(tree) as npz:
            tree = dict(npz)
    flat = flatten_flax_tree(tree)
    given = _port_entries(flat)
    targets = dict(model.named_parameters())
    targets.update(dict(model.named_buffers()))
    missing = sorted(set(targets) - set(given))
    unused = sorted(set(given) - set(targets))
    bad_shape = sorted(
        f"{k}: checkpoint {tuple(given[k].shape)} != model "
        f"{tuple(targets[k].shape)}"
        for k in set(given) & set(targets)
        if tuple(given[k].shape) != tuple(targets[k].shape))
    if missing or unused or bad_shape:
        raise ValueError(
            "load_flax_params: checkpoint does not match the model:\n"
            f"  missing ({len(missing)}): {missing[:10]}\n"
            f"  unused ({len(unused)}): {unused[:10]}\n"
            f"  shape mismatches ({len(bad_shape)}): {bad_shape[:10]}")
    with torch.no_grad():
        for k, t in targets.items():
            t.copy_(torch.from_numpy(np.array(given[k])).to(t.dtype))
    return model
