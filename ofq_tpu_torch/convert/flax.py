"""Carry weights across from the JAX package (`convert.flax`).

The port's parameter and buffer names are the Flax tree paths with '.' for
'/' (`blocks_3/attn/quan_qkx/s` -> `blocks_3.attn.quan_qkx.s`) and its
kernels keep Flax's `(in, out)` layout, so loading is a flatten-and-copy
with no transposes.  The loader is strict both ways: a key the model lacks,
a model entry the tree lacks, or a shape mismatch raises.  An
`oscillation` state (a NamedTuple in JAX) is flattened by its fields.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

# Flax variable collections the port holds: parameters, the image
# quantizer's sticky `signed` state, `LsqWeightIterativeFreezing`'s
# oscillation state and a BatchNorm's running statistics (buffers `mean`,
# `var`).
COLLECTIONS = ("params", "quant_stats", "oscillation", "batch_stats")


def flatten_flax_tree(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict of arrays -> {'a/b/c': ndarray}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "_fields"):  # a NamedTuple state
            v = v._asdict()
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
    model's own dtype and device.  A float model (the teacher) loads its
    params tree the same way.
    """
    if isinstance(tree, (str, bytes)) or hasattr(tree, "__fspath__"):
        with np.load(tree) as npz:
            tree = dict(npz)
    given = _port_entries(flatten_flax_tree(tree))
    targets = dict(model.named_parameters())
    targets.update(dict(model.named_buffers()))
    _check_match("load_flax_params", given, targets)
    with torch.no_grad():
        for k, t in targets.items():
            t.copy_(torch.from_numpy(np.array(given[k])).to(t.dtype))
    return model


def buffer_collection(name: str) -> str:
    """The Flax collection of a port buffer: the image quantizer's
    `signed` -> quant_stats, a BatchNorm's `mean`/`var` -> batch_stats,
    every other (`LsqWeightIterativeFreezing`'s state) -> oscillation."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "signed":
        return "quant_stats"
    if leaf in ("mean", "var"):
        return "batch_stats"
    return "oscillation"


def nest(named: Mapping[str, torch.Tensor]) -> dict:
    """{port name: tensor} -> a nested dict keyed by the Flax path, of
    host numpy copies (floats as fp32)."""
    out: dict = {}
    for name, t in named.items():
        node = out
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        t = t.detach().cpu()
        node[leaf] = (t.float() if t.is_floating_point() else t).numpy()
    return out


def model_variables(model: torch.nn.Module) -> dict:
    """The inverse of `load_flax_params`: a port model's parameters and
    buffers as Flax variables, {collection: `nest`ed tree} (a collection
    the model lacks is absent)."""
    colls: dict = {"params": dict(model.named_parameters())}
    for n, t in model.named_buffers():
        colls.setdefault(buffer_collection(n), {})[n] = t
    return {c: nest(named) for c, named in colls.items()}


def _check_match(what: str, given: Mapping[str, np.ndarray],
                 targets: Mapping[str, torch.Tensor]) -> None:
    """Raise unless `given` has exactly the names of `targets`, in their
    shapes."""
    missing = sorted(set(targets) - set(given))
    unused = sorted(set(given) - set(targets))
    bad_shape = sorted(
        f"{k}: checkpoint {tuple(given[k].shape)} != model "
        f"{tuple(targets[k].shape)}"
        for k in set(given) & set(targets)
        if tuple(given[k].shape) != tuple(targets[k].shape))
    if missing or unused or bad_shape:
        raise ValueError(
            f"{what}: checkpoint does not match the model:\n"
            f"  missing ({len(missing)}): {missing[:10]}\n"
            f"  unused ({len(unused)}): {unused[:10]}\n"
            f"  shape mismatches ({len(bad_shape)}): {bad_shape[:10]}")


def load_optax_adamw_state(state, adam_state, *, step=None):
    """Carry optax's `ScaleByAdamState` (`count`, `mu`, `nu`; the moments
    are Flax param trees) into a `train.TrainState`, in place, so both
    frameworks can start from the same mid-run state.  `adam_state` is
    the optax state or a mapping with those keys; `step` sets
    `state.step` (the JAX TrainState's own counter).  Strict both ways,
    like `load_flax_params`.

    `ofq_tpu.train.make_optimizer` chains `optax.adamw` (whose state is
    `(ScaleByAdamState, masked, schedule)`) after the clipping transform
    when it clips, so the Adam state is `opt_state[0][0]` without
    clipping and `opt_state[1][0]` with it; the clipping transforms hold
    no state."""
    def get(key):
        return (adam_state[key] if isinstance(adam_state, Mapping)
                else getattr(adam_state, key))

    opt = state.opt_state
    for key in ("mu", "nu"):
        given = _port_entries(flatten_flax_tree(get(key)))
        targets = getattr(opt, key)
        _check_match(f"load_optax_adamw_state ({key})", given, targets)
        setattr(opt, key, {
            k: torch.from_numpy(np.array(given[k])).to(t.dtype).to(t.device)
            for k, t in targets.items()})
    opt.count = int(np.asarray(get("count")))
    if step is not None:
        state.step = int(np.asarray(step))
    return state


def load_ema_params(state, ema_tree):
    """Carry the JAX TrainState's `ema_params` (a Flax params tree) into
    `state.ema_params`, in place, by the model's parameter names, as fp32
    on the masters' device.  Strict both ways, like `load_flax_params`."""
    given = _port_entries(flatten_flax_tree(ema_tree))
    _check_match("load_ema_params", given, state.params)
    state.ema_params = {
        k: torch.from_numpy(np.array(given[k])).to(
            device=p.device, dtype=torch.float32)
        for k, p in state.params.items()}
    return state


def load_oscillation_states(state, extra):
    """Carry the JAX TrainState's `extra["oscillation"]` (the oscillation
    hook's {'/'-joined param path: OscillationState}) into
    `state.extra["oscillation"]`, in place, by the port's parameter names,
    each field in the dtype and on the device of the port's own.  The
    port's state must hold one already
    (`oscillation_hook.init_oscillation_states`); strict both ways, like
    `load_flax_params`: the same kernels, fields and shapes."""
    if state.extra is None or "oscillation" not in state.extra:
        raise ValueError("load_oscillation_states: the port's state has no "
                         "oscillation state; create it with "
                         "oscillation_hook.init_oscillation_states")
    targets = state.extra["oscillation"]
    given = _port_entries(flatten_flax_tree(extra["oscillation"]))
    _check_match("load_oscillation_states", given, {
        f"{n}.{f}": t for n, st in targets.items()
        for f, t in st._asdict().items()})
    state.extra = {**state.extra, "oscillation": {
        n: type(st)(**{f: torch.from_numpy(np.array(given[f"{n}.{f}"])).to(
            device=t.device, dtype=t.dtype) for f, t in st._asdict().items()})
        for n, st in targets.items()}}
    return state
