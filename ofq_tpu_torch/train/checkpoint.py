"""Epoch checkpoints with CheckpointSaver-style retention (port of
`ofq_tpu/train/checkpoint.py:43-82`).

The original's semantics (timm CheckpointSaver, train.py:791-808, and the
auto-resume at :698-706): a checkpoint every epoch, the best
`max_to_keep` kept by the eval metric (max mode; among equal metrics the
later one ranks higher, and a checkpoint saved without metrics is always
kept), auto-resume from the newest, `restore_best` for warm starts and
evaluation.  The retention is orbax's `BestN` policy, which the JAX
package's manager uses.

A checkpoint is one `torch.save` file, `<dir>/<step>/checkpoint.pt`
(its metrics also in `metrics.json` beside it, read for the retention),
holding host copies of the whole port `TrainState`: the parameters (bf16
masters in their dtype), the AdamW state (count and moments; the clipping
transforms hold none), step, epoch, the EMA, `extra["oscillation"]`, the
metrics, and the model's buffers (a BatchNorm's running statistics, the
image quantizer's `signed`: JAX's non-param collections).  The save is
synchronous, where JAX's orbax save is asynchronous: the host copy is
taken before `save_epoch` returns, so the next step may update the state
in place.  It is written to a temporary name and renamed, so an
interrupted save never leaves a half checkpoint; a leftover temporary
file is ignored.  The JAX package's `abstract_like` has no counterpart:
a restore copies into the live state's tensors, whose names, shapes and
devices are the target (`restore_into`), and the file carries its own
structure.

In a data-parallel run rank 0 alone writes (and applies the retention),
and every rank waits at a barrier after the save, so that a restore that
follows reads a complete directory; every rank restores.  Under tensor
parallelism (`state.tp`) the sliced parameters (bf16 masters as bf16),
their moments, EMA and oscillation states are gathered over the model
group first (every rank takes part), so the file
holds the full tensors under their names, as one process writes them; a
restore into a sharded state cuts them to the rank's slices.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Optional

import torch

from ..parallel.collectives import barrier, is_writer
from .state import TrainState

_FILE = "checkpoint.pt"
_METRICS = "metrics.json"
_TMP = ".tmp"


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    max_to_keep: int = 10
    metric_name: str = "top1"

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), _FILE)

    def all_steps(self) -> list[int]:
        """The steps with a complete checkpoint, ascending."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if re.fullmatch(r"\d+", d)
                      and os.path.isfile(self._path(int(d))))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> Optional[dict]:
        with open(os.path.join(self.directory, str(step), _METRICS)) as f:
            return json.load(f)

    def _ranked(self) -> list[int]:
        """The steps with metrics, worst first; equal metrics keep their
        order, so the later ranks higher (orbax's stable sort)."""
        with_m = [(s, m) for s in self.all_steps()
                  if (m := self.metrics(s)) is not None]
        with_m.sort(key=lambda sm: sm[1].get(self.metric_name,
                                             float("-inf")))
        return [s for s, _ in with_m]

    def best_step(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[-1] if ranked else None

    def delete(self, step: int) -> None:
        shutil.rmtree(os.path.join(self.directory, str(step)),
                      ignore_errors=True)

    def _retain(self) -> None:
        """Orbax's `BestN`: beyond `max_to_keep`, drop every checkpoint
        with metrics outside the best `max_to_keep`."""
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return
        keep = set(self._ranked()[-self.max_to_keep:]) if \
            self.max_to_keep else set()
        for s in steps:
            if s not in keep and self.metrics(s) is not None:
                self.delete(s)


def make_manager(directory: str, *, max_to_keep: int = 10,
                 metric_name: str = "top1") -> CheckpointManager:
    os.makedirs(directory, exist_ok=True)
    return CheckpointManager(os.path.abspath(directory), max_to_keep,
                             metric_name)


def _host(t):
    """A host copy of a tensor (or a tree of them)."""
    if torch.is_tensor(t):
        return t.detach().to("cpu", copy=True)
    if isinstance(t, dict):
        return {k: _host(v) for k, v in t.items()}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return {f: _host(v) for f, v in t._asdict().items()}
    return t


def state_payload(state: TrainState, buffers=None,
                  metrics: Optional[dict] = None) -> dict:
    """The host copy of `state` (and `buffers`, by name) that a checkpoint
    holds; a sharded state's full tensors (a collective over the model
    group: every rank of it must call this)."""
    osc = (state.extra or {}).get("oscillation")
    full = (lambda t: t) if state.tp is None else state.tp.gather
    if osc is not None and state.tp is not None:
        osc = state.tp.gather_states(osc)
    return {
        "params": _host(full(state.params)),
        "opt_state": {"count": int(state.opt_state.count),
                      "mu": _host(full(state.opt_state.mu)),
                      "nu": _host(full(state.opt_state.nu))},
        "step": int(state.step), "epoch": int(state.epoch),
        "ema_params": (None if state.ema_params is None
                       else _host(full(state.ema_params))),
        "oscillation": None if osc is None else _host(osc),
        "buffers": _host(dict(buffers or {})),
        "metrics": None if metrics is None else {
            k: float(v) for k, v in metrics.items()},
    }


def save(mgr: CheckpointManager, step: int, payload: dict) -> None:
    """Write `payload` as checkpoint `step`: to a temporary name, renamed
    when complete; then apply the retention.  Rank 0 writes; every rank
    then waits at a barrier."""
    if is_writer():
        _write(mgr, step, payload)
    barrier()


def _write(mgr: CheckpointManager, step: int, payload: dict) -> None:
    d = os.path.join(mgr.directory, str(step))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, _METRICS), "w") as f:
        json.dump(payload["metrics"], f)
    tmp = os.path.join(d, _FILE + _TMP)
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(d, _FILE))
    mgr._retain()


def save_epoch(mgr: CheckpointManager, epoch: int, state: TrainState,
               metrics: Optional[dict] = None, *, buffers=None) -> None:
    """Checkpoint `state` (and the model's `buffers`) as step `epoch`,
    ranked by `metrics`; a save without metrics records {} (every metric
    -inf), as the JAX package's does.  Only rank 0 copies the state to the
    host (every rank gathers a sharded state's slices)."""
    payload = (state_payload(state, buffers, metrics or {})
               if is_writer() or state.tp is not None else None)
    save(mgr, epoch, payload)


def load(mgr: CheckpointManager, step: int) -> dict:
    """Checkpoint `step`'s payload, tensors on the CPU."""
    return torch.load(mgr._path(step), map_location="cpu",
                      weights_only=True)


def _copy_named(what: str, dst: dict, src: dict) -> None:
    """Copy `src` into the tensors of `dst` by name, strictly: the same
    names, shapes and dtypes."""
    if set(dst) != set(src):
        missing = sorted(set(dst) - set(src))[:5]
        unused = sorted(set(src) - set(dst))[:5]
        raise ValueError(f"checkpoint {what} do not match: missing "
                         f"{missing}, unused {unused}")
    with torch.no_grad():
        for n, t in dst.items():
            s = src[n]
            if s.shape != t.shape or s.dtype != t.dtype:
                raise ValueError(f"checkpoint {what} {n}: {tuple(s.shape)} "
                                 f"{s.dtype} != {tuple(t.shape)} {t.dtype}")
            t.copy_(s)


def restore_into(payload: dict, state: TrainState,
                 model: Optional[torch.nn.Module] = None) -> TrainState:
    """Copy a checkpoint into the live `state` (the masters' tensors, in
    place; the model's working parameters too under bf16 masters) and,
    with `model`, its buffers; the moments, EMA and oscillation states
    are moved to the masters' device.  Strict: the checkpoint must have
    the state's structure.  A sharded state (`state.tp`) takes its slices
    of the checkpoint's full tensors."""
    cut = (lambda tree: tree) if state.tp is None else state.tp.cut_all
    _copy_named("params", state.params, cut(payload["params"]))
    dev = next(iter(state.params.values())).device
    to = (lambda tree: None if tree is None else
          {k: v.to(dev) for k, v in cut(tree).items()})
    opt = payload["opt_state"]
    for key in ("mu", "nu"):
        if set(opt[key]) != set(state.params):
            raise ValueError(f"checkpoint opt_state.{key} does not match "
                             "the parameters")
    state.opt_state = dataclasses.replace(
        state.opt_state, count=int(opt["count"]), mu=to(opt["mu"]),
        nu=to(opt["nu"]))
    state.step, state.epoch = int(payload["step"]), int(payload["epoch"])
    if (payload["ema_params"] is None) != (state.ema_params is None):
        raise ValueError("checkpoint and state disagree on the EMA")
    state.ema_params = to(payload["ema_params"])
    osc = payload["oscillation"]
    have = (state.extra or {}).get("oscillation")
    if (osc is None) != (have is None):
        raise ValueError("checkpoint and state disagree on the oscillation "
                         "states")
    if osc is not None:
        if set(osc) != set(have):
            raise ValueError("checkpoint oscillation states do not match")
        states = {n: type(have[n])(**{f: v.to(dev) for f, v in
                                      fields.items()})
                  for n, fields in osc.items()}
        if state.tp is not None:
            states = state.tp.cut_states(states)
        state.extra = {**state.extra, "oscillation": states}
    if model is not None:
        work = dict(model.named_parameters())
        masters = state.params
        if any(work[n] is not masters[n] for n in masters):
            with torch.no_grad():
                for n, p in masters.items():
                    work[n].copy_(p)
        _copy_named("buffers", dict(model.named_buffers()),
                    payload["buffers"])
    return state


def restore_latest(mgr: CheckpointManager, state: TrainState,
                   model: Optional[torch.nn.Module] = None
                   ) -> tuple[Any, int]:
    """Restore the newest checkpoint into `state` (see `restore_into`);
    returns (state, next_epoch), or (None, 0) when there is none."""
    step = mgr.latest_step()
    if step is None:
        return None, 0
    return restore_into(load(mgr, step), state, model), step + 1


def restore_best(mgr: CheckpointManager) -> Optional[dict]:
    """The best checkpoint's payload by the manager's metric (max mode),
    or None."""
    step = mgr.best_step()
    return None if step is None else load(mgr, step)
