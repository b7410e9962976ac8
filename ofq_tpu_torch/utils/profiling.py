"""Profiling and tracing helpers (port of
`ofq_tpu/utils/profiling.py:24-70`).

  * `trace(logdir)` captures a `torch.profiler` trace of a region, with
    the CUDA activity when a card is present, and writes it to
    `<logdir>/trace.json` (Chrome trace format: chrome://tracing,
    Perfetto);
  * `StepTimer` gives per-step wall times with a true device barrier
    (`stop` synchronises the device, as JAX's blocks on a value);
  * `AverageMeter` mirrors the original repository's meter.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Trace:
    """A `torch.profiler` capture started by `start` and written to
    `<logdir>/trace.json` by `stop`."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path = os.path.join(logdir, "trace.json")
        self._prof = torch.profiler.profile(activities=_activities())

    def start(self) -> "Trace":
        os.makedirs(self.logdir, exist_ok=True)
        self._prof.__enter__()
        return self

    def stop(self) -> str:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(self.path)
        return self.path


@contextlib.contextmanager
def trace(logdir: str):
    t = Trace(logdir).start()
    try:
        yield t
    finally:
        t.stop()


class AverageMeter:
    """Running average (reference: timm AverageMeter used at train.py:872)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class StepTimer:
    """Wall-clock step timer with a true device barrier."""

    def __init__(self):
        self._t0: Optional[float] = None
        self.meter = AverageMeter()

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, barrier_value=None) -> float:
        """Seconds since `start`; with `barrier_value` (a tensor), after
        the device has finished the work queued so far."""
        if barrier_value is not None and torch.is_tensor(barrier_value) \
                and barrier_value.is_cuda:
            torch.cuda.synchronize(barrier_value.device)
        dt = time.perf_counter() - self._t0
        self.meter.update(dt)
        return dt
