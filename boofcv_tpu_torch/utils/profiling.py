"""Profiling and tracing helpers (port of ``boofcv_tpu/utils/profiling.py``).

Reference analog: boofcv-ip misc/ProfileOperation.java (stopwatch),
misc/MovingAverage.java.  ``StageTimer`` synchronises the CUDA devices of
the tensors it is given before it reads the clock, so device work under
asynchronous launches is charged to the stage that launched it; ``trace``
records a ``torch.profiler`` trace and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


class MovingAverage:
    """Exponential moving average (misc/MovingAverage.java)."""

    def __init__(self, decay: float = 0.95):
        self.decay = decay
        self.average = 0.0
        self._first = True

    def update(self, value: float) -> float:
        if self._first:
            self.average = float(value)
            self._first = False
        else:
            self.average = (self.decay * self.average
                            + (1.0 - self.decay) * float(value))
        return self.average


def _sync(tensors) -> None:
    """Wait for the CUDA devices holding any of ``tensors`` (tensors, or
    tuples, lists and dicts of them); CPU tensors need no wait."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tensors)
    for d in devices:
        torch.cuda.synchronize(d)


class StageTimer:
    """Named per-stage wall-clock accumulator.  Use as
    ``with timer.stage("klt", *tensors): ...``: on leaving, the stage waits
    for the devices of the tensors in ``sync`` (which may be filled inside
    the block) before it reads the clock."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, *sync):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        """Mean milliseconds per stage."""
        return {k: 1e3 * self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace (the CPU, and CUDA where there is
    a card) of the block and write it to ``log_dir/trace.json`` (Chrome
    trace format: Perfetto or chrome://tracing).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
