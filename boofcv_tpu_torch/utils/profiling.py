"""Profiling and tracing helpers (port of ``boofcv_tpu/utils/profiling.py``).

Reference analog: boofcv-ip misc/ProfileOperation.java (stopwatch),
misc/MovingAverage.java.  ``StageTimer`` synchronises the CUDA devices of
the tensors it is given before it reads the clock, so device work under
asynchronous launches is charged to the stage that launched it; ``trace``
records a ``torch.profiler`` trace and writes it as a Chrome trace.

**Spans: the port's flight recorder.**  ``with span(name): ...`` records
one host-clock interval of the block.  Recording is on by default, so the
last stretch of a running program can always be read back: a span costs
about 2 us of host time with no profiler running (no synchronize, no
device work), against steps of milliseconds.  ``set_recording(False)``
turns it off, leaving one flag check a span.

Each span is one record, a plain tuple, written when the span closes::

    (name, id, parent_id, step_id, t0_ns, t1_ns)

``id`` is unique in the process; ``parent_id`` is the innermost span open
on the same thread when this one opened (None for a root); ``step_id`` is
the id of the outermost open span (its own id for a root), so every span of
one frame, or of one batched step, shares it; ``t0_ns`` / ``t1_ns`` are
``time.perf_counter_ns()`` on entry and exit.  A span measures the host's
time to launch its work, or, where it encloses a sync, the host's wait for
the device.  ``records()`` returns the newest ``RING`` records, oldest
first (by close, so children precede their parent); ``dropped()`` counts
those the bound pushed out.

While a ``torch.profiler`` is running (``trace`` below, or any other), each
span also opens ``torch.profiler.record_function(name)``: in Perfetto or
chrome://tracing its range sits on the CPU thread as a ``user_annotation``
over the operators it ran, and the kernels those launched are tied to it by
their launch's flow arrows.

The port's spans (one frame of ``sfm/stereo_vo.py``; the library spans
also fire on the other paths that call those functions):

- ``vo.frame`` (root): ``StereoVisualOdometry.process``: upload, step or
  bootstrap, readback.
- ``vo.batch`` (root): one call of a batched bootstrap, step or sequence
  runner.
- ``vo.upload``: ``process``'s two frames to float32 and onto the device.
- ``vo.bootstrap``, ``vo.step``: the first-frame initializer and the
  per-frame step; their self time is the step's glue.
- ``pyramid``, ``gradient``: ``ip/pyramid_ops.pyramid_average``,
  ``.gradient``.
- ``klt``: ``feature/klt.track_pyramid``.
- ``ransac``: ``geo/robust.ransac_pnp``, with ``ransac.bank`` (on the
  card: the launch of ``kernels/pnp_bank``) and ``refine``
  (``geo/pnp.gauss_newton_pose``) inside it.
- ``vo.spawn_wait``: the step's spawn decision, where the host waits for
  tracking, RANSAC and the refine to finish on the device.
- ``spawn``: ``sfm/stereo_vo._spawn`` (detection, the near-live test,
  sparse stereo, the lift, the templates), with ``sad``
  (``feature/disparity.sparse_block_match``) inside it.
- ``vo.readback``: ``process``'s pose and metrics copied to the host,
  which waits for the step to end.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

# a minute of single-stream steps at 400 frames/s, ten spans a step
RING = 1 << 18

_recording = True
_ids = itertools.count(1)
_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=RING)
_written = 0
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Open(threading.local):
    """The ids of this thread's open spans, outermost first."""

    def __init__(self):
        self.stack: List[int] = []


_open = _Open()


class span:
    """Context manager recording one host-clock interval (see the module's
    docstring for the record)."""

    __slots__ = ("name", "_at", "_annotation")

    def __init__(self, name: str):
        self.name = name
        self._at = None

    def __enter__(self):
        if not _recording:
            return self
        stack = _open.stack
        sid = next(_ids)
        if stack:
            parent, step = stack[-1], stack[0]
        else:
            parent, step = None, sid
        self._annotation = None
        if _profiler_enabled():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self._at = (sid, parent, step, len(stack), time.perf_counter_ns())
        stack.append(sid)
        return self

    def __exit__(self, *exc):
        if self._at is None:
            return False
        t1 = time.perf_counter_ns()
        sid, parent, step, depth, t0 = self._at
        self._at = None
        # an inner span left open by an exception closes with this one
        del _open.stack[depth:]
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
        global _written
        with _lock:
            _ring.append((self.name, sid, parent, step, t0, t1))
            _written += 1
        return False


def set_recording(on: bool) -> bool:
    """Turn span recording on or off; returns the previous setting."""
    global _recording
    previous, _recording = _recording, bool(on)
    return previous


def records() -> List[Tuple[str, int, Optional[int], int, int, int]]:
    """The recorded spans, oldest first: ``(name, id, parent_id, step_id,
    t0_ns, t1_ns)`` each."""
    with _lock:
        return list(_ring)


def dropped() -> int:
    """Records pushed out of the ring by its bound since the process
    started."""
    with _lock:
        return _written - len(_ring)


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
    the block) before it reads the clock.  Each stage is also a ``span`` of
    its name, the wait included."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, *sync):
        with span(name):
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
    trace format: Perfetto or chrome://tracing).  Yields the profiler.
    The spans opened in the block show as ``user_annotation`` ranges."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
