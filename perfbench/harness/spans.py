"""Host spans around calls into the port, and its host syncs.

A span is data (``spans/<span>.json``): a list of targets, each a module
path and an attribute.  ``Spans.install`` wraps each target from the
benchmark's side; the port is not edited.  A wrapped call records its host
wall time (no synchronize), and while ``annotate`` is on it also opens a
``torch.profiler.record_function`` range named ``pb.<span>`` and hands its
arguments to the span's capture hooks (a roofline's inputs).  Only the
outermost call of a span is recorded.  A target that is gone is reported
and left out; the run goes on without it.

``count_syncs`` is a copy of ``chip_smoke._count_sync_warnings``: PyTorch's
sync debug mode warns at every synchronizing CUDA operation.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import sys
import time
import warnings


class Spans:
    def __init__(self, bench, names):
        self.bench = bench
        self.names = list(names)
        self.records = []            # (span, start_s, end_s), host clock
        self.captures = collections.defaultdict(list)
        self.hooks = {}              # span -> capture(args, kwargs) -> record
        self.annotate = False
        self.missing = []
        self._depth = collections.Counter()
        self._patched = []

    def install(self) -> None:
        for name in self.names:
            for target in self.bench.span(name)["targets"]:
                where = f"{target['module']}.{target['attr']}"
                try:
                    mod = importlib.import_module(target["module"])
                    fn = getattr(mod, target["attr"])
                except (ImportError, AttributeError) as e:
                    self.missing.append(name)
                    print(f"span {name}: target {where} not found ({e}); "
                          f"its metrics are left out", file=sys.stderr)
                    continue
                setattr(mod, target["attr"], self._wrap(name, fn))
                self._patched.append((mod, target["attr"], fn))

    def uninstall(self) -> None:
        for mod, attr, fn in reversed(self._patched):
            setattr(mod, attr, fn)
        self._patched = []

    def _wrap(self, name, fn):
        import torch

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if self._depth[name]:
                return fn(*args, **kwargs)
            self._depth[name] += 1
            ctx = (torch.profiler.record_function(f"pb.{name}")
                   if self.annotate else contextlib.nullcontext())
            if self.annotate and name in self.hooks:
                self.captures[name].append(self.hooks[name](args, kwargs))
            t0 = time.perf_counter()
            try:
                with ctx:
                    return fn(*args, **kwargs)
            finally:
                self.records.append((name, t0, time.perf_counter()))
                self._depth[name] -= 1

        return wrapped


@contextlib.contextmanager
def count_syncs(counter: list):
    """Count, into ``counter[0]``, the synchronizing CUDA operations inside
    the block."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counter[0] += sum("called a synchronizing CUDA operation" in str(w.message)
                      for w in caught)
