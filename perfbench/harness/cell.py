"""One run of one cell: set-up, the measured window, the traced extras,
the check against the plain reference, and the result line.

What a cell's steps are, and how they are checked, comes from the kind
that its configuration names (``kinds/<kind>.py``).  A kind module has
``port()``, the port's modules that faults and controls patch, and
``Cell(bench, r, port, seed, device)``, built at set-up, with ``steps``
(a replay's), ``per_step`` (the operations a step hands over),
``strata`` (stratum -> steps held for the check, in order),
``reset(replay)``, ``step(j)`` -> ``out`` (``out["failed"]``: operations
that came back unusable), ``stratum(j, out)`` and ``check(held)`` ->
``{name: {"value", "limit"}}``.  Everything here is shared by every kind.

The window is a closed loop with one client: the next step (a frame, a
batched step, or one solve) is handed to the port as soon as the last
result is on the host.  Nothing is built or warmed inside it: set-up
builds the kind's inputs on the device and runs one whole replay first.
"""

from __future__ import annotations

import contextlib
import gc
import subprocess
import sys
import time
import types

from . import sampler, spans as spans_mod, trace as trace_mod


def _power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run(bench, cell: str, seed: int, seconds: float, trace: bool,
        t_start: float, device=None) -> dict:
    """The result of one run (the dict printed as the last line).
    ``device`` None means the card, and without enough cards the run ends
    with no result; the harness's tests pass "cpu"."""
    import torch
    r = bench.resolve(cell)
    chips = r["entry"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"cell {cell} needs {chips} CUDA device(s); "
                             f"found {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    port = r["kind"].port()
    undo = [bench.module("faults", f).apply(port)
            for f in r["settings"].get("faults", [])]
    try:
        work = r["kind"].Cell(bench, r, port, seed, device)
        return Run(bench, r, work, seed, device).go(seconds, trace, t_start)
    finally:
        for u in reversed(undo):
            u()


class Run:
    def __init__(self, bench, r, work, seed, device):
        """``work``: the kind's ``Cell``, built at set-up."""
        import torch
        self.bench, self.r, self.seed = bench, r, seed
        self.work = work
        self.device = device
        self.on_card = device.type == "cuda"
        self.torch = torch

    def sync(self):
        if self.on_card:
            self.torch.cuda.synchronize()

    def replay(self, replay: int, offer, stop=None) -> bool:
        """Run one replay, ``offer(j, out, t0, t1)`` after every step.
        Returns False when ``stop(t1)`` ended it early."""
        self.work.reset(replay)
        for j in range(self.work.steps):
            t0 = time.perf_counter()
            out = self.work.step(j)
            t1 = time.perf_counter()
            offer(j, out, t0, t1)
            if stop is not None and stop(t1):
                return False
        return True

    def sampler(self):
        return sampler.Sampler(self.seed, self.work.strata,
                               self.work.stratum)

    def go(self, seconds: float, trace: bool, t_start: float) -> dict:
        # warm-up: one whole replay, holding samples as the window does
        warm = self.sampler()
        self.replay(0, lambda j, out, t0, t1: warm.offer(j, out))
        del warm
        gc.collect()
        sp = None
        if trace:
            per_layer = [md.get("args", {}) for _, md in self.r["per_layer"]]
            names = {a["span"] for a in per_layer if "span" in a}
            names |= {s for a in per_layer for s in a.get("minus", [])}
            sp = spans_mod.Spans(self.bench, sorted(names))
            sp.install()
        try:
            return self._measure(seconds, trace, t_start, sp)
        finally:
            if sp is not None:
                sp.uninstall()

    def _measure(self, seconds, trace, t_start, sp) -> dict:
        self.sync()
        setup_s = time.perf_counter() - t_start
        samples = self.sampler()
        lat, n = [], {"frames": 0, "failed": 0, "steps": 0}
        per_step = self.work.per_step

        def offer(j, out, t0, t1):
            lat.append(t1 - t0)
            n["frames"] += per_step
            n["failed"] += out["failed"]
            n["steps"] += 1
            n["end"] = t1
            samples.offer(j, out)

        syncs = [0]
        replay = 1
        t_win = time.perf_counter()
        with (spans_mod.count_syncs(syncs) if trace
              else contextlib.nullcontext()):
            while self.replay(replay, offer,
                              stop=lambda t: t - t_win >= seconds):
                replay += 1
        self.sync()
        peak = (self.torch.cuda.max_memory_allocated(self.device)
                if self.on_card else 0)
        ctx = types.SimpleNamespace(
            latencies_s=lat, frames=n["frames"], steps=n["steps"],
            window_s=n["end"] - t_win, setup_s=setup_s, syncs=syncs[0],
            records=list(sp.records) if sp else [],
            missing=list(sp.missing) if sp else [], profile=None,
            captures={}, profiled_steps=0, bench=self.bench)
        if trace:
            self._profile(ctx, sp, replay + 1)

        defs = self.r["per_layer"] if trace else self.r["end_to_end"]
        metrics = {}
        for m, md in defs:
            value = self.bench.module("readers", md["reader"]).read(
                ctx, **md.get("args", {}))
            if value is None:
                print(f"metric {m['name']}: nothing to read, left out",
                      file=sys.stderr)
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        print(f"window: {n['steps']} steps, {n['frames']} frames in "
              f"{ctx.window_s:.4f} s", file=sys.stderr)
        # the check, once the window has closed and the peak is read
        t_check = time.perf_counter()
        checks = self.work.check(samples.items())
        print(f"check: {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
        # the traffic is chosen so that no operation fails: one that comes
        # back unusable is a fault
        checks["failed_share"] = {
            "value": n["failed"] / max(n["frames"], 1),
            "limit": self.r["settings"]["limits"]["failed_share"]}
        samples = self.work = None
        gc.collect()

        dev = {"platform": "gpu" if self.on_card else "cpu",
               "kind": (self.torch.cuda.get_device_name(self.device)
                        if self.on_card else "cpu"),
               "count": self.r["entry"]["chips"] if self.on_card else 0,
               "memory_peak_bytes": int(peak)}
        if ctx.profile is not None:
            dev["busy_s"] = trace_mod.busy(ctx.profile)
            dev["window_s"] = trace_mod.window_s(ctx.profile)
        if trace and self.on_card:
            dev["power_limit"] = _power_limit()
        result = {"correct": all(c["value"] <= c["limit"]
                                 for c in checks.values()),
                  "attempted": n["frames"], "failed": n["failed"],
                  "metrics": metrics, "device": dev}
        if ctx.profile is not None:
            result["breakdown"] = trace_mod.breakdown(ctx.profile)
        result["checks"] = checks
        return result

    def _profile(self, ctx, sp, replay: int) -> None:
        """One more replay under the profiler, the spans annotated and the
        rooflines' inputs captured."""
        for _, md in self.r["per_layer"]:
            args = md.get("args", {})
            if "counts" in args:
                sp.hooks[args["span"]] = self.bench.module(
                    "rooflines", args["counts"]).capture
        sp.annotate = True
        count = [0]

        def step(j, out, t0, t1):
            count[0] += 1

        if self.on_card:
            ctx.profile = trace_mod.profile(lambda: self.replay(replay, step))
        ctx.profiled_steps = count[0]
        ctx.captures = dict(sp.captures)
