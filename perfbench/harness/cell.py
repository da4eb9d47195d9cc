"""One run of one cell: set-up, the measured window, the traced extras,
the check against the plain reference, and the result line.

The window is a closed loop with one client: the driver hands the port
the next frame (or the next batched step) as soon as the last pose is
back on the host.  Nothing is built or warmed inside it: set-up renders
the scene on the device and runs one whole replay (bootstrap, steady
steps, respawns) first.
"""

from __future__ import annotations

import contextlib
import gc
import os
import subprocess
import sys
import time
import types

import numpy as np

from . import sampler, spans as spans_mod, trace as trace_mod


def _import_port():
    """The port's modules that drivers, faults and controls reach."""
    from boofcv_tpu_torch.feature import klt
    from boofcv_tpu_torch.sfm import stereo_vo
    return types.SimpleNamespace(klt=klt, stereo_vo=stereo_vo)


def seeds_of(seed: int):
    """replay -> the RANSAC seed of that replay (stream b adds b)."""
    return lambda replay: (int(seed) * 1_000_003 + 7919 * replay) % (2 ** 62)


def _state_np(state, b):
    """One stream's state as numpy (``b`` None: an unstacked state)."""
    pick = (lambda a: a) if b is None else (lambda a: a[b])
    a = lambda t: pick(t).detach().cpu().numpy()
    return {"xs": a(state.xs).astype(np.float64),
            "ys": a(state.ys).astype(np.float64),
            "world": a(state.world), "alive": a(state.alive),
            "R": a(state.R), "t": a(state.t), "uid": a(state.uid),
            "templates": {k: [a(x) for x in getattr(state.templates, k)]
                          for k in ("desc", "grad_x", "grad_y")}}


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
    port = _import_port()
    undo = [bench.module("faults", f).apply(port)
            for f in r["settings"].get("faults", [])]
    try:
        return Run(bench, r, port, seed, torch.device(device)).go(
            seconds, trace, t_start)
    finally:
        for u in reversed(undo):
            u()


class Run:
    def __init__(self, bench, r, port, seed, device):
        import torch
        from traffic import render
        self.bench, self.r, self.seed = bench, r, seed
        self.device = device
        self.on_card = device.type == "cuda"
        config, traffic = r["config"], r["traffic"]
        vo = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["vo"].items()}
        vo["klt"] = port.klt.KltConfig(**vo["klt"])
        self.frames = render.render_sequence(
            seed, config["camera"], config["scene"],
            traffic["rendered_frames"], device)
        self.driver = r["driver"].Driver(
            port, port.stereo_vo.StereoVoConfig(**vo), config["camera"],
            traffic, self.frames, device, seeds_of(seed))
        self.steps = traffic["frames_per_replay"]
        self.check = r["settings"]["check"]
        self.torch = torch

    def sync(self):
        if self.on_card:
            self.torch.cuda.synchronize()

    def replay(self, replay: int, offer, stop=None) -> bool:
        """Run one replay, ``offer(j, out, t0, t1)`` after every step.
        Returns False when ``stop(t1)`` ended it early."""
        self.driver.reset(replay)
        for j in range(self.steps):
            t0 = time.perf_counter()
            out = self.driver.step(j)
            t1 = time.perf_counter()
            offer(j, out, t0, t1)
            if stop is not None and stop(t1):
                return False
        return True

    def sampler(self):
        return sampler.Sampler(self.seed, self.check["steps"],
                               self.check["spawn_steps"])

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
        streams = self.driver.streams

        def offer(j, out, t0, t1):
            lat.append(t1 - t0)
            n["frames"] += streams
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
        checks = self._check(samples)
        print(f"check: {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
        # every frame of the scene has hundreds of trackable features: a
        # pose that comes back unusable is a fault
        checks["failed_share"] = {
            "value": n["failed"] / max(n["frames"], 1),
            "limit": self.r["settings"]["limits"]["failed_share"]}
        samples = self.driver = None
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

    def _check(self, samples) -> dict:
        """The reference's numbers on the held steps, each with its
        limit."""
        sys.path.insert(0, os.path.join(self.bench.dir, "reference"))
        import check as ref_check
        config = self.r["config"]
        lefts = self.frames[0].cpu().numpy()
        rights = self.frames[1].cpu().numpy()
        rng = np.random.default_rng([int(self.seed) % (2 ** 63), 29])
        cases = []
        for j, out in samples.items():
            stacked = out["after"].xs.dim() == 2
            streams = [None] if not stacked else list(range(len(out["frames"])))
            states = [(_state_np(out["before"], b), _state_np(out["after"], b))
                      for b in streams]
            if stacked:
                # ``streams`` streams of every held step, and
                # ``spawn_streams`` of those that spawned in it
                spawned = [b for b, (s0, s1) in zip(streams, states)
                           if (s1["alive"] & (s1["uid"] != s0["uid"])).any()]
                keep = set(rng.permutation(streams)[
                    :self.check["streams"]].tolist())
                keep |= set(rng.permutation(spawned)[
                    :self.check["spawn_streams"]].tolist())
            else:
                keep = {None}
            for b, (s0, s1) in zip(streams, states):
                if b in keep:
                    f = out["frames"][0 if b is None else b]
                    cases.append({"s0": s0, "s1": s1, "left": lefts[f],
                                  "right": rights[f], "boot": j == 0})
        numbers = ref_check.compare(cases, config["vo"], config["fixed"],
                                    config["camera"])
        limits = self.r["settings"]["limits"]
        out = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
        # a check that saw no tracking step or no spawn has not covered the
        # path
        covered = (any(not c["boot"] for c in cases),
                   any(c["boot"] or bool((c["s1"]["alive"] & (
                       c["s1"]["uid"] != c["s0"]["uid"])).any())
                       for c in cases))
        out["uncovered"] = {"value": covered.count(False), "limit": 0}
        return out
