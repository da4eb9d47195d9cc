"""A profiled stretch of the run and what it shows.

``profile`` is a copy of ``chip_smoke._trace``'s method: on the card's host
the profiler can lose the first device events of a trace, so every trace
is led by launches of a kernel that returns at once, a pause, and more of
them; a trace in which no pad or nothing after the pads is seen is taken
again with four times the pause and the pads.  The pads here are the
harness's own (``torch.cuda._sleep``, kernel ``spin_kernel``), not the
port's.

The trace is exported as Chrome JSON into the run's temporary directory,
read, and deleted.  Kernels are tied to the host span that launched them
by the launch's correlation id (or, for a launch the trace lacks, the
kernel's external id).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import sys
import tempfile
import time

PAD = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ATTEMPTS = 3


def _pads(n: int) -> None:
    import torch
    for _ in range(n):
        torch.cuda._sleep(1)


def profile(run):
    """Run ``run()`` under the profiler inside a ``pb.window`` range;
    returns the parsed trace, or None if every attempt lost it."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import record_function
    lead_s, pads = 0.05, 16
    for attempt in range(ATTEMPTS):
        torch.cuda.synchronize()
        with _profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            _pads(8)
            torch.cuda.synchronize()
            time.sleep(lead_s)
            _pads(pads)
            torch.cuda.synchronize()
            with record_function("pb.window"):
                run()
                torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        parsed = parse(events)
        if parsed["pads_seen"] and parsed["kernels"]:
            return parsed
        print(f"profiler: {parsed['pads_seen']} pads and "
              f"{len(parsed['kernels'])} kernels seen (attempt "
              f"{attempt + 1} of {ATTEMPTS})", file=sys.stderr)
        lead_s, pads = 4 * lead_s, 4 * pads
    return None


def parse(events: list) -> dict:
    """The window, its device operations (kernels with the host time of
    their launch), the ``pb.*`` spans and the host operators."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == "pb.window"]
    out = {"pads_seen": 0, "kernels": [], "device_ops": [], "spans": {},
           "ops": [], "window": None}
    if not win:
        return out
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    out["window"] = (w0, w1)
    launch = {}
    external = {}
    spans = collections.defaultdict(list)
    for e in events:
        cat = e.get("cat")
        args = e.get("args") or {}
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch[args["correlation"]] = float(e["ts"])
        elif cat in ("cpu_op", "user_annotation"):
            if "External id" in args:
                external.setdefault(args["External id"], float(e["ts"]))
            name = e.get("name", "")
            if cat == "user_annotation" and name.startswith("pb.") \
                    and name != "pb.window":
                spans[name[3:]].append((float(e["ts"]),
                                        float(e["ts"]) + float(e["dur"])))
            elif cat == "cpu_op" and w0 <= float(e["ts"]) <= w1:
                out["ops"].append((float(e["ts"]),
                                   float(e["ts"]) + float(e.get("dur", 0)),
                                   name))
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        if PAD in e.get("name", ""):
            out["pads_seen"] += 1
            continue
        ts = float(e["ts"])
        if not w0 <= ts < w1:
            continue
        args = e.get("args") or {}
        at = launch.get(args.get("correlation"),
                        external.get(args.get("External id")))
        op = (e["name"], ts, float(e["dur"]), at)
        out["device_ops"].append(op)
        if e["cat"] == "kernel":
            out["kernels"].append(op)
    out["spans"] = {k: sorted(v) for k, v in spans.items()}
    out["ops"].sort()
    return out


def busy(trace: dict) -> float:
    """Seconds of the window in which some device operation ran (the
    union of their intervals)."""
    w0, w1 = trace["window"]
    total, end = 0.0, w0
    for _, ts, dur, _ in sorted(trace["device_ops"], key=lambda k: k[1]):
        a, b = max(ts, end), min(ts + dur, w1)
        if b > a:
            total += b - a
        end = max(end, ts + dur)
    return total / 1e6


def window_s(trace: dict) -> float:
    w0, w1 = trace["window"]
    return (w1 - w0) / 1e6


def span_device_s(trace: dict, span: str) -> list:
    """Device seconds of the kernels launched inside each call of
    ``span``, in call order."""
    calls = trace["spans"].get(span, [])
    starts = [c[0] for c in calls]
    per = [0.0] * len(calls)
    for _, _, dur, at in trace["kernels"]:
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= calls[i][1]:
            per[i] += dur / 1e6
    return per


def _label(trace: dict, at) -> str:
    """What the host was doing at ``at``: the innermost pb span and the
    outermost operator around it."""
    if at is None:
        return "unattributed"
    span, start = "outside spans", None
    for name, calls in trace["spans"].items():
        i = bisect.bisect_right([c[0] for c in calls], at) - 1
        if i >= 0 and at <= calls[i][1] and (start is None
                                               or calls[i][0] > start):
            span, start = name, calls[i][0]
    ops = trace["ops"]
    i = bisect.bisect_right([o[0] for o in ops], at)
    op = "host"
    for a, b, name in ops[max(0, i - 64):i]:
        if a <= at <= b:
            op = name
            break
    return f"{span}/{op}"


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps by what the host was launching when each ended."""
    by_name = collections.Counter()
    for name, _, dur, _ in trace["device_ops"]:
        by_name[name] += dur / 1e6
    ops = sorted(trace["device_ops"], key=lambda k: k[1])
    gaps = []
    end = trace["window"][0]
    for name, ts, dur, at in ops:
        if ts > end:
            gaps.append((ts - end, at))
        end = max(end, ts + dur)
    gaps.append((trace["window"][1] - end, None))
    gaps.sort(key=lambda g: -g[0])
    return {"device_ops": [[n, s] for n, s in by_name.most_common(10)],
            "idle_gaps": [[_label(trace, at), g / 1e6] for g, at in gaps[:10]]}
