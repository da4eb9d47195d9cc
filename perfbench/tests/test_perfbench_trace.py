"""The trace readers on a synthetic event list: the window, the pads, the
kernels tied to their spans, busy and idle time, launches, rooflines."""

import types

import pytest

from harness import spec, trace

from conftest import ROOT


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


EVENTS = [
    _ev("kernel", "spin_kernel", 0, 1, correlation=1),
    _ev("user_annotation", "pb.window", 100, 1000),
    _ev("user_annotation", "pb.klt", 150, 50),
    _ev("cpu_op", "aten::mul", 300, 20),
    _ev("cuda_runtime", "cudaLaunchKernel", 160, 5, correlation=10),
    _ev("cuda_runtime", "cudaLaunchKernel", 310, 5, correlation=11),
    _ev("kernel", "klt_track_kernel", 200, 100, correlation=10),
    _ev("kernel", "mul_kernel", 600, 100, correlation=11),
    _ev("gpu_memcpy", "Memcpy DtoH", 650, 100, correlation=12),
    _ev("kernel", "late_kernel", 1200, 10, correlation=13),
]


def test_parse_busy_and_idle():
    t = trace.parse(EVENTS)
    assert t["pads_seen"] == 1
    assert [k[0] for k in t["kernels"]] == ["klt_track_kernel", "mul_kernel"]
    assert trace.window_s(t) == pytest.approx(1000e-6)
    # union of [200, 300], [600, 700] and the copy [650, 750]
    assert trace.busy(t) == pytest.approx(250e-6)
    assert trace.span_device_s(t, "klt") == [pytest.approx(100e-6)]
    b = trace.breakdown(t)
    assert b["device_ops"][0][1] == pytest.approx(100e-6)
    assert len(b["idle_gaps"]) <= 10
    # the longest gap is the window's tail, then the wait for mul_kernel
    assert [g[1] for g in b["idle_gaps"][:2]] == [pytest.approx(350e-6),
                                                  pytest.approx(300e-6)]
    assert b["idle_gaps"][1][0].endswith("aten::mul")


def _ctx(t, **kw):
    bench = spec.Benchmark(ROOT)
    base = dict(profile=t, profiled_steps=2, missing=[], captures={},
                bench=bench, records=[], steps=4, syncs=6,
                latencies_s=[0.1, 0.2, 0.3, 0.4], frames=4, window_s=2.0,
                setup_s=5.0)
    base.update(kw)
    return types.SimpleNamespace(**base), bench


def test_readers_on_the_synthetic_trace():
    t = trace.parse(EVENTS)
    ctx, bench = _ctx(t)
    read = lambda name, **a: bench.module("readers", name).read(ctx, **a)
    assert read("launches_per_step") == 1.0
    assert read("idle_share") == pytest.approx(75.0)
    assert read("syncs_per_step") == 1.5
    assert read("frames_per_s") == 2.0
    assert read("setup_s") == 5.0
    assert read("latency_ms", q=0.5) == pytest.approx(250.0)


def test_span_self_time():
    ctx, bench = _ctx(None, records=[("motion", 0.0, 1.0),
                                     ("refine", 0.2, 0.9),
                                     ("motion", 2.0, 2.5)], steps=2)
    read = bench.module("readers", "span_ms").read
    assert read(ctx, span="motion", minus=["refine"]) == pytest.approx(400.0)
    assert read(ctx, span="refine") == pytest.approx(350.0)
    ctx.missing = ["refine"]
    assert read(ctx, span="refine") is None


def test_roofline_share_and_nothing_to_read():
    t = trace.parse(EVENTS)

    class Counts:
        capture = None

        @staticmethod
        def count(rec):
            return rec

    ctx, bench = _ctx(t, captures={"klt": [(3.35e6, 0)]})
    bench.module("rooflines", "klt")
    path = next(p for p in bench.modules if p.endswith("rooflines/klt.py"))
    bench.modules[path] = Counts
    read = bench.module("readers", "roofline").read
    # 3.35e6 bytes at 3.35e12 B/s = 1 us over 100 us of device time
    assert read(ctx, span="klt", counts="klt") == pytest.approx(1.0)
    ctx.captures = {}
    assert read(ctx, span="klt", counts="klt") is None
    ctx.profile = None
    assert read(ctx, span="klt", counts="klt") is None
