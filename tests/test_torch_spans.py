"""The port's span recorder (``utils/profiling.span``), the span tree of
the stereo-VO front end and batched entry points, and the benchmark's
reader of it (``perfbench/readers/port_span_ms.py``), on the CPU."""

import importlib.util
import json
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

from boofcv_tpu_torch.io import simulate as tsim
from boofcv_tpu_torch.sfm import stereo_vo as tvo
from boofcv_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "perfbench")


def _since(t0):
    """The records of spans opened at or after ``t0`` (ns)."""
    return [r for r in profiling.records() if r[4] >= t0]


def _tree(recs, root):
    """{span id: [its child records by start]} in ``root``'s step."""
    kids = {}
    for r in sorted(recs, key=lambda r: r[4]):
        if r[3] == root[1] and r[2] is not None:
            kids.setdefault(r[2], []).append(r)
    return kids


def _names(kids, rec):
    return [r[0] for r in kids.get(rec[1], [])]


def _child(kids, rec, name):
    (found,) = [r for r in kids.get(rec[1], []) if r[0] == name]
    return found


# --- the recorder ------------------------------------------------------------

def test_nesting_ids_and_self_time():
    t0 = time.perf_counter_ns()
    with profiling.span("a"):
        with profiling.span("b"):
            with profiling.span("c"):
                time.sleep(0.002)
        with profiling.span("d"):
            pass
    with profiling.span("e"):
        pass
    recs = _since(t0)
    # written as each span closes: children before their parent
    assert [r[0] for r in recs] == ["c", "b", "d", "a", "e"]
    by = {r[0]: r for r in recs}
    a, b, c, d, e = (by[k] for k in "abcde")
    assert a[2] is None and b[2] == a[1] and c[2] == b[1] and d[2] == a[1]
    assert {r[3] for r in (a, b, c, d)} == {a[1]}
    assert e[2] is None and e[3] == e[1] != a[1]
    assert len({r[1] for r in recs}) == 5
    for r in recs:
        assert r[4] <= r[5]
    assert a[4] <= b[4] <= c[4] <= c[5] <= b[5] <= d[4] <= d[5] <= a[5]
    dur = lambda r: r[5] - r[4]
    assert dur(c) >= 2_000_000
    self_a = dur(a) - dur(b) - dur(d)
    assert 0 <= self_a < dur(a) - dur(c)


def test_ring_bound_and_dropped():
    before, held = profiling.dropped(), len(profiling.records())
    n = profiling.RING + 5
    for _ in range(n):
        with profiling.span("fill"):
            pass
    recs = profiling.records()
    assert len(recs) == profiling.RING
    assert profiling.dropped() - before == held + 5
    # oldest first: the last RING of the spans just written, in order
    assert all(r[0] == "fill" for r in recs)
    ids = [r[1] for r in recs]
    assert ids == sorted(ids) and ids[-1] - ids[0] == profiling.RING - 1


def test_recording_off_records_nothing():
    t0 = time.perf_counter_ns()
    assert profiling.set_recording(False) is True
    try:
        with profiling.span("off"):
            with profiling.span("off.inner"):
                pass
        # a span opened while off and closed while on writes nothing
        s = profiling.span("switched")
        s.__enter__()
        profiling.set_recording(True)
        s.__exit__(None, None, None)
        profiling.set_recording(False)
    finally:
        assert profiling.set_recording(True) is False
    assert _since(t0) == []
    with profiling.span("on"):
        pass
    assert [r[0] for r in _since(t0)] == ["on"]


def test_exception_unwinds_the_stack():
    t0 = time.perf_counter_ns()
    with pytest.raises(KeyError):
        with profiling.span("outer"):
            with profiling.span("inner"):
                raise KeyError("x")
    # an inner span entered but never exited is closed with its parent
    with pytest.raises(ValueError):
        with profiling.span("outer2"):
            profiling.span("leaked").__enter__()
            raise ValueError("y")
    with profiling.span("after"):
        pass
    by = {r[0]: r for r in _since(t0)}
    assert set(by) == {"outer", "inner", "outer2", "after"}
    assert by["inner"][2] == by["outer"][1]
    assert by["after"][2] is None and by["after"][3] == by["after"][1]


def test_spans_are_profiler_ranges_only_under_a_profiler(tmp_path,
                                                          monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("vo.frame"):
            with profiling.span("ransac"):
                with profiling.span("refine"):
                    torch.ones(64) @ torch.ones(64)
            with profiling.span("vo.readback"):
                torch.ones(8).sum()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("cat") == "user_annotation"}
    assert set(ranges) >= {"vo.frame", "ransac", "refine", "vo.readback"}
    inside = lambda a, b: (ranges[b][0] <= ranges[a][0]
                           and ranges[a][1] <= ranges[b][1])
    assert inside("refine", "ransac") and inside("ransac", "vo.frame")
    assert inside("vo.readback", "vo.frame")
    assert not inside("vo.readback", "ransac")
    # the operators ran inside the span that ran them
    mm = [e for e in events if e.get("cat") == "cpu_op"
          and e["name"] in ("aten::matmul", "aten::dot")]
    assert mm and all(ranges["refine"][0] <= float(e["ts"])
                      <= ranges["refine"][1] for e in mm)

    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profiling.span("no.profiler"):
        pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("profiled"):
            pass
    assert entered == ["profiled"]


# --- the stereo-VO span tree -------------------------------------------------

H, W = 96, 128
K = np.array([[120.0, 0.0, W / 2], [0.0, 120.0, H / 2], [0.0, 0.0, 1.0]])
BASELINE = 0.3
CFG_KW = dict(num_tracks=96, pyramid_scales=(1, 2, 4), max_disparity=32,
              ransac_hypotheses=32, refine_iterations=4, detect_radius=4)


@pytest.fixture(scope="module")
def frames():
    """Three frames of a forward creep, 8-bit like a camera's."""
    poses = []
    for i in range(3):
        c = np.array([0.01 * i, 0.0, 0.05 * i])
        poses.append((np.eye(3), -c))
    seq = tsim.render_stereo_sequence(np.random.default_rng(3), K, BASELINE,
                                      poses, H, W)
    return (np.stack([np.round(l) for l, _ in seq]).astype(np.uint8),
            np.stack([np.round(r) for _, r in seq]).astype(np.uint8))


@pytest.mark.parametrize("respawn_below", [0.0, 1.01],
                         ids=["no_spawn", "spawn"])
def test_front_end_span_tree(frames, respawn_below):
    lefts, rights = frames
    vo = tvo.StereoVisualOdometry(
        tvo.StereoVoConfig(respawn_below=respawn_below, **CFG_KW), K,
        BASELINE, H, W, seed=5, device="cpu")
    t0 = time.perf_counter_ns()
    for i in range(3):
        vo.process(lefts[i], rights[i])
    recs = _since(t0)
    roots = [r for r in recs if r[2] is None]
    assert [r[0] for r in roots] == ["vo.frame"] * 3

    boot = roots[0]
    kids = _tree(recs, boot)
    assert _names(kids, boot) == ["vo.upload", "vo.bootstrap", "vo.readback"]
    b = _child(kids, boot, "vo.bootstrap")
    assert _names(kids, b) == ["pyramid", "gradient", "spawn"]
    assert _names(kids, _child(kids, b, "spawn")) == ["sad"]

    spawn = ["gradient", "spawn"] if respawn_below > 1 else []
    for root in roots[1:]:
        kids = _tree(recs, root)
        assert _names(kids, root) == ["vo.upload", "vo.step", "vo.readback"]
        s = _child(kids, root, "vo.step")
        assert _names(kids, s) == (["pyramid", "klt", "ransac",
                                    "vo.spawn_wait"] + spawn)
        assert _names(kids, _child(kids, s, "ransac")) == ["refine"]
        for leaf in ("pyramid", "klt", "vo.spawn_wait"):
            assert _names(kids, _child(kids, s, leaf)) == []
        if spawn:
            assert _names(kids, _child(kids, s, "spawn")) == ["sad"]
        # every span of the frame shares its step id and lies inside it
        for r in recs:
            if r[3] == root[1]:
                assert root[4] <= r[4] <= r[5] <= root[5]


def test_batched_calls_are_one_root_each(frames):
    lefts, rights = frames
    cfg = tvo.StereoVoConfig(**CFG_KW)
    boot = tvo.make_batched_bootstrap(cfg, K, BASELINE, device="cpu")
    step = tvo.make_batched_step(cfg, K, BASELINE, device="cpu")
    run = tvo.make_batched_sequence_runner(cfg, K, BASELINE, device="cpu")
    f = lambda a, i: torch.from_numpy(np.stack([a[i], a[i]]))
    t0 = time.perf_counter_ns()
    s = boot(tvo.init_batched_state(cfg, 2, H, W, seed=1, device="cpu"),
             f(lefts, 0), f(rights, 0))
    s, _ = step(s, f(lefts, 1), f(rights, 1))
    seq = lambda a: torch.stack([f(a, 1), f(a, 2)])
    run(s, seq(lefts), seq(rights))
    recs = _since(t0)
    roots = [r for r in recs if r[2] is None]
    assert [r[0] for r in roots] == ["vo.batch"] * 3
    expect = [["vo.bootstrap"], ["vo.step"], ["vo.step", "vo.step"]]
    for root, names in zip(roots, expect):
        kids = _tree(recs, root)
        assert _names(kids, root) == names
        assert all(r[3] == root[1] for r in recs
                   if root[4] <= r[4] and r[5] <= root[5])


# --- the benchmark's reader ----------------------------------------------------

def _reader():
    spec = importlib.util.spec_from_file_location(
        "_port_span_ms_under_test",
        os.path.join(BENCH, "readers", "port_span_ms.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _steps(n, t_start, first_id=1, upload_ns=1000, child_ns=300):
    """``n`` synthetic frames of 10 us from ``t_start`` (ns), each a
    ``vo.frame`` root with an upload and a step that has one child."""
    recs, i, t = [], first_id, t_start
    for _ in range(n):
        root, up, st, ch = i, i + 1, i + 2, i + 3
        recs += [("vo.upload", up, root, root, t, t + upload_ns),
                 ("klt", ch, st, root, t + 2000, t + 2000 + child_ns),
                 ("vo.step", st, root, root, t + 1500, t + 9000),
                 ("vo.frame", root, None, root, t, t + 10_000)]
        i += 4
        t += 20_000
    return recs


def test_reader_takes_the_window_between_warm_up_and_profile(monkeypatch):
    reader = _reader()
    warm = _steps(3, 0, upload_ns=5000)
    window = _steps(4, 100_000, first_id=100)
    profiled = _steps(2, 500_000, first_id=200, upload_ns=7000)
    # a span outside any root is no step
    loose = [("pyramid", 300, None, 300, 90_000, 91_000)]
    recs = warm + loose + window + profiled
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    monkeypatch.setattr(profiling, "dropped", lambda: 0)
    ctx = type("Ctx", (), {})()
    ctx.steps, ctx.profiled_steps = 4, 2
    ctx.latencies_s = [11e-6] * 4
    roots = ["vo.frame", "vo.batch"]
    read = lambda spans, **k: reader.read(ctx, spans, roots, **k)
    assert read(["vo.upload"]) == pytest.approx(1000 / 1e6)
    # self time: the root less its upload and step, the step less its child
    assert read(["vo.frame"], self=True) == pytest.approx(
        (10_000 - 1000 - 7500) / 1e6)
    assert read(["vo.step"], self=True) == pytest.approx(7200 / 1e6)
    assert read(["vo.frame", "vo.step"], self=True) == pytest.approx(
        (1500 + 7200) / 1e6)
    assert read(["nothing.here"]) == 0.0

    # nothing to read: too few roots
    ctx.steps = 8
    ctx.latencies_s = [11e-6] * 8
    assert read(["vo.upload"]) is None
    ctx.steps, ctx.latencies_s = 4, [11e-6] * 4
    # a root longer than its step's latency
    ctx.latencies_s = [11e-6, 11e-6, 9e-6, 11e-6]
    assert read(["vo.upload"]) is None
    ctx.latencies_s = [11e-6] * 4
    # records dropped: before the window is fine, inside it is not
    monkeypatch.setattr(profiling, "dropped", lambda: 7)
    assert read(["vo.upload"]) == pytest.approx(1000 / 1e6)
    monkeypatch.setattr(profiling, "records",
                        lambda: list(window[2:] + profiled))
    assert read(["vo.upload"]) is None
    # a port without the recorder
    monkeypatch.delattr(profiling, "records")
    assert read(["vo.upload"]) is None


# --- one traced run of the benchmark on the CPU --------------------------------

NEW = {"tiny.single": ("upload_host_ms", "readback_wait_ms", "spawn_wait_ms",
                       "step_self_host_ms"),
       "tiny.fleet": ("spawn_wait_ms", "step_self_host_ms")}


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    """A checkout-like folder: the benchmark's files and the tiny cells of
    its own tests, each new per-layer metric listing them."""
    saved = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "_perfbench_tiny_cells", os.path.join(BENCH, "tests", "conftest.py"))
    tiny = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tiny)
    sys.path[:] = saved
    root = str(tmp_path_factory.mktemp("bench"))
    shutil.copytree(BENCH, os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(BENCH, "configs",
                           "stereo_vo.example_640x480.json")) as f:
        config = json.load(f)
    config.update(tiny.TINY_CONFIG, name="test.tiny")
    with open(os.path.join(BENCH, "workloads", "vo640.single.json")) as f:
        settings = json.load(f)

    def write(rel, obj):
        with open(os.path.join(root, "perfbench", rel), "w") as f:
            json.dump(obj, f)

    write("configs/test.tiny.json", config)
    bench["configs"].append({"name": "test.tiny", "source": "the tests",
                             "file": "perfbench/configs/test.tiny.json",
                             "reduced": ["num_tracks"], "why": "a test"})
    for name in NEW:
        body = tiny.TINY_TRAFFIC[name]
        write(f"traffic/{name}.json", body)
        write(f"workloads/{name}.json", dict(
            settings, check={"steps": 3, "spawn_steps": 2,
                             "streams": body["streams"],
                             "spawn_streams": body["streams"]}))
        bench["workloads"].append({"name": name, "config": "test.tiny",
                                   "traffic": name, "chips": 1,
                                   "why": "a test cell"})
        for m in bench["per_layer"]:
            if m["name"] in NEW[name]:
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.mark.parametrize("cell_name", sorted(NEW))
def test_traced_run_reports_the_port_spans(tiny_bench, cell_name,
                                           monkeypatch):
    monkeypatch.syspath_prepend(BENCH)
    # the sync counter's debug mode exists only in a CUDA build; a CPU
    # run has no CUDA syncs to count
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    from harness import cell, spec
    res = cell.run(spec.Benchmark(tiny_bench), cell_name, 2 ** 32 + 11, 1.5,
                   True, time.perf_counter(), device="cpu")
    assert res["correct"], res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in NEW[cell_name]:
        assert name in got and 0 < got[name] < 1e4, (name, got)
    # disjoint parts of a step: together under the window's mean step
    streams = 3 if cell_name == "tiny.fleet" else 1
    step_ms = 1e3 * streams / got["window_frames_per_s"]
    assert sum(got[name] for name in NEW[cell_name]) < step_ms
