"""``BENCHMARK.json`` and the files it names: found by name, inside the
contract's limits, and extended by data alone."""

import json
import os
import re
import subprocess
import sys

import pytest

from harness import cell, spec

from conftest import BENCH, ROOT


def test_benchmark_is_valid_and_every_cell_resolves():
    bench = spec.Benchmark(ROOT)
    assert bench.validate() == []
    for w in bench.spec["workloads"]:
        r = bench.resolve(w["name"])
        assert r["config"]["name"] == w["config"]
        assert r["kind"] is bench.module("kinds", "stereo_vo")
        assert {m["name"] for m, _ in r["end_to_end"]} == {
            "frame_p95_ms", "setup_s"}
        assert "window_frames_per_s" in [m["name"] for m, _ in r["per_layer"]]
        assert set(r["settings"]["limits"]) >= {
            "klt_gap_p90_px", "pose_gap_px", "spawn_world_gap",
            "template_gap"}


def test_names_units_and_files_use_the_allowed_characters():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        s = json.load(f)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    names += [w[k] for w in s["workloads"] for k in ("config", "traffic")]
    names += [k for c in s["configs"] for k in c["reduced"]]
    assert all(spec.NAME.match(n) for n in names), names
    assert all(spec.UNIT.match(m["unit"])
               for m in s["end_to_end"] + s["per_layer"])
    path = re.compile(r"^[A-Za-z0-9_.\-/]+$")
    for top, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(top, f), ROOT)
            assert path.match(rel) and len(rel) <= 200, rel


def test_bad_names_are_refused():
    for bad in ("has space", "a,b", "a/b", "-lead", "é", "x" * 65):
        assert not spec.NAME.match(bad)
    for bad in ("tokens per second", "", "x" * 17, "µs"):
        assert not spec.UNIT.match(bad)


def test_a_cell_config_and_metric_added_as_data(tiny_root):
    bench = spec.Benchmark(tiny_root)
    assert bench.validate() == []
    r = bench.resolve("tiny.single")
    assert r["config"]["camera"]["width"] == 160
    assert r["traffic"]["driver"] == "single_stream"
    assert "test_p50_ms" in [m["name"] for m, _ in r["per_layer"]]
    assert "test_p50_ms" not in [m["name"] for m, _ in
                                 bench.resolve("tiny.fleet")["per_layer"]]


def test_a_missing_file_is_reported(tiny_root, tmp_path):
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        s = json.load(f)
    s["workloads"].append({"name": "nothing.here", "config": "test.tiny",
                           "traffic": "no.such.traffic", "chips": 1,
                           "why": "a cell whose traffic file is missing"})
    os.symlink(os.path.join(tiny_root, "perfbench"), tmp_path / "perfbench")
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(s, f)
    bad = spec.Benchmark(str(tmp_path)).validate()
    assert any("nothing.here" in b and "missing file" in b for b in bad)


def test_a_measured_run_needs_the_card(tiny_root):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit):
        cell.run(spec.Benchmark(tiny_root), "tiny.single", 1, 1.0, False,
                 0.0)


def test_the_command_prints_no_result_without_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "vo640.single", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
