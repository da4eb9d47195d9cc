"""Fixtures of the benchmark's own tests: the harness and the repo on the
path, a card when there is one, and a benchmark folder of tiny cells
defined as data alone."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY_CONFIG = {
    "vo": {"num_tracks": 96, "pyramid_scales": [1, 2, 4], "template_radius": 3,
           "min_disparity": 0, "max_disparity": 24, "ransac_hypotheses": 32,
           "refine_iterations": 10, "inlier_threshold_px": 1.5,
           "detect_radius": 5, "detect_threshold": 1.0,
           "disparity_radius": 3, "respawn_below": 0.6,
           "klt": {"max_iterations": 15, "convergence_tol": 0.01,
                   "max_per_pixel_error": 25.0, "min_determinant": 0.001}},
    "camera": {"width": 160, "height": 120, "fx": 120.0, "fy": 120.0,
               "cx": 80.0, "cy": 60.0, "baseline": 0.4},
    "scene": {"texture_size": 128, "octaves": 4, "texture_scale": 14.0,
              "plane_origin": [0.0, 0.0, 8.0], "plane_x": [1.0, 0.0, 0.0],
              "plane_y": [0.0, 1.0, -0.15], "yaw_per_frame": 0.002,
              "creep_per_frame": [0.01, 0.0, 0.05]},
}
TINY_TRAFFIC = {
    "tiny.single": {"driver": "single_stream", "streams": 1,
                    "frames_per_replay": 6, "rendered_frames": 6,
                    "stream_offset": 0},
    "tiny.fleet": {"driver": "batched", "streams": 3,
                   "frames_per_replay": 6, "rendered_frames": 8,
                   "stream_offset": 1},
}
FAULTS = {"tiny.single": ("state_unchanged", "pose_altered", "retire_all",
                          "klt_lost"),
          "tiny.fleet": ("state_unchanged", "half_batch", "pose_altered",
                         "retire_all", "klt_lost")}


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout-like folder: the benchmark's files, and a tiny
    configuration, two traffic mixes and their cells (one clean and one
    for each fault) added as data alone."""
    root = str(tmp_path_factory.mktemp("bench"))
    shutil.copytree(BENCH, os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    source = os.path.join(BENCH, "configs", "stereo_vo.example_640x480.json")
    with open(source) as f:
        config = json.load(f)
    config.update(TINY_CONFIG, name="test.tiny")
    config["vo"] = TINY_CONFIG["vo"]
    _write(os.path.join(root, "perfbench", "configs", "test.tiny.json"),
           config)
    spec["configs"].append({"name": "test.tiny", "source": "the tests",
                            "file": "perfbench/configs/test.tiny.json",
                            "reduced": ["num_tracks"], "why": "a test"})
    with open(os.path.join(BENCH, "workloads", "vo640.single.json")) as f:
        settings = json.load(f)
    for traffic, body in TINY_TRAFFIC.items():
        for fault in (None,) + FAULTS[traffic]:
            name = traffic + (f".{fault}" if fault else "")
            # a pair of configuration and traffic appears once: each cell
            # has its own copy of the mix
            _write(os.path.join(root, "perfbench", "traffic",
                                f"{name}.json"), body)
            cell = dict(settings, check={"steps": 3, "spawn_steps": 2,
                                         "streams": body["streams"],
                                         "spawn_streams": body["streams"]})
            if fault:
                cell["faults"] = [fault]
            _write(os.path.join(root, "perfbench", "workloads",
                                f"{name}.json"), cell)
            spec["workloads"].append({
                "name": name, "config": "test.tiny", "traffic": name,
                "chips": 1, "why": "a test cell"})
    # a per-layer metric added as data: a second quantile of the latencies
    _write(os.path.join(root, "perfbench", "metrics", "test_p50_ms.json"),
           {"reader": "latency_ms", "args": {"q": 0.5}})
    spec["per_layer"].append({
        "name": "test_p50_ms", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "device (one H100)",
        "moves": "frame_p95_ms", "workloads": ["tiny.single"]})
    _write(os.path.join(root, "BENCHMARK.json"), spec)
    return root
