"""The kind layer: a configuration that is not stereo VO, added as files
alone (a kind, its reference, a fault, a configuration, a traffic mix and
cells), validates and runs through the harness on the CPU, and its check
can fail; a missing kind is reported; two kinds' reference modules of one
file name, and the files beside them, do not shadow each other."""

import json
import os
import shutil
import sys

import pytest

from harness import cell, spec

# The toy kind: the reprojection cost of a seeded tiny problem with BAL's
# (Snavely) camera, through the port's ``geo/ba.cost``, against a numpy
# cost at a relative 1e-12.
TOY_KIND = '''"""A toy kind: the reprojection cost of a seeded tiny problem with
BAL's camera (f, k1, k2 a view), one ``geo/ba.cost`` a step."""

import math
import types

import numpy as np


def port():
    from boofcv_tpu_torch.geo import ba
    return types.SimpleNamespace(ba=ba)


def problem(seed, config, j):
    """Step ``j``'s problem as numpy arrays, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 41, j])
    V, P = config["views"], config["points"]
    w = rng.normal(0.0, 0.05, (V, 3))
    R = np.empty((V, 3, 3))
    for v in range(V):
        k = np.array([[0, -w[v, 2], w[v, 1]], [w[v, 2], 0, -w[v, 0]],
                      [-w[v, 1], w[v, 0], 0]])
        th = np.linalg.norm(w[v])
        R[v] = (np.eye(3) + math.sin(th) / th * k
                + (1 - math.cos(th)) / th ** 2 * k @ k)
    t = rng.normal(0.0, 0.2, (V, 3))
    intr = np.stack([rng.uniform(400, 600, V), rng.normal(0, 1e-2, V),
                     rng.normal(0, 1e-3, V)], 1)
    points = rng.uniform([-2, -2, -9], [2, 2, -5], (P, 3))
    obs_view = np.tile(np.arange(V, dtype=np.int32), (P, 1))
    obs_xy = rng.normal(0.0, 300.0, (P, V, 2))
    obs_valid = rng.uniform(size=(P, V)) < 0.9
    return dict(R=R, t=t, intr=intr, points=points, obs_xy=obs_xy,
                obs_view=obs_view, obs_valid=obs_valid)


class Cell:
    def __init__(self, bench, r, port, seed, device):
        import torch
        self.bench, self.r, self.ba = bench, r, port.ba
        self.steps = r["traffic"]["solves_per_replay"]
        self.per_step = 1
        self.strata = {"solve": r["settings"]["check"]["steps"]}
        self.problems = [problem(seed, r["config"], j)
                         for j in range(self.steps)]
        self.on_device = [self.ba.make_problem(
            model="snavely", dtype=getattr(torch, r["config"]["dtype"]),
            device=device, **p) for p in self.problems]

    def reset(self, replay):
        pass

    def step(self, j):
        c = float(self.ba.cost(self.on_device[j]))
        return {"failed": 0 if math.isfinite(c) else 1, "cost": c}

    @staticmethod
    def stratum(j, out):
        return "solve"

    def check(self, held):
        ref = self.bench.module("reference", "test_ba/check")
        gap = max((abs(out["cost"] - ref.cost(self.problems[j]))
                   / ref.cost(self.problems[j]) for j, out in held),
                  default=0.0)
        return {"cost_gap": {"value": gap,
                             "limit": self.r["settings"]["limits"]["cost_gap"]},
                "uncovered": {"value": 0 if held else 1, "limit": 0}}
'''

# the reference, and a file beside it that has the VO reference helper's
# name on purpose
TOY_CHECK = '''"""The toy kind's reference: numpy's reprojection cost."""

import numpy as np

from vo_ref import project


def cost(p):
    Xc = np.einsum("pvij,pj->pvi", p["R"][p["obs_view"]], p["points"])
    Xc = Xc + p["t"][p["obs_view"]]
    r = project(Xc, p["intr"][p["obs_view"]]) - p["obs_xy"]
    r = np.where(p["obs_valid"][..., None], r, 0.0)
    return 0.5 * float(np.sum(r * r))
'''
TOY_HELPER = '''"""BAL's camera: p = -X/z, f (1 + k1 |p|^2 + k2 |p|^4) p."""

import numpy as np

WHOSE = "toy"


def project(Xc, intr):
    p = -Xc[..., :2] / Xc[..., 2:3]
    r2 = np.sum(p * p, -1)
    s = 1.0 + intr[..., 1] * r2 + intr[..., 2] * r2 * r2
    return (intr[..., 0] * s)[..., None] * p
'''
TOY_FAULT = '''"""Fault: one point moved by 1e-3 where the cost reads it."""


def apply(port):
    ba = port.ba
    orig = ba.cost

    def broken(prob):
        points = prob.points.clone()
        points[0] += 1e-3
        return orig(prob._replace(points=points))

    ba.cost = broken

    def undo():
        ba.cost = orig
    return undo
'''
TOY_CONFIG = {"name": "test.ba_cost", "kind": "test.ba_cost", "views": 4,
              "points": 40, "dtype": "float64"}


def _put(root, rel, body):
    path = os.path.join(root, "perfbench", rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(body if isinstance(body, str) else json.dumps(body))


@pytest.fixture(scope="module")
def toy_root(tiny_root, tmp_path_factory):
    """The tiny VO cells' folder, and the toy kind added as files alone."""
    root = str(tmp_path_factory.mktemp("toy"))
    shutil.copytree(tiny_root, root, dirs_exist_ok=True)
    _put(root, "kinds/test.ba_cost.py", TOY_KIND)
    _put(root, "reference/test_ba/check.py", TOY_CHECK)
    _put(root, "reference/test_ba/vo_ref.py", TOY_HELPER)
    _put(root, "faults/test.ba_point.py", TOY_FAULT)
    _put(root, "configs/test.ba_cost.json", TOY_CONFIG)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        s = json.load(f)
    s["configs"].append({"name": "test.ba_cost", "source": "the tests",
                         "file": "perfbench/configs/test.ba_cost.json",
                         "reduced": [], "why": "a kind added as files"})
    for name, faults in (("ba.tiny", []), ("ba.tiny.point",
                                           ["test.ba_point"])):
        _put(root, f"traffic/{name}.json", {"solves_per_replay": 8})
        _put(root, f"workloads/{name}.json", {
            "check": {"steps": 4}, "faults": faults,
            "limits": {"cost_gap": 1e-12, "failed_share": 0.01}})
        s["workloads"].append({"name": name, "config": "test.ba_cost",
                               "traffic": name, "chips": 1,
                               "why": "a test cell of the toy kind"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(s, f)
    return root


def _run(root, name, seed=2 ** 32 + 5):
    return cell.run(spec.Benchmark(root), name, seed, 1.5, False, 0.0,
                    device="cpu")


def test_a_kind_added_as_files_validates(toy_root):
    bench = spec.Benchmark(toy_root)
    assert bench.validate() == []
    r = bench.resolve("ba.tiny")
    assert r["driver"] is None and hasattr(r["kind"], "Cell")


def test_a_kind_added_as_files_runs_and_is_correct(toy_root):
    res = _run(toy_root, "ba.tiny")
    vo = _run(toy_root, "tiny.single")
    assert res["correct"], res["checks"]
    assert list(res) == list(vo)
    assert set(res["metrics"]) == set(vo["metrics"]) == {"frame_p95_ms",
                                                         "setup_s"}
    assert set(res["device"]) == set(vo["device"])
    assert res["attempted"] > 8 and res["failed"] == 0
    assert list(res["checks"]) == ["cost_gap", "uncovered", "failed_share"]
    assert res["checks"]["cost_gap"]["value"] <= 1e-12


def test_a_kind_fault_is_caught(toy_root):
    from boofcv_tpu_torch.geo import ba
    before = ba.cost
    res = _run(toy_root, "ba.tiny.point")
    assert not res["correct"], res["checks"]
    assert res["checks"]["cost_gap"]["value"] > 1e-9
    assert ba.cost is before


@pytest.mark.parametrize("kind", [None, "no_such_kind"])
def test_a_config_without_its_kind_is_reported(toy_root, tmp_path, kind):
    shutil.copytree(toy_root, tmp_path, dirs_exist_ok=True)
    config = dict(TOY_CONFIG)
    if kind is None:
        del config["kind"]
    else:
        config["kind"] = kind
    _put(str(tmp_path), "configs/test.ba_cost.json", config)
    bad = spec.Benchmark(str(tmp_path)).validate()
    assert bad and all("ba.tiny" in b for b in bad), bad
    why = "names no kind" if kind is None else "missing file"
    assert all(why in b for b in bad), bad
    if kind is not None:
        assert all("no_such_kind.py" in b for b in bad), bad


def test_two_kinds_references_of_one_name_do_not_shadow(toy_root):
    before = sys.modules.get("vo_ref")
    for order in (("check", "test_ba/check"), ("test_ba/check", "check")):
        bench = spec.Benchmark(toy_root)
        mods = {n: bench.module("reference", n) for n in order}
        vo, toy = mods["check"], mods["test_ba/check"]
        assert vo is not toy
        assert os.path.dirname(toy.__file__) == os.path.join(
            toy_root, "perfbench", "reference", "test_ba")
        assert toy.project.__module__ == "vo_ref"
        assert toy.project.__globals__["WHOSE"] == "toy"
        assert "WHOSE" not in vo.refine_pose.__globals__
        assert sys.modules.get("vo_ref") is before
    # both kinds' checks, in one process, pass a sound run
    assert _run(toy_root, "ba.tiny")["correct"]
    assert _run(toy_root, "tiny.single")["correct"]
