"""The whole run on the CPU at a tiny size, the chip's look skipped: the
reference's check passes the program and fails each fault the cells can
have (a step that returns its state unchanged, half of a fleet's streams
left out, a pose altered where the refine produces it, every track
retired each step, every track lost by the KLT)."""

import os
import sys

import numpy as np
import pytest

from harness import cell, spec

from conftest import BENCH, FAULTS

sys.path.insert(0, os.path.join(BENCH, "reference"))
import vo_ref  # noqa: E402


def _run(root, name):
    return cell.run(spec.Benchmark(root), name, 2 ** 32 + 7, 1.5, False,
                    0.0, device="cpu")


@pytest.mark.parametrize("traffic", ["tiny.single", "tiny.fleet"])
def test_sound_run_is_correct(tiny_root, traffic):
    res = _run(tiny_root, traffic)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"frame_p95_ms", "setup_s"}
    assert list(res)[-1] == "checks"
    assert res["checks"]["uncovered"]["value"] == 0
    assert res["checks"]["failed_share"]["value"] == 0
    assert res["checks"]["wrongly_retired"]["value"] < 0.05


@pytest.mark.parametrize("name", [f"{t}.{f}" for t, fs in FAULTS.items()
                                  for f in fs])
def test_fault_is_caught(tiny_root, name):
    res = _run(tiny_root, name)
    assert not res["correct"], res["checks"]


def test_faults_leave_the_port_as_it_was(tiny_root):
    from boofcv_tpu_torch.feature import klt
    from boofcv_tpu_torch.geo import pnp, robust
    from boofcv_tpu_torch.sfm import stereo_vo
    now = lambda: (pnp.gauss_newton_pose, stereo_vo.make_step,
                   stereo_vo.make_batched_step, robust.ransac_pnp,
                   klt.track_pyramid)
    before = now()
    for name in ("tiny.fleet.half_batch", "tiny.single.pose_altered",
                 "tiny.single.retire_all", "tiny.single.klt_lost"):
        _run(tiny_root, name)
    assert now() == before


def test_retired_tracks_are_judged_by_the_reference(tiny_root):
    res = _run(tiny_root, "tiny.fleet.retire_all")
    assert res["checks"]["wrongly_retired"]["value"] == 1.0
    assert res["checks"]["failed_share"]["value"] == 0


def test_unusable_poses_are_counted(tiny_root):
    res = _run(tiny_root, "tiny.single.klt_lost")
    assert res["failed"] > 0
    assert res["checks"]["failed_share"]["value"] == (res["failed"]
                                                      / res["attempted"])


def test_robust_pose_sets_gross_outliers_aside():
    rng = np.random.default_rng(3)
    world = rng.uniform([-3, -2, 6], [3, 2, 10], (300, 3))
    R = vo_ref._exp_so3(np.array([0.01, -0.02, 0.005]))
    t = np.array([0.1, -0.05, 0.2])
    obs = vo_ref.project(R, t, world)
    obs[:30] += rng.uniform(-0.05, 0.05, (30, 2))      # 30 gross outliers
    Rr, tr = vo_ref.robust_pose(np.eye(3), np.zeros(3), world, obs, 1.5,
                                480.0)
    err = vo_ref.reprojection_px(Rr, tr, world, obs, 480.0)
    assert np.abs(Rr - R).max() < 1e-9 and np.abs(tr - t).max() < 1e-9
    assert (err[30:] < 1e-6).all() and (err[:30] > 3.0).sum() >= 28
