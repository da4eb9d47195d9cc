"""The control on the card at the cell's own size: the program with the
precision below the stated one (TF32 products, the reference's pose in
TF32 in the refine's place, bfloat16 on the image path) must come out not
correct, on three seeds; the program itself, on the same settings,
correct.  Marked ``cuda``: it skips without a card.  On the CPU: the
control's pose is the reference's, rounded as TF32 rounds."""

import os
import sys

import numpy as np
import pytest
import torch

import control
from harness import spec

from conftest import BENCH, ROOT

sys.path.insert(0, os.path.join(BENCH, "reference"))
import vo_ref  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["vo640.single", "kitti.fleet16"])
def test_control_fails_and_program_passes(cuda_device, workload):
    bench = spec.Benchmark(ROOT)
    program = control.readings(bench, workload, 8.0, [2 ** 31 + 11], False,
                               control.DEFAULT)
    lower = control.readings(bench, workload, 8.0,
                             [2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23],
                             True, control.DEFAULT)
    assert all(r["correct"] for r in program), program
    assert not any(r["correct"] for r in lower), lower


def test_control_on_the_cpu_fails_the_image_path(tiny_root):
    bench = spec.Benchmark(tiny_root)
    res = control.readings(bench, "tiny.single", 1.5, [5], True,
                           control.DEFAULT, device="cpu")
    assert not res[0]["correct"]
    assert res[0]["numbers"]["template_gap"] > 0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    tf32 = spec.Benchmark(ROOT).module("controls", "ref_pose_tf32")._tf32
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11 + 2.0 ** -12,
                      1.0 + 2.0 ** -12, -3.0])
    assert tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                                -3.0]


def test_control_pose_is_the_reference_in_tf32():
    ref_pose = spec.Benchmark(ROOT).module("controls",
                                           "ref_pose_tf32").refine_pose
    rng = np.random.default_rng(5)
    world = rng.uniform([-3, -2, 6], [3, 2, 10], (400, 3))
    R = vo_ref._exp_so3(np.array([0.01, -0.02, 0.005]))
    t = np.array([0.1, -0.05, 0.2])
    obs = vo_ref.project(R, t, world) + rng.normal(0, 1e-3, (400, 2))
    Rr, tr = vo_ref.refine_pose(np.eye(3), np.zeros(3), world, obs)
    T = lambda a: torch.tensor(np.stack([a, a]))        # two streams
    weights = torch.ones(2, 400, dtype=torch.float64)
    Rc, tc = ref_pose(T(np.eye(3)), T(np.zeros(3)), T(world), T(obs),
                      weights=weights)
    gap = max(np.abs(Rc[0].numpy() - Rr).max(), np.abs(tc[0].numpy()
                                                         - tr).max())
    assert Rc.dtype == torch.float64 and torch.equal(Rc[0], Rc[1])
    assert 1e-6 < gap < 1e-2
