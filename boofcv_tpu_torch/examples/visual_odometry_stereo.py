"""Stereo visual odometry, the flagship pipeline (port of
``boofcv_tpu/examples/visual_odometry_stereo.py``).

Reference analog: examples/sfm/ExampleVisualOdometryStereo.java — the
PixelDepth+PnP state machine (KLT tracking through ``klt_track``, sparse
stereo depth through ``window_gather``, RANSAC-P3P, refine) as one
per-frame step.  Oracle: the simulated forward trajectory is recovered
with small absolute error (the JAX example's bar).  The JAX example's
``--tpu`` flag and ``setup_backend`` have no counterpart: ``--device``
picks the device.

    python -m boofcv_tpu_torch.examples.visual_odometry_stereo [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.geo import se3
from boofcv_tpu_torch.io import simulate
from boofcv_tpu_torch.sfm import stereo_vo

H, W = 120, 160
K = np.array([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1.0]])
BASELINE = 0.3


def _scene():
    """(world->left poses [(R, t)], [(left, right)] float32 frames): the
    JAX example's eight-frame forward creep with slow yaw."""
    rng = np.random.default_rng(0)
    poses = []
    for i in range(8):
        R = se3.exp_so3(torch.tensor([0.0, 0.004 * i, 0.0],
                                     dtype=torch.float64)).numpy()
        c = np.array([0.015 * i, 0.0, 0.06 * i])
        poses.append((R, -R @ c))
    return poses, simulate.render_stereo_sequence(rng, K, BASELINE, poses,
                                                  H, W)


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    poses, frames = _scene()
    cfg = stereo_vo.StereoVoConfig(
        num_tracks=256, pyramid_scales=(1, 2, 4), max_disparity=48,
        ransac_hypotheses=192, detect_radius=4)
    vo = stereo_vo.StereoVisualOdometry(cfg, K, BASELINE, H, W, device=dev)
    print(f"device: {dev}")
    errs = []
    for (left, right), (Rgt, tgt) in zip(frames, poses):
        if not vo.process(left, right):
            print("FAILED (motion estimation)")
            return 1
        _, c_est = vo.camera_to_world()
        errs.append(np.linalg.norm(c_est - (-Rgt.T @ tgt)))
    total = np.linalg.norm(-poses[-1][0].T @ poses[-1][1])
    print(f"frames: {len(frames)}, ATE {np.mean(errs):.4f} m over a "
          f"{total:.2f} m trajectory; inliers "
          f"{vo.metrics.get('inliers', 0)}")
    ok = np.mean(errs) < 0.05 * max(total, 0.1)
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
