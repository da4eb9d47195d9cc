"""Uncalibrated "stereo" from three views: trifocal tensor,
self-calibration and a metric bundle (port of
``boofcv_tpu/examples/trifocal_uncalibrated_stereo.py``).

Reference analog: examples/stereo/ExampleTrifocalStereoUncalibrated.java —
three uncalibrated views of one scene give a metric reconstruction, focal
included.  Oracle: the focal within 10 % and the ratio of camera-centre
distances kept.

    python -m boofcv_tpu_torch.examples.trifocal_uncalibrated_stereo [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.geo import se3
from boofcv_tpu_torch.sfm import three_view


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))

    rng = np.random.default_rng(0)
    f_true = 400.0
    h, w = 480, 640
    K = np.array([[f_true, 0, (w - 1) / 2], [0, f_true, (h - 1) / 2],
                  [0, 0, 1.0]])
    X = np.concatenate([rng.uniform(-2, 2, (150, 2)),
                        rng.uniform(5, 9, (150, 1))], 1)
    views, Rs, ts = [], [], []
    for v in range(3):
        R = se3.exp_so3(torch.from_numpy(rng.normal(0, 0.04, 3))).numpy()
        t = np.array([0.5 * v, 0.05 * v, 0.02 * v])
        Rs.append(R)
        ts.append(t)
        px = (X @ R.T + t) @ K.T
        views.append(px[:, :2] / px[:, 2:] + rng.normal(0, 0.2, (150, 2)))

    res = three_view.estimate_metric_scene(*views, (h, w),
                                           num_hypotheses=192, device=dev)
    f_est = 0.5 * (res.K[0, 0] + res.K[1, 1])
    c_gt = np.stack([-Rs[i].T @ ts[i] for i in range(3)])
    c_est = np.stack([-res.Rs[i].T @ res.ts[i] for i in range(3)])
    r_gt = np.linalg.norm(c_gt[2] - c_gt[0]) / np.linalg.norm(
        c_gt[1] - c_gt[0])
    r_est = np.linalg.norm(c_est[2] - c_est[0]) / np.linalg.norm(
        c_est[1] - c_est[0])
    print(f"device: {dev}")
    print(f"inliers: {int(res.inliers.sum())}/150, focal {f_est:.1f} "
          f"(true {f_true}), center-distance ratio {r_est:.3f} "
          f"(true {r_gt:.3f})")
    ok = (res.inliers.sum() > 100 and abs(f_est - f_true) / f_true < 0.1
          and abs(r_est - r_gt) < 0.1)
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
