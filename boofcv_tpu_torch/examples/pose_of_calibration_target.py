"""6-DOF pose of a chessboard calibration target (port of
``boofcv_tpu/examples/pose_of_calibration_target.py``).

Reference analog: examples/calibration/ExamplePoseOfCalibrationTarget
.java — detect the target's corners, then PnP against its known planar
geometry.  Oracle: rendered board at a known pose; recovered range and
rotation match.

    python -m boofcv_tpu_torch.examples.pose_of_calibration_target [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.geo import robust
from boofcv_tpu_torch.recognition import chessboard


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    rows, cols, sq_m = 4, 5, 0.04          # inner corners, 4 cm squares
    f = 260.0
    H, W = 240, 320
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    # target plane in camera frame
    w_pts = np.stack(np.meshgrid(np.arange(cols) * sq_m,
                                 np.arange(rows) * sq_m), -1).reshape(-1, 2)
    w_pts -= w_pts.mean(0)
    world = np.c_[w_pts, np.zeros(len(w_pts))]
    a = 0.35
    R_gt = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]])
    t_gt = np.array([0.02, -0.01, 0.6])

    # render the board: project the square grid
    img = np.full((H, W), 200.0, np.float32)
    n_sq_y, n_sq_x = rows + 1, cols + 1
    ys, xs = np.mgrid[0:H, 0:W]
    for r in range(n_sq_y):
        for c in range(n_sq_x):
            if (r + c) % 2:
                continue
            y0 = (r - n_sq_y / 2) * sq_m
            x0 = (c - n_sq_x / 2) * sq_m
            quad = np.array([[x0, y0, 0], [x0 + sq_m, y0, 0],
                             [x0 + sq_m, y0 + sq_m, 0], [x0, y0 + sq_m, 0]])
            pc = quad @ R_gt.T + t_gt
            px = ((pc / pc[:, 2:]) @ K.T)[:, :2]
            # point-in-convex-quad via edge cross products
            inside = np.ones((H, W), bool)
            for i in range(4):
                ax, ay = px[i]
                bx, by = px[(i + 1) % 4]
                inside &= ((bx - ax) * (ys - ay)
                           - (by - ay) * (xs - ax)) >= 0
            img[inside] = 30.0

    pts = chessboard.detect_chessboard(img, rows, cols, device=dev)
    print(f"device: {dev}")
    if pts is None:
        print("FAILED (no board)")
        return 1
    # PnP against the known grid (corner ordering from the detector is a
    # row-major lattice up to 180-deg flip — try both)
    obs = (np.c_[pts, np.ones(len(pts))] @ np.linalg.inv(K).T)[:, :2]
    best = None
    for cand in (world, world[::-1]):
        gen = torch.Generator(device=dev).manual_seed(0)
        res, (R, t) = robust.ransac_pnp(
            gen, torch.as_tensor(cand.copy(), device=dev),
            torch.as_tensor(obs, device=dev), num_hypotheses=128,
            inlier_threshold=1e-4)
        n_inl = int(res.num_inliers)
        if best is None or n_inl > best[0]:
            best = (n_inl, R.cpu().numpy(), t.cpu().numpy())
    n_inl, R, t = best
    rng_err = abs(np.linalg.norm(t) - np.linalg.norm(t_gt))
    ang = np.degrees(np.arccos(np.clip((np.trace(R.T @ R_gt) - 1) / 2,
                                       -1, 1)))
    print(f"inliers {n_inl}/{rows * cols}; range "
          f"{np.linalg.norm(t):.3f} m (true {np.linalg.norm(t_gt):.3f}); "
          f"rotation error {ang:.2f} deg (180-flip ambiguity resolved "
          f"by inlier vote)")
    ok = n_inl >= rows * cols - 2 and rng_err < 0.01 \
        and (ang < 3.0 or abs(ang - 180.0) < 3.0)
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
