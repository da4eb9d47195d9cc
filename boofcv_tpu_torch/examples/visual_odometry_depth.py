"""RGB-D visual odometry over a simulated depth-sensor sequence (port of
``boofcv_tpu/examples/visual_odometry_depth.py``).

Reference analog: examples/sfm/ExampleVisualOdometryDepth.java — the
PixelDepth+PnP VO state machine (KLT through ``klt_track``) fed by a
registered depth image instead of sparse stereo.  Oracle: recovered camera
centres track the simulated forward trajectory.  The JAX example's
``--tpu`` flag and ``setup_backend`` have no counterpart: ``--device``
picks the device.

    python -m boofcv_tpu_torch.examples.visual_odometry_depth [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.geo import se3
from boofcv_tpu_torch.io import simulate
from boofcv_tpu_torch.sfm import depth_vo, stereo_vo

H, W = 120, 160
K = np.array([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1.0]])


def _scene():
    """(world->camera poses [(R, t)], [(gray, depth)] float32 frames) of
    the JAX example: a textured plane and its exact depth."""
    rng = np.random.default_rng(0)
    tex = simulate.noise_texture(rng)
    o = np.array([0.0, 0.0, 6.0])
    ex = np.array([1.0, 0.0, 0.0])
    ey = np.array([0.0, 1.0, -0.15])
    n = np.cross(ex, ey)
    n /= np.linalg.norm(n)
    poses, frames = [], []
    Kinv = np.linalg.inv(K)
    ys, xs = np.mgrid[0:H, 0:W].astype(float)
    for i in range(6):
        R = se3.exp_so3(torch.tensor([0.0, 0.003 * i, 0.0],
                                     dtype=torch.float64)).numpy()
        c = np.array([0.01 * i, 0.0, 0.05 * i])
        t = -R @ c
        poses.append((R, t))
        gray = simulate.render_plane(tex, K, R, t, H, W,
                                     plane_origin=tuple(o),
                                     plane_x=tuple(ex), plane_y=tuple(ey))
        rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ Kinv.T
        d_w = rays @ R
        denom = d_w @ n
        s = ((o - c) @ n) / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        Xc = ((c + s[..., None] * d_w) @ R.T) + t
        depth = np.where(s > 0, Xc[..., 2], 0.0).astype(np.float32)
        frames.append((gray, depth))
    return poses, frames


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    poses, frames = _scene()
    cfg = stereo_vo.StereoVoConfig(num_tracks=256, pyramid_scales=(1, 2, 4),
                                   detect_radius=4)
    vo = depth_vo.DepthVisualOdometry(cfg, K, H, W, device=dev)
    print(f"device: {dev}")
    errs = []
    for (gray, depth), (Rgt, tgt) in zip(frames, poses):
        ok = vo.process(gray, depth)
        _, c_est = vo.camera_to_world()
        errs.append(np.linalg.norm(c_est - (-Rgt.T @ tgt)))
        if not ok:
            print("FAILED (lost pose)")
            return 1
    print(f"frames: {len(frames)}, final center error: {errs[-1]:.4f} m "
          f"(trajectory length {np.linalg.norm(poses[-1][1]):.2f} m)")
    ok = errs[-1] < 0.05
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
