"""Monocular plane-VO: metric motion from one camera and a known ground
plane (port of ``boofcv_tpu/examples/visual_odometry_mono_plane.py``).

Reference analog: examples/sfm/ExampleVisualOdometryMonocularPlane.java
— homography tracking (KLT through ``klt_track``) against a plane of known
orientation and height makes monocular motion metric.  Oracle: recovered
centres match the simulated translation parallel to the plane.  The JAX
example's ``--tpu`` flag and ``setup_backend`` have no counterpart:
``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.visual_odometry_mono_plane [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.io import simulate
from boofcv_tpu_torch.sfm import mono_plane_vo

H, W = 120, 160
K = np.array([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1.0]])


def _scene():
    """(world->camera poses [(R, t)], float32 frames) of the JAX example: a
    camera sliding over a plane 4 m ahead."""
    rng = np.random.default_rng(0)
    tex = simulate.noise_texture(rng)
    poses = []
    for i in range(5):
        R = np.eye(3)
        c = np.array([0.06 * i, 0.02 * i, 0.0])
        poses.append((R, -R @ c))
    frames = [simulate.render_plane(tex, K, R, t, H, W,
                                    plane_origin=(0.0, 0.0, 4.0),
                                    plane_x=(1.0, 0.0, 0.0),
                                    plane_y=(0.0, 1.0, 0.0),
                                    texture_scale=45.0)
              for R, t in poses]
    return poses, frames


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    poses, frames = _scene()
    vo = mono_plane_vo.MonoPlaneVisualOdometry(
        K, plane_normal=(0.0, 0.0, 1.0), plane_distance=4.0,
        num_tracks=200, device=dev)
    print(f"device: {dev}")
    errs = []
    for frame, (Rgt, tgt) in zip(frames, poses):
        if not vo.process(frame):
            print("FAILED (motion estimation)")
            return 1
        _, c = vo.camera_to_world()
        errs.append(np.linalg.norm(c - (-Rgt.T @ tgt)))
    print(f"frames: {len(frames)}, final center error {errs[-1]:.4f} m "
          "(metric scale from the known plane height)")
    ok = errs[-1] < 0.05
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
