"""Stereo rig calibration from planar-target views (port of
``boofcv_tpu/examples/stereo_calibration.py``).

Reference analog: examples/calibration/ExampleCalibrateStereo.java /
applications CameraCalibration — Zhang99 per camera + relative-pose
averaging.  Oracle: synthetic rig with known intrinsics/baseline is
recovered within tolerance. The JAX example's ``--tpu`` flag and
``setup_backend`` have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.stereo_calibration [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.calib import zhang99
from boofcv_tpu_torch.examples import parse_device

K_L = np.array([[460.0, 0, 320.0], [0, 455.0, 240.0], [0, 0, 1.0]])
K_R = np.array([[450.0, 0, 316.0], [0, 452.0, 236.0], [0, 0, 1.0]])
T_RIG = np.array([-0.12, 0.0, 0.0])        # 12 cm baseline


def _scene():
    """(target points [N, 2], left [14, N, 2], right [14, N, 2]) of the JAX
    example: 14 views of a 7x5 grid through a rig with radial
    distortion and 0.2 px noise."""
    rng = np.random.default_rng(4)
    nx, ny = 7, 5
    world = np.stack(np.meshgrid(np.arange(nx) * 0.03,
                                 np.arange(ny) * 0.03), -1).reshape(-1, 2)
    R_rig = np.eye(3)

    def project(K, R, t, k1=0.0):
        Xc = np.c_[world, np.zeros(len(world))] @ R.T + t
        xn = Xc[:, :2] / Xc[:, 2:]
        r2 = (xn ** 2).sum(1)
        xd = xn * (1 + k1 * r2)[:, None]
        return xd @ K[:2, :2].T + K[:2, 2]

    obs_l, obs_r = [], []
    for v in range(14):
        w = rng.uniform(-0.45, 0.45, 3)
        th = np.linalg.norm(w)
        kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                       [-w[1], w[0], 0]]) / max(th, 1e-9)
        R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
        t = np.array([rng.uniform(-0.08, 0.08), rng.uniform(-0.06, 0.06),
                      rng.uniform(0.5, 0.8)])
        obs_l.append(project(K_L, R, t, -0.2)
                     + rng.normal(0, 0.2, (len(world), 2)))
        obs_r.append(project(K_R, R_rig @ R, R_rig @ t + T_RIG, -0.15)
                     + rng.normal(0, 0.2, (len(world), 2)))
    return world, np.stack(obs_l), np.stack(obs_r)


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    world, obs_l, obs_r = _scene()
    left, right, R_l2r, t_l2r = zhang99.calibrate_stereo_planar(
        world, obs_l, obs_r, device=dev)
    print(f"device: {dev}")
    base_err = abs(np.linalg.norm(t_l2r) - np.linalg.norm(T_RIG))
    fx_err = abs(left.K[0, 0] - K_L[0, 0])
    print(f"left fx {left.K[0, 0]:.1f} (true {K_L[0, 0]}), right fx "
          f"{right.K[0, 0]:.1f} (true {K_R[0, 0]})")
    print(f"baseline {np.linalg.norm(t_l2r) * 100:.2f} cm (true "
          f"{np.linalg.norm(T_RIG) * 100:.0f} cm), reproj rmse "
          f"{left.reprojection_rmse:.3f}/{right.reprojection_rmse:.3f} px")
    ok = fx_err < 8.0 and base_err < 0.005 \
        and left.reprojection_rmse < 0.5
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
