"""Calibrate a fisheye camera with the universal-omni model (port of
``boofcv_tpu/examples/fisheye_calibration.py``).

Reference analog: examples/calibration/ExampleCalibrateFisheye.java —
Zhang99 with the universal-omni (mirror-offset) camera.  Oracle: synthetic
wide-FOV captures of a planar target recover focal and the mirror offset.
The JAX example's ``--tpu`` flag and ``setup_backend`` have no counterpart:
``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.fisheye_calibration [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.calib import zhang99
from boofcv_tpu_torch.examples import parse_device

FX, FY, CX, CY = 260.0, 258.0, 320.0, 240.0
XI = 0.9                                           # strong fisheye


def _scene():
    """(target points [N, 2], noisy observations [12, N, 2]) of the JAX
    example."""
    rng = np.random.default_rng(6)
    nx, ny = 7, 5
    world = np.stack(np.meshgrid(np.arange(nx) * 0.04,
                                 np.arange(ny) * 0.04), -1).reshape(-1, 2)

    def project(R, t):
        Xc = np.c_[world, np.zeros(len(world))] @ R.T + t
        s = Xc / np.linalg.norm(Xc, axis=1, keepdims=True)
        z = s[:, 2] + XI
        return np.stack([FX * s[:, 0] / z + CX, FY * s[:, 1] / z + CY], 1)

    obs = []
    for v in range(12):
        w = rng.uniform(-0.5, 0.5, 3)
        th = np.linalg.norm(w)
        kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                       [-w[1], w[0], 0]]) / max(th, 1e-9)
        R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
        t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.08, 0.08),
                      rng.uniform(0.35, 0.6)])
        obs.append(project(R, t) + rng.normal(0, 0.25, (len(world), 2)))
    return world, np.stack(obs)


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    world, obs = _scene()
    res = zhang99.calibrate_mono_omni(world, obs, device=dev)
    print(f"device: {dev}")
    # fx and xi are correlated for planar targets in a modest FOV — the
    # well-conditioned combination is the ratio fx/(1+xi) (the effective
    # perspective focal near the axis), which is what downstream
    # undistortion consumes
    eff = res.K[0, 0] / (1.0 + res.mirror_offset)
    eff_true = FX / (1.0 + XI)
    print(f"fx {res.K[0, 0]:.1f}, mirror offset {res.mirror_offset:.3f} "
          f"(true {FX}, {XI}); effective f {eff:.1f} vs {eff_true:.1f}; "
          f"reproj rmse {res.reprojection_rmse:.3f} px")
    ok = (abs(eff - eff_true) / eff_true < 0.03
          and abs(res.mirror_offset - XI) < 0.3
          and res.reprojection_rmse < 0.6)
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
