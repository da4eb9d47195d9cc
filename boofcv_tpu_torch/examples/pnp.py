"""Estimate camera pose from 2D-3D correspondences (PnP) (port of
``boofcv_tpu/examples/pnp.py``).

Reference analog: examples/sfm/ExamplePnP.java — P3P + RANSAC on noisy
correspondences with outliers, then nonlinear refinement.  Ground-truth pose
is known, so rotation/translation errors are printed and checked. RANSAC
draws its samples from a seeded ``torch.Generator`` where the JAX example
uses ``jax.random.PRNGKey(0)``, so the pose is held to the truth, not to the
JAX run's numbers. The JAX example's ``--tpu`` flag and ``setup_backend``
have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.pnp [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.geo import robust, se3

FOCAL = 500.0
T_GT = np.array([0.3, -0.2, 0.5])


def _scene():
    """(world [120, 3], normalized observations [120, 2], R_gt, bad): 0.5 px
    noise and 25 % outliers, as the JAX example draws them."""
    rng = np.random.default_rng(9)
    n = 120
    world = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                      rng.uniform(4, 10, n)], 1)
    R_gt = se3.exp_so3(torch.tensor([0.05, -0.1, 0.08],
                                    dtype=torch.float64)).numpy()
    pc = world @ R_gt.T + T_GT
    obs = pc[:, :2] / pc[:, 2:]                       # normalized coords
    obs += rng.normal(0, 0.5 / FOCAL, obs.shape)      # ~0.5 px noise
    bad = rng.random(n) < 0.25
    obs[bad] += rng.uniform(-0.1, 0.1, (int(bad.sum()), 2))
    return world, obs, R_gt, bad


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    world, obs, R_gt, bad = _scene()
    n = len(world)
    gen = torch.Generator(device=dev).manual_seed(0)
    res, (R, t) = robust.ransac_pnp(
        gen, torch.as_tensor(world, device=dev),
        torch.as_tensor(obs, device=dev), num_hypotheses=256,
        inlier_threshold=(2.0 / FOCAL) ** 2, refine_iterations=10)
    R = R.cpu().numpy()
    t = t.cpu().numpy()
    print(f"device: {dev}")
    rot_err = np.degrees(float(se3.rotation_angle(
        torch.from_numpy(R.T @ R_gt))))
    t_err = float(np.linalg.norm(t - T_GT))
    inl = res.inliers.cpu().numpy()
    print(f"inliers: {int(inl.sum())}/{n} "
          f"(true outliers excluded: {int((~inl[bad]).sum())}/{int(bad.sum())})")
    print(f"rotation error: {rot_err:.4f} deg, translation error: {t_err:.4f}")
    ok = rot_err < 0.1 and t_err < 0.01 and not inl[bad].any()
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
