"""Robustly estimate the fundamental matrix between two views (port of
``boofcv_tpu/examples/fundamental_matrix.py``).

Reference analog: examples/stereo/ExampleFundamentalMatrix.java — associated
points + RANSAC 7-pt F, inlier set, then non-robust 8-pt on the inliers.
Here the correspondences come from a synthetic two-view scene with a known F
(20% gross outliers injected), so the result is checkable: the recovered F
must satisfy the epipolar constraint on the true inliers. RANSAC draws its
samples from a seeded ``torch.Generator`` where the JAX example uses
``jax.random.PRNGKey(0)``, so the inlier set is held to the truth, not to
the JAX run's numbers. The JAX example's ``--tpu`` flag and
``setup_backend`` have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.fundamental_matrix [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.geo import robust, se3

K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1.0]])
T = np.array([0.8, 0.05, 0.1])


def _scene():
    """(R, p1, p2, bad): 200 points seen from two cameras, 0.3 px noise and
    20 % gross outliers (``bad``), as the JAX example draws them."""
    rng = np.random.default_rng(3)
    n = 200
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 9, n)], 1)
    R = se3.exp_so3(torch.tensor([0.02, -0.25, 0.01],
                                 dtype=torch.float64)).numpy()

    def project(P, R, t):
        pc = P @ R.T + t
        return (pc / pc[:, 2:]) @ K.T
    p1 = project(pts, np.eye(3), np.zeros(3))[:, :2]
    p2 = project(pts, R, T)[:, :2]
    p1 += rng.normal(0, 0.3, p1.shape)
    p2 += rng.normal(0, 0.3, p2.shape)
    bad = rng.random(n) < 0.2
    p2[bad] += rng.uniform(-80, 80, (bad.sum(), 2))
    return R, p1, p2, bad


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    R, p1, p2, bad = _scene()
    n = len(p1)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = robust.ransac_fundamental(
        gen, torch.as_tensor(p1, device=dev), torch.as_tensor(p2, device=dev),
        num_hypotheses=512, inlier_threshold_px=1.5)
    F = res.model[0].cpu().numpy()
    inliers = res.inliers.cpu().numpy()
    print(f"device: {dev}")
    # ground-truth F from E = [t]x R
    t = T
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    F_gt = np.linalg.inv(K).T @ (tx @ R) @ np.linalg.inv(K)
    F_gt /= np.linalg.norm(F_gt)
    Fn = F / np.linalg.norm(F)
    if np.sum(Fn * F_gt) < 0:
        Fn = -Fn
    err = float(np.abs(Fn - F_gt).max())
    n_in = int(inliers.sum())
    recall = float(inliers[~bad].mean())
    print(f"inliers: {n_in}/{n} (true inlier recall {recall:.2f})")
    print(f"|F - F_gt|_max (unit norm): {err:.2e}")
    ok = recall > 0.9 and err < 0.05 and not inliers[bad].any()
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
