"""Metric reconstruction from unordered views with UNKNOWN intrinsics (port
of ``boofcv_tpu/examples/uncalibrated_reconstruction.py``).

Reference analog: the structure2 pipeline
(alg/sfm/structure2/GeneratePairwiseImageGraph.java and friends) —
pairwise graph with 3D-vs-homography model scores, self-calibration, PnP
growth, global bundle adjustment.  No calibration is given; the focal
length is recovered and checked against the ground truth.  ``--mesh``
fans the pairwise fits out over the ranks of ``dist.make_mesh`` (every rank
of a ``torchrun`` job runs the demo; alone, a one-rank group).

    python -m boofcv_tpu_torch.examples.uncalibrated_reconstruction [--device cpu|cuda] [--mesh]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.dist import make_mesh
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.geo import se3
from boofcv_tpu_torch.sfm import structure2
from boofcv_tpu_torch.sfm.reconstruction import ImageFeatures


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(parse_device(argv))
    mesh = None
    if "--mesh" in argv:
        mesh = make_mesh(device=dev)
        print(f"pairwise matching fanned over {mesh.size()} ranks")

    rng = np.random.default_rng(24)
    H, W, f = 240, 320, 270.0
    n_views, n_points = 5, 140
    pts = np.stack([rng.uniform(-2, 2, n_points),
                    rng.uniform(-1.5, 1.5, n_points),
                    rng.uniform(5, 9, n_points)], 1)
    desc = rng.normal(0, 1, (n_points, 64))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    K = np.array([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1.0]])

    poses, feats = [], []
    for v in range(n_views):
        R = se3.exp_so3(torch.from_numpy(rng.normal(0, 0.03, 3))).numpy()
        c = np.array([0.5 * v, 0.3 * (v % 2), 0.2 * ((v // 2) % 2)])
        t = -R @ c
        poses.append((R, t))
        pc = pts @ R.T + t
        pr = (pc / pc[:, 2:]) @ K.T
        vis = ((pr[:, :2] > 6) & (pr[:, :2] < [W - 6, H - 6])).all(1) \
            & (pc[:, 2] > 0.1)
        idx = np.nonzero(vis)[0]
        feats.append(ImageFeatures(
            ys=pr[idx, 1] + rng.normal(0, 0.1, len(idx)),
            xs=pr[idx, 0] + rng.normal(0, 0.1, len(idx)),
            scales=np.ones(len(idx)),
            desc=desc[idx] + rng.normal(0, 0.02, (len(idx), 64)),
            valid=np.ones(len(idx), bool)))

    it = iter(feats)
    scene = structure2.reconstruct_uncalibrated(
        [np.zeros((H, W), np.float32)] * n_views,
        detect=lambda im: next(it), device=dev, mesh=mesh)
    print(f"device: {dev}")
    print(f"registered views: {len(scene['poses'])}/{n_views}, "
          f"points: {len(scene['points'])}")
    f_est = scene["K"][0, 0]
    print(f"self-calibrated focal: {f_est:.1f} (true {f:.0f}, "
          f"err {abs(f_est - f) / f * 100:.1f}%)")

    gt = np.stack([-R.T @ t for R, t in poses])
    est = np.stack([-scene["poses"][v][0].T @ scene["poses"][v][1]
                    for v in range(n_views)])
    gt_c = gt - gt.mean(0)
    est_c = est - est.mean(0)
    s = np.linalg.norm(gt_c) / max(np.linalg.norm(est_c), 1e-12)
    U, _, Vt = np.linalg.svd(est_c.T @ gt_c)
    err = np.linalg.norm(gt_c - s * est_c @ ((U @ Vt).T).T, axis=1).max()
    span = np.linalg.norm(gt[-1] - gt[0])
    print(f"max camera-center error after alignment: {err:.3f} "
          f"(span {span:.2f})")
    ok = len(scene["poses"]) == n_views and abs(f_est - f) / f < 0.25 \
        and err < 0.1 * span
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
