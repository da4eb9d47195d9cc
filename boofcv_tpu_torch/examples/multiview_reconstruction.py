"""Metric reconstruction of a scene from unordered views (port of
``boofcv_tpu/examples/multiview_reconstruction.py``).

Reference analog: examples/sfm/ExampleMultiviewSceneReconstruction.java —
pairwise matching -> pairwise graph -> incremental metric growth -> bundle
adjustment.  The views are projections of known 3-D points (one descriptor
per point), so the recovered camera centres are checked against the ground
truth after a similarity alignment.

    python -m boofcv_tpu_torch.examples.multiview_reconstruction [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.geo import se3
from boofcv_tpu_torch.sfm import reconstruction
from boofcv_tpu_torch.sfm.reconstruction import ImageFeatures


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))

    rng = np.random.default_rng(11)
    H, W = 240, 320
    K = np.array([[200.0, 0, W / 2], [0, 200.0, H / 2], [0, 0, 1.0]])
    n_views, n_points = 4, 120
    pts = np.stack([rng.uniform(-2, 2, n_points),
                    rng.uniform(-1.5, 1.5, n_points),
                    rng.uniform(5, 9, n_points)], 1)
    desc = rng.normal(0, 1, (n_points, 64))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)

    poses, feats = [], []
    for v in range(n_views):
        R = se3.exp_so3(torch.from_numpy(rng.normal(0, 0.02, 3))).numpy()
        c = np.array([0.5 * v, 0.05 * v, 0.1 * v])
        t = -R @ c
        poses.append((R, t))
        pc = pts @ R.T + t
        pr = (pc / pc[:, 2:]) @ K.T
        vis = (pr[:, 0] > 5) & (pr[:, 0] < W - 5) \
            & (pr[:, 1] > 5) & (pr[:, 1] < H - 5) & (pc[:, 2] > 0.1)
        obs = pr[:, :2] + rng.normal(0, 0.3, (n_points, 2))
        nv = int(vis.sum())
        feats.append(ImageFeatures(
            ys=obs[vis, 1].copy(), xs=obs[vis, 0].copy(),
            scales=np.ones(nv),
            desc=desc[vis] + rng.normal(0, 0.02, (nv, 64)),
            valid=np.ones(nv, bool)))

    graph = reconstruction.build_pairwise_graph(feats, K, detect=lambda f: f,
                                                device=dev)
    n_edges = len(graph.edges)
    scene = reconstruction.reconstruct_incremental(graph, K, device=dev)
    print(f"device: {dev}")
    print(f"pairwise graph: {n_edges} edges over {n_views} views")
    print(f"reconstructed {len(scene['points'])} points, "
          f"{len(scene['views'])} views")

    # similarity-align the recovered camera centres to the ground truth
    gt = np.stack([-R.T @ t for R, t in poses])
    est = np.stack([-scene["poses"][v][0].T @ scene["poses"][v][1]
                    for v in range(n_views)])
    gt_c = gt - gt.mean(0)
    est_c = est - est.mean(0)
    scale = np.linalg.norm(gt_c) / max(np.linalg.norm(est_c), 1e-9)
    U, _, Vt = np.linalg.svd(est_c.T @ gt_c)
    Rp = (U @ Vt).T
    err = np.linalg.norm(gt_c - scale * est_c @ Rp.T, axis=1).max()
    print(f"max camera-center error after alignment: {err:.3f} "
          f"(trajectory span {np.linalg.norm(gt[-1] - gt[0]):.2f})")
    ok = len(scene["points"]) > 60 and err < 0.05
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
