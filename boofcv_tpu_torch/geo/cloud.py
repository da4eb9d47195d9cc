"""Point-cloud utilities and nearest-neighbour search (port of
``boofcv_tpu/geo/cloud.py``, whole).

Reference analog: boofcv-geo alg/cloud/PointCloudUtils.java (filtering,
statistics) and alg/nn/KdTreePoint3D_F64.java.  Nearest neighbours come
from the whole [Q, N] float32 squared-distance matrix,
|q|² - 2 q·p + |p|², and ``torch.topk`` of its negation, as the reference
builds it (no tiling: at 16,384 points the matrix is 1 GiB, which the card
holds).  ``lax.top_k`` and ``torch.topk`` may order ties differently, so
neighbour sets, not orders, are what agree.  The voxel downsample is numpy
on the host, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import as_tensor


def statistics(points, valid=None, device=None):
    """Mean / stdev / axis-aligned bounds / count of the valid points
    (PointCloudUtils.statistics), float64 tensors."""
    pts = as_tensor(points, torch.float64, device)
    if valid is None:
        valid = torch.ones(pts.shape[:-1], dtype=torch.bool,
                           device=pts.device)
    w = valid.to(torch.float64)[..., None]
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(pts * w, dim=0) / n
    var = torch.sum(w * (pts - mean) ** 2, dim=0) / n
    big = 1e300
    lo = torch.amin(torch.where(valid[..., None], pts, big), dim=0)
    hi = torch.amax(torch.where(valid[..., None], pts, -big), dim=0)
    return {"mean": mean, "stdev": torch.sqrt(var), "min": lo, "max": hi,
            "count": torch.sum(valid)}


def _sq_dist(q, p):
    """[Q, N] float32 squared distances by the expansion."""
    return (torch.sum(q * q, dim=1)[:, None] - 2.0 * q @ p.T
            + torch.sum(p * p, dim=1)[None, :])


def filter_radius_outliers(points, num_neighbors: int = 8,
                           max_mean_distance: float = 1.0, valid=None,
                           device=None):
    """Keep the points whose mean distance to their k nearest (valid)
    neighbours is at most ``max_mean_distance`` (statistical outlier
    removal, PointCloudUtils.filter).  Returns a [N] bool mask."""
    pts = as_tensor(points, torch.float32, device)
    n = pts.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=pts.device)
    d2 = torch.where(valid[None, :], _sq_dist(pts, pts), float("inf"))
    d2.fill_diagonal_(float("inf"))
    k = min(num_neighbors, n - 1)
    nn_d2 = torch.topk(-d2, k, dim=1).values
    mean_d = torch.mean(torch.sqrt(torch.clamp(-nn_d2, min=0.0)), dim=1)
    return valid & (mean_d <= max_mean_distance)


def nearest_neighbors(queries, points, k: int = 1, valid=None, device=None):
    """Batched k-NN: (indices [Q, k] int64, distances [Q, k] float32)."""
    q = as_tensor(queries, torch.float32, device)
    p = as_tensor(points, torch.float32, q.device)
    d2 = _sq_dist(q, p)
    if valid is not None:
        d2 = torch.where(valid[None, :], d2, float("inf"))
    neg, idx = torch.topk(-d2, k, dim=1)
    return idx, torch.sqrt(torch.clamp(-neg, min=0.0))


def prune_far_points(points, max_distance: float, origin=None, valid=None,
                     device=None):
    """Mask of the points within ``max_distance`` of the origin."""
    pts = as_tensor(points, torch.float64, device)
    o = (torch.zeros(3, dtype=torch.float64, device=pts.device)
         if origin is None else as_tensor(origin, torch.float64, pts.device))
    keep = torch.linalg.vector_norm(pts - o, dim=-1) <= max_distance
    if valid is not None:
        keep = keep & valid
    return keep


def downsample_voxel(points, voxel: float):
    """Voxel-grid downsample on the host: the first point of each occupied
    voxel, in input order (numpy float64)."""
    if isinstance(points, torch.Tensor):
        points = points.cpu().numpy()
    pts = np.asarray(points, np.float64)
    keys = np.floor(pts / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return pts[np.sort(idx)]
