"""Two-view triangulation (port of ``boofcv_tpu/geo/triangulate.py``:
``triangulate_two_view_linear``, which ``epipolar.select_pose_cheirality``
calls).

Reference analog: boofcv-geo alg/geo/triangulate/TriangulateMetricLinearDLT
.java.  Observations are normalized image coordinates; every function
broadcasts over leading batch axes.
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch.geo.smalllinalg import _eigh_sym


def triangulate_two_view_linear(p1, p2, R, t):
    """Linear (DLT) two-view triangulation in the camera-1 frame.

    View 1 is (I, 0); view 2 is (R, t) with x2 = R x1 + t.  p1, p2:
    [..., N, 2] normalized coords.  Returns [..., N, 3]."""
    p1 = p1.to(torch.float64)
    p2 = p2.to(torch.float64)
    R = R.to(torch.float64)
    t = t.to(torch.float64)
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r0 = torch.stack([-o, z, x1, z], dim=-1)
    r1 = torch.stack([z, -o, y1, z], dim=-1)
    lead = torch.broadcast_shapes(p1.shape[:-1], R.shape[:-2] + (1,))
    Rb = R[..., None, :, :].expand(lead + (3, 3))
    tb = t[..., None, :].expand(lead + (3,))
    x2, y2 = x2.expand(lead), y2.expand(lead)
    r2 = torch.cat([x2[..., None] * Rb[..., 2, :] - Rb[..., 0, :],
                    (x2 * tb[..., 2] - tb[..., 0])[..., None]], dim=-1)
    r3 = torch.cat([y2[..., None] * Rb[..., 2, :] - Rb[..., 1, :],
                    (y2 * tb[..., 2] - tb[..., 1])[..., None]], dim=-1)
    A = torch.stack([r0.expand(lead + (4,)), r1.expand(lead + (4,)), r2, r3],
                    dim=-2)                                 # [..., N, 4, 4]
    _, v = _eigh_sym(A.transpose(-1, -2) @ A)
    X = v[..., :, 0]
    wcomp = X[..., 3]
    return X[..., :3] / torch.where(torch.abs(wcomp) < 1e-12, 1e-12,
                                    wcomp)[..., None]
