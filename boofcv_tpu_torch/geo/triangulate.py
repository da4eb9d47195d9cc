"""Triangulation of 3-D points from observations (port of
``boofcv_tpu/geo/triangulate.py``, whole).

Reference analog: boofcv-geo alg/geo/triangulate/ —
Triangulate2ViewsGeometricMetric.java (midpoint closest-point),
TriangulateMetricLinearDLT.java:46 (N-view homogeneous DLT).  Observations
are normalized image coordinates; every function broadcasts over leading
batch axes.  The DLTs take the eigenvector of the smallest eigenvalue of
AᵀA: its sign is the library's choice and cancels in the division by w.
``torch.linalg.eigh`` reads its status on the host (one sync a call on the
card).
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


def triangulate_two_view_midpoint(p1, p2, R, t):
    """Closest-point ("geometric midpoint") triangulation
    (Triangulate2ViewsGeometricMetric.java).  Frames as in
    :func:`triangulate_two_view_linear`.  Returns [..., N, 3]."""
    p1 = p1.to(torch.float64)
    p2 = p2.to(torch.float64)
    R = R.to(torch.float64)
    t = t.to(torch.float64)
    # ray 1: origin 0, direction (x1, y1, 1); ray 2 in the camera-1 frame:
    # origin c2 = -Rᵀt, direction Rᵀ (x2, y2, 1)
    d1 = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    c2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    d2 = torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1) @ R
    d11 = torch.sum(d1 * d1, dim=-1)
    d22 = torch.sum(d2 * d2, dim=-1)
    d12 = torch.sum(d1 * d2, dim=-1)
    c2b = c2[..., None, :].expand(d1.shape)
    rc1 = torch.sum(d1 * c2b, dim=-1)
    rc2 = torch.sum(d2 * c2b, dim=-1)
    den = d11 * d22 - d12 * d12
    den = torch.where(torch.abs(den) < 1e-30, 1e-30, den)
    a = (rc1 * d22 - rc2 * d12) / den
    b = (rc1 * d12 - rc2 * d11) / den
    return (a[..., None] * d1 + c2b + b[..., None] * d2) * 0.5


def triangulate_nview_linear(obs, Rs, ts, weights=None):
    """N-view homogeneous DLT (TriangulateMetricLinearDLT.java:46).

    obs: [V, N, 2] normalized observations; Rs [V, 3, 3], ts [V, 3]
    world->camera; weights: optional [V, N] (0 masks an observation out).
    Returns [N, 3] world points."""
    obs = obs.to(torch.float64)
    Rs = Rs.to(torch.float64)
    ts = ts.to(torch.float64)
    x = obs[..., 0]                                            # [V, N]
    y = obs[..., 1]
    rx = x[..., None] * Rs[:, None, 2, :] - Rs[:, None, 0, :]  # [V, N, 3]
    ry = y[..., None] * Rs[:, None, 2, :] - Rs[:, None, 1, :]
    cx = x * ts[:, None, 2] - ts[:, None, 0]                   # [V, N]
    cy = y * ts[:, None, 2] - ts[:, None, 1]
    rowx = torch.cat([rx, cx[..., None]], dim=-1)              # [V, N, 4]
    rowy = torch.cat([ry, cy[..., None]], dim=-1)
    if weights is not None:
        w = weights.to(torch.float64)[..., None]
        rowx = rowx * w
        rowy = rowy * w
    A = torch.cat([rowx, rowy], dim=0).transpose(0, 1)         # [N, 2V, 4]
    _, v = _eigh_sym(A.transpose(-1, -2) @ A)
    X = v[..., :, 0]
    wc = X[..., 3]
    return X[..., :3] / torch.where(torch.abs(wc) < 1e-12, 1e-12,
                                    wc)[..., None]


def reprojection_error(X, obs, Rs, ts):
    """Squared reprojection error in normalized coords.  X [N, 3] world
    points; obs [V, N, 2]; Rs [V, 3, 3], ts [V, 3].  Returns [V, N]."""
    Xc = torch.einsum("vij,nj->vni", Rs, X) + ts[:, None, :]
    z = Xc[..., 2]
    proj = Xc[..., :2] / torch.where(torch.abs(z) < 1e-12, 1e-12,
                                     z)[..., None]
    return torch.sum((proj - obs) ** 2, dim=-1)
