"""Stereo rectification (port of ``boofcv_tpu/geo/rectify.py``, whole).

Reference analog: boofcv-geo alg/geo/rectify/RectifyCalibrated.java:53
(calibrated Bouguet-style rectification), RectifyFundamental.java
(uncalibrated), and RectifyImageOps (warp maps, view adjustment).

The rectifying homographies are small matrix math in numpy on the host, as
in the reference; the per-pixel warp maps are dense grids on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from boofcv_tpu_torch._config import as_tensor, resolve_device


class RectifiedPair(NamedTuple):
    """Output of calibrated rectification (float64 tensors)."""
    rect1: torch.Tensor      # [3,3] rectifying homography for view 1 (pixels)
    rect2: torch.Tensor      # [3,3]
    rectK: torch.Tensor      # [3,3] rectified intrinsics (shared)
    rot1: torch.Tensor       # [3,3] camera-1 rotation into the rectified frame
    baseline: float          # rectified baseline (for disparity -> depth)


def rectify_calibrated(K1, K2, R, t, device=None) -> RectifiedPair:
    """Calibrated rectification (RectifyCalibrated.process).

    (R, t): camera-1 to camera-2 (x2 = R x1 + t).  Returns the pixel->pixel
    homographies H_i = K_rect R_rect_i K_i^-1 on ``device`` (None: the
    card)."""
    dev = resolve_device(device)
    K1 = np.asarray(K1, np.float64)
    K2 = np.asarray(K2, np.float64)
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)

    c2 = -R.T @ t                       # camera-2 centre in the camera-1 frame
    e1 = c2 / np.linalg.norm(c2)        # new x-axis along the baseline
    e2 = np.cross(np.array([0.0, 0.0, 1.0]), e1)
    n2 = np.linalg.norm(e2)
    if n2 < 1e-12:                      # baseline along the optical axis
        e2 = np.array([0.0, 1.0, 0.0])
    else:
        e2 = e2 / n2
    e3 = np.cross(e1, e2)
    Rrect = np.stack([e1, e2, e3], axis=0)

    # shared rectified intrinsics: average focal, centred
    f = (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) / 4.0
    cx = (K1[0, 2] + K2[0, 2]) / 2.0
    cy = (K1[1, 2] + K2[1, 2]) / 2.0
    Krect = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])

    H1 = Krect @ Rrect @ np.linalg.inv(K1)
    H2 = Krect @ Rrect @ R.T @ np.linalg.inv(K2)
    on = lambda a: torch.as_tensor(a, device=dev)
    return RectifiedPair(on(H1), on(H2), on(Krect), on(Rrect),
                         float(np.linalg.norm(c2)))


def rectify_uncalibrated(F, p1, p2, width: int, height: int):
    """Uncalibrated (projective) rectification from a fundamental matrix and
    the point pairs that produced it (RectifyFundamental.java:43, Hartley's
    method, H&Z p.305): H sends the second epipole to infinity, H0 = H M
    with M from F, then an affine minimizes the x-disparity of the points.

    p1, p2: [N, 2] pixel correspondences.  Returns (rect1, rect2) numpy
    float64 homographies.  Raises ValueError when an epipole lies inside
    the image (rectification undefined)."""
    from boofcv_tpu_torch.geo import epipolar

    F = np.asarray(F, np.float64)
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    # the epipoles' signs are the SVD's choice; every use below is
    # projective, so they cancel
    e1, e2 = (e.numpy() for e in epipolar.epipoles_from_fundamental(
        torch.from_numpy(F)))
    cx, cy = width // 2, height // 2
    for e in (e1, e2):
        x, y = e[0] / e[2], e[1] / e[2]
        if 0 <= x < width and 0 <= y < height:
            raise ValueError("epipole inside the image; projective "
                             "rectification is undefined")

    # H: send e2 to infinity
    T = np.eye(3)
    T[0, 2], T[1, 2] = -cx, -cy
    x = e2[0] / e2[2] - cx
    y = e2[1] / e2[2] - cy
    theta = np.arctan2(-y, x)
    c, s = np.cos(theta), np.sin(theta)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    G = np.eye(3)
    G[2, 0] = -1.0 / np.hypot(x, y)
    H = G @ Rz @ T

    # matching transform H0 = H M, M = [e2]x F + e2 v^T
    v = np.array([0.1, 0.5, 0.2])
    e2x = np.array([[0, -e2[2], e2[1]], [e2[2], 0, -e2[0]],
                    [-e2[1], e2[0], 0.0]])
    H0 = H @ (e2x @ F + np.outer(e2, v))

    # affine Ha minimizing sum (a k.x + b k.y + c - c.x)^2  (H&Z p.306)
    def apply(Hm, p):
        q = np.concatenate([p, np.ones((len(p), 1))], 1) @ Hm.T
        return q[:, :2] / q[:, 2:]

    k = apply(H0, p1)
    A = np.concatenate([k, np.ones((len(k), 1))], 1)
    abc, *_ = np.linalg.lstsq(A, apply(H, p2)[:, 0], rcond=None)
    Ha = np.eye(3)
    Ha[0] = abc
    return Ha @ H0, H


def adjust_rectification(rect1, rect2, width: int, height: int):
    """Scale and translate both homographies so that image 1's corners stay
    inside a width x height canvas (RectifyImageOps.fullViewLeft's role on
    the uncalibrated path); one affine for both keeps rows aligned.
    Numpy float64 in and out."""
    rect1 = np.asarray(rect1, np.float64)
    corners = np.array([[0, 0, 1], [width - 1, 0, 1],
                        [width - 1, height - 1, 1], [0, height - 1, 1.0]])
    q = corners @ rect1.T
    q = q[:, :2] / q[:, 2:]
    lo = q.min(axis=0)
    hi = q.max(axis=0)
    scale = min(width / (hi[0] - lo[0] + 1e-12),
                height / (hi[1] - lo[1] + 1e-12))
    A = np.array([[scale, 0, -lo[0] * scale],
                  [0, scale, -lo[1] * scale], [0, 0, 1.0]])
    return A @ rect1, A @ np.asarray(rect2, np.float64)


def rectify_maps(H, height: int, width: int, device=None):
    """Inverse warp maps: for each output pixel the source pixel
    H^-1 (x, y, 1) (RectifyImageOps.transformRectToPixel).  ``H`` a tensor
    stays on its device; numpy goes to ``device`` (None: the card).
    Returns float32 (map_y, map_x) [height, width]."""
    from boofcv_tpu_torch.geo.smalllinalg import inv3
    Hinv = inv3(as_tensor(H, torch.float64, device))
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float64, device=Hinv.device),
        torch.arange(width, dtype=torch.float64, device=Hinv.device),
        indexing="ij")
    pts = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1) @ Hinv.T
    w = pts[..., 2]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return ((pts[..., 1] / w).to(torch.float32),
            (pts[..., 0] / w).to(torch.float32))


def disparity_to_depth(disp, rectK, baseline: float):
    """z = f B / d, with invalid (d <= 0) disparities passed through as 0."""
    f = rectK[0, 0]
    safe = torch.where(disp > 0, disp, 1.0)
    return torch.where(disp > 0, f * baseline / safe, 0.0)


def pixel_to_3d_rectified(xs, ys, disp, rectK, baseline: float):
    """Rectified pixel + disparity -> 3D in the rectified left-camera frame
    (StereoSparse3D.process analog).  float64 on the VO path."""
    f = rectK[0, 0]
    cx = rectK[0, 2]
    cy = rectK[1, 2]
    safe = torch.where(disp > 0, disp, 1.0)
    z = f * baseline / safe
    x = (xs - cx) * z / f
    y = (ys - cy) * z / f
    return torch.stack([x, y, z], dim=-1)
