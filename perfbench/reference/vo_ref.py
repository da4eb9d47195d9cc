"""Plain numpy reference of one stereo-VO step, in float64.

It follows the per-frame specification that the port implements
(BoofCV's ``VisOdomPixelDepthPnP``: pyramidal KLT, the spawn's sparse
SAD stereo depth and templates, and the Gauss-Newton refine), written
from that specification and from ``bench_vo_baseline.py``'s plain numpy
VO.  It imports numpy alone: nothing of the port, of JAX or of the JAX
package.

RANSAC draws come from the port's own ``torch.Generator`` and cannot be
replayed, so the reference does not re-run RANSAC: it judges the pose by
what the program says of it (the least-squares optimum over the inlier
set the program keeps) and works every other quantity out again from the
frames.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------

def pyramid(img: np.ndarray, scales) -> list:
    """2x2 block-average pyramid; odd sizes are cropped before each mean."""
    levels = [np.asarray(img, np.float64)]
    cur = levels[0]
    for prev, s in zip(scales[:-1], scales[1:]):
        for _ in range(int(round(np.log2(s // prev)))):
            h, w = cur.shape
            cur = cur[:h - h % 2, :w - w % 2].reshape(
                h // 2, 2, w // 2, 2).mean(axis=(1, 3))
        levels.append(cur)
    return levels


def sobel(img: np.ndarray):
    """Sobel (dx, dy), the border extended."""
    h, w = img.shape
    p = np.pad(img, 1, mode="edge")
    at = lambda dy, dx: p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    dx = ((at(-1, 1) - at(-1, -1)) + 2.0 * (at(0, 1) - at(0, -1))
          + (at(1, 1) - at(1, -1)))
    dy = ((at(1, -1) - at(-1, -1)) + 2.0 * (at(1, 0) - at(-1, 0))
          + (at(1, 1) - at(-1, 1)))
    return dx, dy


def sample_patches(img: np.ndarray, cy, cx, r: int) -> np.ndarray:
    """[N, P, P] bilinear patches centred at (cy, cx); a support that
    leaves the image is moved inside it, the fractions kept."""
    h, w = img.shape
    p = 2 * r + 1
    y0f = np.floor(cy)
    x0f = np.floor(cx)
    yi = np.clip(y0f.astype(np.int64) - r, 0, max(h - p - 1, 0))
    xi = np.clip(x0f.astype(np.int64) - r, 0, max(w - p - 1, 0))
    d = np.arange(p + 1)
    sl = img[(yi[:, None] + d)[:, :, None], (xi[:, None] + d)[:, None, :]]
    fy = (cy - y0f)[:, None, None]
    fx = (cx - x0f)[:, None, None]
    return ((1 - fy) * (1 - fx) * sl[:, :p, :p] + (1 - fy) * fx * sl[:, :p, 1:]
            + fy * (1 - fx) * sl[:, 1:, :p] + fy * fx * sl[:, 1:, 1:])


# ---------------------------------------------------------------------------
# tracking
# ---------------------------------------------------------------------------

OK, OUT_OF_BOUNDS, FAILED, LARGE_ERROR = 0, 1, 2, 4
WINDOW = (24, 16)       # rows, columns of a track's window a level
ROW_ALIGN = 8           # window rows start on a multiple of 8


def _window(cy, cx, r: int, h: int, w: int):
    """Each track's window on a level: its top-left (oy, ox), with the
    rows aligned and the window inside the image, and the patch's
    top-left inside it (py, px) and the margins it may move in."""
    wy, wx = WINDOW
    p1 = 2 * r + 2
    oy = np.floor(cy).astype(np.int64) - r - (wy - p1) // 2
    oy = np.clip((oy // ROW_ALIGN) * ROW_ALIGN, 0,
                 max((h // ROW_ALIGN) * ROW_ALIGN - wy, 0))
    ox = np.clip(np.floor(cx).astype(np.int64) - r - (wx - p1) // 2, 0,
                 max(w - wx, 0))
    p = 2 * r + 1
    return oy, ox, cy - r - oy, cx - r - ox, wy - p - 1, wx - p - 1


def _window_patches(img, oy, ox, py, px, p: int, my: float, mx: float):
    """[N, P, P] bilinear patches with top-left (py, px) inside each
    track's window, held to the window's margins."""
    h, w = img.shape
    py = np.clip(py, 0.0, my)
    px = np.clip(px, 0.0, mx)
    by = np.floor(py)
    bx = np.floor(px)
    d = np.arange(p + 1)
    rows = np.clip(oy[:, None] + by.astype(np.int64)[:, None] + d, 0, h - 1)
    cols = np.clip(ox[:, None] + bx.astype(np.int64)[:, None] + d, 0, w - 1)
    sl = img[rows[:, :, None], cols[:, None, :]]
    fy = (py - by)[:, None, None]
    fx = (px - bx)[:, None, None]
    t = (1 - fx) * sl[:, :, :p] + fx * sl[:, :, 1:]
    return (1 - fy) * t[:, :p, :] + fy * t[:, 1:, :]


def klt(levels, desc, gx, gy, ys, xs, scales, r: int, iterations: int = 8,
        tol: float = 0.01, max_err: float = 25.0, min_det: float = 0.001):
    """Coarse-to-fine inverse-compositional KLT of every track (KltTracker,
    PyramidKltTracker) as the port specifies it: on each level a track
    moves inside a 24 x 16 window placed around its entry position (rows
    aligned to 8), takes ``iterations`` Gauss-Newton steps and stops
    stepping once both components of a step fall below ``tol``; leaving
    the window or the image faults it.  Returns (ys, xs, fault), fault the
    worst code of any level."""
    cy = np.asarray(ys, np.float64) / scales[-1]
    cx = np.asarray(xs, np.float64) / scales[-1]
    fault = np.zeros(cy.shape, np.int64)
    p = 2 * r + 1
    for lvl in range(len(scales) - 1, -1, -1):
        img = levels[lvl]
        h, w = img.shape
        tx = np.asarray(gx[lvl], np.float64)
        ty = np.asarray(gy[lvl], np.float64)
        tm = np.asarray(desc[lvl], np.float64)
        gxx = (tx * tx).sum((1, 2))
        gxy = (tx * ty).sum((1, 2))
        gyy = (ty * ty).sum((1, 2))
        det = gxx * gyy - gxy * gxy
        safe = np.where(det == 0, 1.0, det)
        oy, ox, py, px, my, mx = _window(cy, cx, r, h, w)
        done = np.zeros(py.shape, bool)
        per_pixel = np.zeros(py.shape)
        for _ in range(iterations):
            err = _window_patches(img, oy, ox, py, px, p, my, mx) - tm
            per_pixel = np.abs(err).mean((1, 2))
            bx = (err * tx).sum((1, 2))
            by = (err * ty).sum((1, 2))
            dx = (gyy * bx - gxy * by) / safe
            dy = (gxx * by - gxy * bx) / safe
            py = py - np.where(done, 0.0, dy)
            px = px - np.where(done, 0.0, dx)
            done |= (np.abs(dx) < tol) & (np.abs(dy) < tol)
        ly = np.clip(py, 0.0, my) + r + oy
        lx = np.clip(px, 0.0, mx) + r + ox
        f = np.where(per_pixel > max_err, LARGE_ERROR, OK)
        f = np.where(det / p ** 2 < min_det, FAILED, f)
        inb = ((ly >= r) & (ly <= h - 1 - r) & (lx >= r) & (lx <= w - 1 - r)
               & (py > 0) & (py < my) & (px > 0) & (px < mx))
        f = np.where(~inb, OUT_OF_BOUNDS, f)
        good = f == OK
        cy = np.where(good, ly, cy)
        cx = np.where(good, lx, cx)
        fault = np.maximum(fault, f)
        if lvl > 0:
            ratio = scales[lvl] / scales[lvl - 1]
            cy, cx = cy * ratio, cx * ratio
    return cy, cx, fault


# ---------------------------------------------------------------------------
# stereo depth
# ---------------------------------------------------------------------------

def sad_disparity(left, right, ys, xs, min_d: int, max_d: int, r: int,
                  texture: float):
    """Sparse SAD block match at integer (ys, xs): winner takes all over
    disparities min_d .. max_d - 1, columns left of the image cost 1e6 a
    pixel, the texture test against the best cost outside +-1, and the
    subpixel parabola.  Returns (disparity, valid)."""
    left = np.asarray(left, np.float64)
    right = np.asarray(right, np.float64)
    h, w = left.shape
    n_disp = max_d - min_d
    yi = np.asarray(ys, np.int64)
    xi = np.asarray(xs, np.int64)
    d = np.arange(-r, r + 1)
    rows = np.clip(yi[:, None] + d, 0, h - 1)                    # [N, P]
    lp = left[rows[:, :, None], np.clip(xi[:, None] + d, 0, w - 1)[:, None]]
    disp = min_d + np.arange(n_disp)
    cols = xi[:, None, None] - disp[None, :, None] + d[None, None, :]
    inb = (cols >= 0) & (cols < w)                               # [N, D, P]
    rp = right[rows[:, None, :, None], np.clip(cols, 0, w - 1)[:, :, None, :]]
    e = np.abs(lp[:, None] - rp)                                 # [N, D, P, P]
    e = np.where(inb[:, :, None, :], e, 1e6)
    costs = e.sum((2, 3))                                        # [N, D]
    n = np.arange(len(yi))
    best = np.argmin(costs, 1)
    cbest = costs[n, best]
    valid = (xi - (min_d + best) >= 0) & (cbest < 1e17)
    if texture > 0:
        near = np.abs(np.arange(n_disp)[None] - best[:, None]) <= 1
        c2 = np.min(np.where(near, np.inf, costs), 1)
        valid &= ((c2 - cbest) > texture * np.maximum(cbest, 1e-6)) \
            | ~np.isfinite(c2)
    cm = costs[n, np.clip(best - 1, 0, n_disp - 1)]
    cp = costs[n, np.clip(best + 1, 0, n_disp - 1)]
    denom = cm - 2.0 * cbest + cp
    off = np.where(denom > 1e-9, 0.5 * (cm - cp) / np.where(
        denom > 1e-9, denom, 1.0), 0.0)
    interior = (best > 0) & (best < n_disp - 1)
    sub = best + np.where(interior, np.clip(off, -0.5, 0.5), 0.0)
    return sub + min_d, valid


def lift(xs, ys, disp, fx, cx, cy, baseline, R, t):
    """Rectified pixel and disparity -> world point through the
    world->camera pose (R, t)."""
    z = fx * baseline / np.where(disp > 0, disp, 1.0)
    Xc = np.stack([(xs - cx) * z / fx, (ys - cy) * z / fx, z], -1)
    return (Xc - t) @ R


# ---------------------------------------------------------------------------
# pose
# ---------------------------------------------------------------------------

def _hat(w):
    z = np.zeros_like(w[..., 0])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _exp_so3(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3) + _hat(w)
    k = _hat(w / th)
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * (k @ k)


def project(R, t, world):
    Xc = world @ R.T + t
    return Xc[:, :2] / Xc[:, 2:3]


def reprojection_px(R, t, world, obs, fx: float):
    """Each track's distance, in pixels, from its observation (normalized
    coordinates) to its world point seen through (R, t)."""
    return np.hypot(*(project(R, t, world) - obs).T) * fx


def robust_pose(R, t, world, obs, threshold_px: float, fx: float):
    """The reference's own inlier set: the least-squares pose from (R, t)
    over every track, then again over the tracks within three times and
    then within once ``threshold_px`` of the last pose.  Returns (R, t)."""
    keep = np.ones(len(world), bool)
    for bound in (np.inf, 3.0 * threshold_px, threshold_px, threshold_px):
        if bound < np.inf:
            keep = reprojection_px(R, t, world, obs, fx) <= bound
        if keep.sum() < 6:
            break
        R, t = refine_pose(R, t, world[keep], obs[keep])
    return R, t


def refine_pose(R, t, world, obs, iterations: int = 30):
    """Least-squares pose over normalized observations ``obs`` of
    ``world`` points: Gauss-Newton on the reprojection error from (R, t),
    in float64, to convergence."""
    R = np.array(R, np.float64)
    t = np.array(t, np.float64)
    for _ in range(iterations):
        Xc = world @ R.T + t
        iz = 1.0 / Xc[:, 2]
        res = (Xc[:, :2] * iz[:, None] - obs).reshape(-1)
        zero = np.zeros_like(iz)
        A = np.stack([np.stack([iz, zero, -Xc[:, 0] * iz * iz], -1),
                      np.stack([zero, iz, -Xc[:, 1] * iz * iz], -1)], -2)
        J = np.concatenate([-(A @ _hat(Xc)), A], -1).reshape(-1, 6)
        step = np.linalg.solve(J.T @ J, -J.T @ res)
        dR = _exp_so3(step[:3])
        R = dR @ R
        t = dR @ t + step[3:]
        if np.max(np.abs(step)) < 1e-15:
            break
    return R, t
