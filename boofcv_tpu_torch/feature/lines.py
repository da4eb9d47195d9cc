"""Line detection: Hough transforms and grid-RANSAC segments (port of
``boofcv_tpu/feature/lines.py``).

Reference analog: boofcv-feature alg/feature/detect/line/ —
HoughTransformBinary.java / HoughTransformGradient.java with the polar
(HoughParametersPolar) and foot-of-norm parameterizations,
GridRansacLineDetector.java, ConnectLinesGrid.java and
ImageLinePruneMerge.java.

The accumulators are ``index_add_`` of 0/1 votes over every pixel, in
blocks of ``HOUGH_CHUNK`` pixels: float32 sums of ones are exact below
2^24, so the counts are the reference's whatever order the card adds in.
Peaks go through ``extract.detect`` (the reference's tie ramp; integer
vote counts tie often, and ``torch.topk`` orders tied peaks otherwise than
``lax.top_k``, so peaks compare as sets).  ``grid_ransac_lines`` runs the
regions as one batch axis; its edgels are a stable descending sort (the
lower index first on ties, as ``lax.top_k``), and its hypothesis pairs come
from a ``torch.Generator`` or an injected ``pair_idx``.
``connect_segments`` and ``prune_merge_similar`` are host numpy finishers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from boofcv_tpu_torch._config import as_tensor, resolve_device
from boofcv_tpu_torch.feature import extract
from boofcv_tpu_torch.ip.derivative import sobel
from boofcv_tpu_torch.utils.unionfind import UnionFind

HOUGH_CHUNK = 65536         # pixels a block of the polar vote


class HoughLines(NamedTuple):
    rho: torch.Tensor      # [K] signed distance from the centre
    theta: torch.Tensor    # [K] normal angle (float64)
    score: torch.Tensor    # [K]
    valid: torch.Tensor


def _thetas(n_theta: int, device) -> torch.Tensor:
    """``jnp.linspace(0, pi, n_theta, endpoint=False)`` in float64, bit for
    bit: i * (pi / n)."""
    return torch.arange(n_theta, dtype=torch.float64,
                        device=device) * (math.pi / n_theta)


def _grid(h: int, w: int, device):
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    return ys, xs


def _max_r(h: int, w: int) -> float:
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    return float(np.hypot(max(cy, h - 1 - cy), max(cx, w - 1 - cx)))


def _rho_index(rho, max_r: float, n_rho: int) -> torch.Tensor:
    return torch.clamp(torch.round((rho / max_r + 1.0) * 0.5 * (n_rho - 1)),
                       0, n_rho - 1).to(torch.int64)


def hough_binary(binary, n_theta: int = 180, n_rho: int = 181,
                 max_lines: int = 10, peak_radius: int = 2,
                 threshold_frac: float = 0.3, device=None) -> HoughLines:
    """Polar Hough over a binary edge image (HoughTransformBinary); rho is
    measured from the image centre, as in the reference."""
    bw = as_tensor(binary, device=device) > 0
    dev = bw.device
    h, w = bw.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = _grid(h, w, dev)
    thetas = _thetas(n_theta, dev)
    max_r = _max_r(h, w)
    x0 = (xs - cx).reshape(-1)
    y0 = (ys - cy).reshape(-1)
    votes = bw.reshape(-1).to(torch.float32)
    cos_t, sin_t = torch.cos(thetas), torch.sin(thetas)
    t_idx = torch.arange(n_theta, device=dev) * n_rho
    acc = torch.zeros(n_theta * n_rho, dtype=torch.float32, device=dev)
    for s in range(0, x0.shape[0], HOUGH_CHUNK):
        sl = slice(s, s + HOUGH_CHUNK)
        rho = x0[sl, None] * cos_t + y0[sl, None] * sin_t       # [P, T]
        flat = t_idx + _rho_index(rho, max_r, n_rho)
        acc.index_add_(0, flat.reshape(-1),
                       votes[sl, None].expand(flat.shape).reshape(-1))
    return _extract_lines(acc.reshape(n_theta, n_rho), thetas, max_r, n_rho,
                          max_lines, peak_radius, threshold_frac)


def hough_gradient(image, n_theta: int = 180, n_rho: int = 181,
                   max_lines: int = 10, peak_radius: int = 2,
                   edge_threshold: float = 20.0,
                   threshold_frac: float = 0.3, device=None) -> HoughLines:
    """Gradient-direction Hough (HoughTransformGradient): each edge pixel
    votes once, at the angle of its gradient."""
    img = as_tensor(image, torch.float32, device)
    dev = img.device
    dx, dy = sobel(img)
    mag = torch.hypot(dx, dy)
    h, w = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = _grid(h, w, dev)
    theta = torch.remainder(torch.arctan2(dy, dx), math.pi)  # normal angle
    max_r = _max_r(h, w)
    rho = (xs - cx) * torch.cos(theta) + (ys - cy) * torch.sin(theta)
    ti = torch.clamp((theta / math.pi * n_theta).to(torch.int64), 0,
                     n_theta - 1)
    flat = ti * n_rho + _rho_index(rho, max_r, n_rho)
    acc = torch.zeros(n_theta * n_rho, dtype=torch.float32, device=dev)
    acc.index_add_(0, flat.reshape(-1),
                   (mag > edge_threshold).to(torch.float32).reshape(-1))
    return _extract_lines(acc.reshape(n_theta, n_rho), _thetas(n_theta, dev),
                          max_r, n_rho, max_lines, peak_radius,
                          threshold_frac)


def _extract_lines(acc, thetas, max_r, n_rho, max_lines, peak_radius,
                   threshold_frac) -> HoughLines:
    det = extract.detect(acc, max_features=max_lines, radius=peak_radius,
                         threshold=threshold_frac * torch.max(acc))
    t = thetas[torch.clamp(det.ys.long(), 0, thetas.shape[0] - 1)]
    r = (det.xs.to(torch.float32) / (n_rho - 1) * 2.0 - 1.0) * max_r
    return HoughLines(r, t, det.scores, det.valid)


def line_pixels(rho, theta, shape_hw, thickness: float = 1.0) -> np.ndarray:
    """Boolean mask of the line (host numpy, for drawing and tests)."""
    h, w = shape_hw
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    d = np.abs((xs - cx) * np.cos(theta) + (ys - cy) * np.sin(theta) - rho)
    return d <= thickness


class GridLineSegments(NamedTuple):
    """Fixed-capacity per-region line segments (MatrixOfList analog)."""
    x0: torch.Tensor      # [R, L]
    y0: torch.Tensor
    x1: torch.Tensor
    y1: torch.Tensor
    inliers: torch.Tensor  # [R, L] inlier counts (int64)
    valid: torch.Tensor    # [R, L] bool


def _take(a, idx):
    return torch.gather(a, -1, idx)


def grid_ransac_lines(image, region_size: int = 32,
                      edge_threshold: float = 30.0,
                      max_lines_per_region: int = 2,
                      edgels_per_region: int = 48,
                      hypotheses: int = 64,
                      inlier_tol: float = 1.0,
                      min_inliers: int = 6,
                      angle_tol: float = 0.35,
                      generator: torch.Generator | None = None,
                      pair_idx=None, device=None) -> GridLineSegments:
    """Grid-RANSAC line segments (GridRansacLineDetector.java: edgel
    grouping after Clarke, Carlsson and Zisserman).

    The image is tiled into ``region_size`` squares; each region's top-K
    gradient edgels feed a 2-point RANSAC whose inlier test combines the
    point-line distance with the gradient's orthogonality to the line.
    ``max_lines_per_region`` find-remove rounds; every region in one
    batch.  ``pair_idx`` [R, hypotheses, 2] (edgel slots) replaces the draw
    from ``generator`` (default: a generator seeded 0 on the device)."""
    img = as_tensor(image, torch.float32, device)
    dev = img.device
    dx, dy = sobel(img)
    mag = torch.abs(dx) + torch.abs(dy)
    h, w = img.shape
    rs = region_size
    nry, nrx = h // rs, w // rs
    nreg = nry * nrx
    K = edgels_per_region

    def crop(a):
        return (a[: nry * rs, : nrx * rs].reshape(nry, rs, nrx, rs)
                .permute(0, 2, 1, 3).reshape(nreg, rs * rs))

    yy, xx = _grid(h, w, dev)
    score = torch.where(crop(mag) > edge_threshold, crop(mag), -1.0)
    top, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = top[:, :K], idx[:, :K]
    emask = top > 0
    ex, ey = _take(crop(xx), idx), _take(crop(yy), idx)
    gx, gy = _take(crop(dx), idx), _take(crop(dy), idx)
    gn = torch.sqrt(gx * gx + gy * gy)
    gn = torch.where(gn < 1e-9, 1.0, gn)
    gx, gy = gx / gn, gy / gn

    if pair_idx is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        pair_idx = torch.randint(0, K, (nreg, hypotheses, 2),
                                 generator=generator, device=dev)
    pairs = as_tensor(pair_idx, torch.int64, dev)
    pa, pb = pairs[..., 0], pairs[..., 1]
    xa, ya, xb, yb = _take(ex, pa), _take(ey, pa), _take(ex, pb), _take(ey, pb)
    dxl, dyl = xb - xa, yb - ya
    ln = torch.sqrt(dxl * dxl + dyl * dyl)
    ln_safe = torch.where(ln < 1e-9, 1.0, ln)
    ux, uy = dxl / ln_safe, dyl / ln_safe
    # distance of every edgel to every hypothesis line [R, Hyp, K], and
    # the gradient's alignment with the line direction (must be normal)
    dist = torch.abs((ex[:, None, :] - xa[..., None]) * uy[..., None]
                     - (ey[:, None, :] - ya[..., None]) * ux[..., None])
    gdot = torch.abs(gx[:, None, :] * ux[..., None]
                     + gy[:, None, :] * uy[..., None])
    geometric = (dist <= inlier_tol) & (gdot <= angle_tol)

    active = emask
    segs = []
    for _ in range(max_lines_per_region):
        ok_h = (ln > 1.0) & _take(active, pa) & _take(active, pb)
        is_in = geometric & active[:, None, :] & ok_h[..., None]
        counts = torch.sum(is_in, dim=2)
        best = torch.argmax(counts, dim=1)
        inl = torch.gather(is_in, 1, best[:, None, None].expand(
            nreg, 1, K))[:, 0]
        n_in = torch.gather(counts, 1, best[:, None])[:, 0]
        # total-least-squares refit on the inliers (centroid + direction)
        wgt = inl.to(torch.float32)
        s = torch.clamp(torch.sum(wgt, dim=1), min=1.0)
        mx = torch.sum(ex * wgt, dim=1) / s
        my = torch.sum(ey * wgt, dim=1) / s
        rx, ry = ex - mx[:, None], ey - my[:, None]
        cxx = torch.sum(wgt * rx ** 2, dim=1)
        cxy = torch.sum(wgt * rx * ry, dim=1)
        cyy = torch.sum(wgt * ry ** 2, dim=1)
        ang = 0.5 * torch.arctan2(2 * cxy, cxx - cyy)
        ux_b, uy_b = torch.cos(ang), torch.sin(ang)
        # the segment's ends: the extreme inlier projections
        proj = rx * ux_b[:, None] + ry * uy_b[:, None]
        good = n_in >= min_inliers
        pmin = torch.where(good, torch.amin(
            torch.where(inl, proj, float("inf")), dim=1), 0.0)
        pmax = torch.where(good, torch.amax(
            torch.where(inl, proj, float("-inf")), dim=1), 0.0)
        segs.append((mx + pmin * ux_b, my + pmin * uy_b, mx + pmax * ux_b,
                     my + pmax * uy_b, n_in, good))
        active = active & ~(inl & good[:, None])
    return GridLineSegments(*[torch.stack(f, dim=1) for f in zip(*segs)])


class FootLines(NamedTuple):
    """Foot-of-norm lines: the point of each line closest to the image
    centre is its parameter (LineParametric through the foot)."""
    fx: torch.Tensor      # [K] foot x (absolute pixels)
    fy: torch.Tensor      # [K]
    score: torch.Tensor
    valid: torch.Tensor


def hough_foot(image, max_lines: int = 10, min_distance: int = 5,
               edge_threshold: float = 30.0, peak_radius: int = 2,
               threshold_frac: float = 0.3, device=None) -> FootLines:
    """Gradient Hough with the foot-of-norm parameterization
    (HoughTransformGradient + HoughParametersFootOfNorm): every edge pixel
    votes for the foot of the perpendicular from the image centre onto the
    line through it with the gradient as normal; an image-shaped
    accumulator.  The peak threshold is float32(threshold_frac * max) with
    the product in float64, as the reference's host float gives it, but
    without reading the maximum back."""
    img = as_tensor(image, torch.float32, device)
    dev = img.device
    h, w = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dx, dy = sobel(img)
    sel = (torch.abs(dx) + torch.abs(dy)) > edge_threshold
    gn = torch.sqrt(dx * dx + dy * dy)
    gn = torch.where(gn < 1e-9, 1.0, gn)
    ux, uy = dx / gn, dy / gn
    ys, xs = _grid(h, w, dev)
    d = (xs - cx) * ux + (ys - cy) * uy          # signed normal distance
    fx = cx + d * ux
    fy = cy + d * uy
    # feet too close to the centre have no direction (minDistanceFromOrigin)
    sel = sel & (d * d > float(min_distance) ** 2)
    fxi = torch.clamp(torch.round(fx), 0, w - 1).to(torch.int64)
    fyi = torch.clamp(torch.round(fy), 0, h - 1).to(torch.int64)
    flat = torch.where(sel, fyi * w + fxi, 0)
    votes = torch.zeros(h * w, dtype=torch.float32, device=dev)
    votes.index_add_(0, flat.reshape(-1), sel.reshape(-1).to(torch.float32))
    votes[0] = 0.0
    acc = votes.reshape(h, w)
    thr = (torch.max(acc).to(torch.float64) * threshold_frac).to(
        torch.float32)
    det = extract.detect(acc, max_features=max_lines, radius=peak_radius,
                         threshold=thr, border=0)
    return FootLines(det.xs.to(torch.float32), det.ys.to(torch.float32),
                     det.scores, det.valid)


def foot_to_polar(foot: FootLines, shape_hw):
    """Foot point -> (rho, theta) about the image centre."""
    h, w = shape_hw
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dx, dy = foot.fx - cx, foot.fy - cy
    return torch.sqrt(dx * dx + dy * dy), torch.arctan2(dy, dx)


class LineSegments(NamedTuple):
    """Flat (region-free) line segments (host numpy)."""
    x0: np.ndarray
    y0: np.ndarray
    x1: np.ndarray
    y1: np.ndarray
    inliers: np.ndarray


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def connect_segments(segs: GridLineSegments, angle_tol: float = 0.12,
                     dist_tol: float = 2.0,
                     gap_tol: float = 8.0) -> LineSegments:
    """Merge collinear fragments across grid regions (ConnectLinesGrid.java:
    59): a long line crossing five regions comes back from
    :func:`grid_ransac_lines` as five pieces.  Host finisher on the short
    segment list: one [M, M] compatibility test (angle within
    ``angle_tol`` mod pi, each midpoint within ``dist_tol`` of the other's
    line, projection intervals less than ``gap_tol`` apart), union-find
    over compatible pairs, one total-least-squares refit a group (ends
    weighted by inlier counts) spanning its extreme projections."""
    v = _host(segs.valid).ravel()
    x0 = _host(segs.x0).ravel()[v]
    y0 = _host(segs.y0).ravel()[v]
    x1 = _host(segs.x1).ravel()[v]
    y1 = _host(segs.y1).ravel()[v]
    w = _host(segs.inliers).ravel()[v].astype(np.float64)
    M = len(x0)
    if M == 0:
        return LineSegments(*[np.zeros(0)] * 4, np.zeros(0, np.int32))
    ang = np.arctan2(y1 - y0, x1 - x0) % np.pi
    mx = 0.5 * (x0 + x1)
    my = 0.5 * (y0 + y1)
    ux = np.cos(ang)
    uy = np.sin(ang)
    dang = np.abs(ang[:, None] - ang[None, :])
    dang = np.minimum(dang, np.pi - dang)
    # midpoint j to the infinite line i (and symmetrically)
    relx = mx[None, :] - mx[:, None]
    rely = my[None, :] - my[:, None]
    perp = np.abs(relx * uy[:, None] - rely * ux[:, None])
    perp = np.maximum(perp, perp.T)
    # gap along line i between the two projection intervals
    p0 = (x0[None, :] - mx[:, None]) * ux[:, None] \
        + (y0[None, :] - my[:, None]) * uy[:, None]
    p1 = (x1[None, :] - mx[:, None]) * ux[:, None] \
        + (y1[None, :] - my[:, None]) * uy[:, None]
    lo = np.minimum(p0, p1)
    hi = np.maximum(p0, p1)
    own_lo = np.diag(lo).copy()
    own_hi = np.diag(hi).copy()
    gap = np.maximum(lo - own_hi[:, None], own_lo[:, None] - hi)
    compat = (dang <= angle_tol) & (perp <= dist_tol) & (gap <= gap_tol)
    uf = UnionFind(M)
    for i, j in zip(*np.nonzero(np.triu(compat, 1))):
        uf.union(i, j)
    root = uf.roots()
    out = []
    for r in np.unique(root):
        sel = root == r
        px = np.concatenate([x0[sel], x1[sel]])
        py = np.concatenate([y0[sel], y1[sel]])
        pw = np.concatenate([w[sel], w[sel]])
        s = pw.sum()
        cx_, cy_ = (px * pw).sum() / s, (py * pw).sum() / s
        cxx = (pw * (px - cx_) ** 2).sum()
        cxy = (pw * (px - cx_) * (py - cy_)).sum()
        cyy = (pw * (py - cy_) ** 2).sum()
        a = 0.5 * np.arctan2(2 * cxy, cxx - cyy)
        dx_, dy_ = np.cos(a), np.sin(a)
        t = (px - cx_) * dx_ + (py - cy_) * dy_
        out.append((cx_ + t.min() * dx_, cy_ + t.min() * dy_,
                    cx_ + t.max() * dx_, cy_ + t.max() * dy_,
                    int(w[sel].sum())))
    ox0, oy0, ox1, oy1, oin = map(np.asarray, zip(*out))
    return LineSegments(ox0, oy0, ox1, oy1, oin.astype(np.int32))


def prune_merge_similar(lines: HoughLines, rho_tol: float = 6.0,
                        theta_tol: float = 0.12,
                        merge: bool = True) -> HoughLines:
    """Prune or merge near-duplicate polar Hough lines
    (ImageLinePruneMerge.java:35, pruneSimilar): by score, keep each line
    unless a stronger kept line lies within (rho_tol, theta_tol), theta
    wrapped mod pi with rho's sign flipped across the wrap.
    ``merge=True`` replaces each kept line with the score-weighted mean of
    the duplicates it absorbed.  Host finisher; the result (float64
    tensors on the input's device) has the input's capacity with pruned
    slots out of ``valid``."""
    rho = _host(lines.rho).astype(np.float64)
    theta = _host(lines.theta).astype(np.float64)
    score = _host(lines.score).astype(np.float64)
    valid = _host(lines.valid).copy()
    idx = np.argsort(-np.where(valid, score, -np.inf))
    kept = []
    absorbed = {}
    for i in idx:
        if not valid[i]:
            continue
        matched = None
        for k in kept:
            dth = abs(theta[i] - theta[k])
            wrap = dth > np.pi / 2
            dth = min(dth, np.pi - dth)
            drho = abs((-rho[i] if wrap else rho[i]) - rho[k])
            if dth <= theta_tol and drho <= rho_tol:
                matched = k
                break
        if matched is None:
            kept.append(i)
            absorbed[i] = [i]
        else:
            absorbed[matched].append(i)
            valid[i] = False
    if merge:
        for k in kept:
            grp = absorbed[k]
            wgt = score[grp]
            th_k = theta[k]
            # average where duplicates across the pi wrap align with the
            # keeper
            ths, rhs = [], []
            for g in grp:
                dth = theta[g] - th_k
                if dth > np.pi / 2:
                    ths.append(theta[g] - np.pi)
                    rhs.append(-rho[g])
                elif dth < -np.pi / 2:
                    ths.append(theta[g] + np.pi)
                    rhs.append(-rho[g])
                else:
                    ths.append(theta[g])
                    rhs.append(rho[g])
            s = wgt.sum()
            th_w = float(np.dot(ths, wgt) / s)
            rho_k = float(np.dot(rhs, wgt) / s)
            # fold the mean back into [0, pi): a +-pi shift of theta flips
            # the signed distance's sign
            if th_w < 0.0:
                th_w += np.pi
                rho_k = -rho_k
            elif th_w >= np.pi:
                th_w -= np.pi
                rho_k = -rho_k
            theta[k] = th_w
            rho[k] = rho_k
            score[k] = s
    dev = lines.rho.device if isinstance(lines.rho, torch.Tensor) \
        else resolve_device(None)
    t = lambda a: torch.as_tensor(a, device=dev)
    return HoughLines(t(rho), t(theta), t(score), t(valid))
