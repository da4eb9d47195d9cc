"""Shape fitting: polylines, polygons, ellipses from contours (port of
``boofcv_tpu/feature/shapes.py``, whole: the reference's numpy, copied).

Reference analog: boofcv-feature alg/shapes/ —
polyline/splitmerge/PolylineSplitMerge.java (split-merge polyline),
polygon/DetectPolygonFromContour.java, ellipse/BinaryEllipseDetector +
georegression's FitEllipseAlgebraic.

Contours are small host-side arrays (they come from
ip.binary.contour_external), so fitting runs in numpy on the host — same
split as the reference, where this is scalar Java on tiny data.
"""

from __future__ import annotations

import numpy as np


def _point_line_distance(pts, a, b):
    """Distance of each point to segment-line (a, b)."""
    ab = b - a
    n = np.linalg.norm(ab)
    if n < 1e-12:
        return np.linalg.norm(pts - a, axis=1)
    d = ab / n
    rel = pts - a
    return np.abs(d[0] * rel[:, 1] - d[1] * rel[:, 0])


def fit_polyline(contour, tolerance: float = 2.0, closed: bool = True):
    """Douglas-Peucker style split fitting (PolylineSplitMerge analog).

    contour: [N, 2] (x, y) ordered points.  Returns vertex indices.
    """
    pts = np.asarray(contour, np.float64)
    n = len(pts)
    if n <= 2:
        return list(range(n))

    if closed:
        # seed with the two most distant points
        d = np.linalg.norm(pts - pts[0], axis=1)
        i0 = 0
        i1 = int(np.argmax(d))
        segments = [(i0, i1), (i1, i0 + n)]  # wrap via index mod n
    else:
        segments = [(0, n - 1)]

    verts = sorted({s[0] % n for s in segments})

    def seg_points(i, j):
        idx = np.arange(i, j + 1) % n
        return idx

    changed = True
    vset = set(verts)
    seglist = segments[:]
    while changed:
        changed = False
        new_segs = []
        for (i, j) in seglist:
            idx = seg_points(i, j)
            if len(idx) <= 2:
                new_segs.append((i, j))
                continue
            a = pts[i % n]
            b = pts[j % n]
            dists = _point_line_distance(pts[idx], a, b)
            kmax = int(np.argmax(dists))
            if dists[kmax] > tolerance:
                mid = i + kmax
                new_segs.append((i, mid))
                new_segs.append((mid, j))
                vset.add(mid % n)
                changed = True
            else:
                new_segs.append((i, j))
        seglist = new_segs
    return sorted(vset)


def fit_polygon(contour, num_sides: int | None = None,
                tolerance: float = 2.0):
    """Polygon corners from a closed contour (DetectPolygonFromContour).

    Returns [K, 2] corner coordinates; if num_sides is given, the K
    highest-deviation vertices are reduced/merged to that count.
    """
    pts = np.asarray(contour, np.float64)
    verts = fit_polyline(pts, tolerance, closed=True)
    corners = pts[verts]
    if num_sides is not None and len(corners) > num_sides:
        # iteratively drop the vertex whose removal changes the shape least
        verts = list(verts)
        while len(verts) > num_sides:
            n = len(verts)
            costs = []
            for k in range(n):
                a = pts[verts[(k - 1) % n]]
                b = pts[verts[(k + 1) % n]]
                costs.append(_point_line_distance(
                    pts[verts[k]][None], a, b)[0])
            verts.pop(int(np.argmin(costs)))
        corners = pts[verts]
    return corners


def fit_ellipse(points):
    """Algebraic ellipse fit (FitEllipseAlgebraic, Fitzgibbon's method).

    points: [N, 2].  Returns dict(center, a, b, phi) or None if the fit
    is not an ellipse.
    """
    pts = np.asarray(points, np.float64)
    x = pts[:, 0]
    y = pts[:, 1]
    mx, my = x.mean(), y.mean()
    x = x - mx
    y = y - my
    D1 = np.stack([x * x, x * y, y * y], 1)
    D2 = np.stack([x, y, np.ones_like(x)], 1)
    S1 = D1.T @ D1
    S2 = D1.T @ D2
    S3 = D2.T @ D2
    T = -np.linalg.solve(S3, S2.T)
    M = S1 + S2 @ T
    C = np.array([[0, 0, 2.0], [0, -1.0, 0], [2.0, 0, 0]])
    Mred = np.linalg.solve(C, M)
    w, v = np.linalg.eig(Mred)
    # pick eigenvector satisfying 4ac - b^2 > 0
    cond = 4 * v[0] * v[2] - v[1] ** 2
    idx = np.nonzero((cond > 0) & np.isreal(w))[0]
    if idx.size == 0:
        return None
    a1 = np.real(v[:, idx[0]])
    a2 = T @ a1
    A, B, Cc = a1
    D, E, F = a2
    # conic -> geometric (canonical closed form):
    # q = 2(AE^2 + CD^2 - BDE + (B^2-4AC)F); axis_pm =
    #   -sqrt(q ((A+C) -/+ sqrt((A-C)^2+B^2))) / (B^2-4AC)
    den = B * B - 4 * A * Cc
    cx = (2 * Cc * D - B * E) / den
    cy = (2 * A * E - B * D) / den
    q = 2 * (A * E * E + Cc * D * D - B * D * E + den * F)
    s = np.sqrt((A - Cc) ** 2 + B * B)
    ax1 = -np.sqrt(np.maximum(q * ((A + Cc) + s), 0.0)) / den
    ax2 = -np.sqrt(np.maximum(q * ((A + Cc) - s), 0.0)) / den
    semi_major, semi_minor = max(ax1, ax2), min(ax1, ax2)
    phi = 0.5 * np.arctan2(-B, Cc - A)
    # phi above is the axis of ax1; if ax2 is the major axis, rotate 90 deg
    if ax2 > ax1:
        phi += np.pi / 2
    return {"center": (cx + mx, cy + my), "a": semi_major, "b": semi_minor,
            "phi": phi % np.pi}


def polygon_is_convex(corners) -> bool:
    c = np.asarray(corners)
    n = len(c)
    signs = []
    for i in range(n):
        a = c[(i + 1) % n] - c[i]
        b = c[(i + 2) % n] - c[(i + 1) % n]
        signs.append(np.sign(a[0] * b[1] - a[1] * b[0]))
    signs = [s for s in signs if s != 0]
    return all(s == signs[0] for s in signs)
