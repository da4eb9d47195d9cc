"""Epipolar geometry: fundamental, essential and homography estimation (port
of ``boofcv_tpu/geo/epipolar.py``, whole).

Reference analog: boofcv-geo alg/geo/f/ (FundamentalLinear8.java,
FundamentalLinear7.java, EssentialNister5.java), alg/geo/h/
(HomographyDirectLinearTransform.java), and the residuals of
FundamentalResidualSampson.java / DistanceEpipolarConstraint.

Every solver takes a batch of sample sets (leading axes: RANSAC
hypotheses), runs in float64 and Hartley-normalizes as the reference does.
Nullspaces are eigenvectors of the symmetric part of AᵀA, as
``jnp.linalg.eigh`` computes them; an eigenvector's sign is arbitrary in
both libraries, so F, E and H agree with the reference up to sign.  The
Nister solver's Gauss-Jordan step keeps the reference's QR and triangular
solve, which keeps its rounding and needs no pivoting check.
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch.geo.smalllinalg import (_eigh_sym, cubic_roots, inv3,
                                              poly_roots)

_F64 = torch.float64


def normalize_points(pts):
    """Hartley normalization: [..., N, 2] -> (normed, T [..., 3, 3]); T maps
    raw pixels to zero-mean, unit-deviation coordinates per axis
    (LowLevelMultiViewOps.computeNormalization)."""
    pts = pts.to(_F64)
    mean = torch.mean(pts, dim=-2, keepdim=True)
    centered = pts - mean
    std = torch.std(centered, dim=-2, keepdim=True, correction=0) + 1e-12
    normed = centered / std
    sx = 1.0 / std[..., 0, 0]
    sy = 1.0 / std[..., 0, 1]
    cx = mean[..., 0, 0]
    cy = mean[..., 0, 1]
    z = torch.zeros_like(sx)
    o = torch.ones_like(sx)
    T = torch.stack([
        torch.stack([sx, z, -sx * cx], dim=-1),
        torch.stack([z, sy, -sy * cy], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)
    return normed, T


def _epipolar_design(p1, p2):
    """Rows x2ᵀ F x1 = 0: [..., N, 9] for F in row-major order."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2,
                        y2 * x1, y2 * y1, y2,
                        x1, y1, o], dim=-1)


def _smallest_singular_vector(A):
    """Right singular vector of the least singular value, [..., M, 9] ->
    [..., 9]: the first eigenvector of AᵀA (ascending order)."""
    _, v = _eigh_sym(A.transpose(-1, -2) @ A)
    return v[..., :, 0]


def _nullspace2(A):
    """The two right singular vectors of the two least singular values."""
    _, v = _eigh_sym(A.transpose(-1, -2) @ A)
    return v[..., :, 0], v[..., :, 1]


def _frobenius_unit(M):
    norm = torch.linalg.norm(M, dim=(-2, -1), keepdim=True)
    return M / torch.where(norm == 0, 1.0, norm)


def fundamental_8pt(p1, p2, weights=None):
    """Normalized 8-point fundamental matrix (FundamentalLinear8.java).

    p1, p2: [..., N>=8, 2] pixels.  Returns [..., 3, 3], rank 2,
    denormalized, unit Frobenius norm.  ``weights`` [..., N] (an inlier
    mask) scales the design rows, for refits after RANSAC."""
    n1, T1 = normalize_points(p1)
    n2, T2 = normalize_points(p2)
    A = _epipolar_design(n1, n2)
    if weights is not None:
        A = A * weights.to(A.dtype)[..., None]
    f = _smallest_singular_vector(A)
    F = f.reshape(f.shape[:-1] + (3, 3))
    U, s, Vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    F = (U * s[..., None, :]) @ Vt
    F = T2.transpose(-1, -2) @ F @ T1
    return _frobenius_unit(F)


def fundamental_7pt(p1, p2):
    """7-point fundamental (FundamentalLinear7.java): up to 3 solutions.

    p1, p2: [..., 7, 2].  Returns (F [..., 3, 3, 3], valid [..., 3]); the
    cubic det(a F1 + (1 - a) F2) = 0 is interpolated from four
    determinants as in the reference."""
    n1, T1 = normalize_points(p1)
    n2, T2 = normalize_points(p2)
    A = _epipolar_design(n1, n2)
    f1, f2 = _nullspace2(A)
    F1 = f1.reshape(f1.shape[:-1] + (3, 3))
    F2 = f2.reshape(f2.shape[:-1] + (3, 3))

    def det_at(t):
        return torch.linalg.det(t * F1 + (1.0 - t) * F2)

    d0 = det_at(0.0)
    d1 = det_at(1.0)
    dm = det_at(-1.0)
    d2 = det_at(2.0)
    c0 = d0
    c2 = (d1 + dm) / 2.0 - d0
    c3 = (d2 + 3.0 * d0 - 3.0 * d1 - dm) / 6.0
    c1 = d1 - d0 - c2 - c3
    roots, real = cubic_roots(c3, c2, c1, c0)

    a = roots[..., :, None, None]                        # [..., 3, 1, 1]
    F = a * F1[..., None, :, :] + (1.0 - a) * F2[..., None, :, :]
    F = T2.transpose(-1, -2)[..., None, :, :] @ F @ T1[..., None, :, :]
    return _frobenius_unit(F), real


def essential_8pt(p1, p2, weights=None):
    """Essential matrix from >= 8 normalized (K⁻¹) coordinates: the linear
    solve projected onto the essential manifold (singular values
    (s, s, 0)).  ``weights`` [..., N] scales the design rows."""
    A = _epipolar_design(p1.to(_F64), p2.to(_F64))
    if weights is not None:
        A = A * weights.to(A.dtype)[..., None]
    e = _smallest_singular_vector(A)
    E = e.reshape(e.shape[:-1] + (3, 3))
    U, s, Vt = torch.linalg.svd(E)
    sm = (s[..., 0] + s[..., 1]) * 0.5
    s_new = torch.stack([sm, sm, torch.zeros_like(sm)], dim=-1)
    return (U * s_new[..., None, :]) @ Vt


def _homogeneous(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def sampson_error(F, p1, p2):
    """First-order geometric (Sampson) distance squared per point
    (FundamentalResidualSampson.java).  F [..., 3, 3]; p1, p2 [..., N, 2]
    -> [..., N]."""
    x1 = _homogeneous(p1)
    x2 = _homogeneous(p2)
    Fx1 = x1 @ F.transpose(-1, -2)                       # (F x1)ᵀ rows
    Ftx2 = x2 @ F                                        # (Fᵀ x2)ᵀ rows
    num = torch.sum(x2 * Fx1, dim=-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
           + Ftx2[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-30)


def epipolar_constraint(F, p1, p2):
    """|x2ᵀ F x1| per point (DistanceEpipolarConstraint)."""
    Fx1 = _homogeneous(p1) @ F.transpose(-1, -2)
    return torch.abs(torch.sum(_homogeneous(p2) * Fx1, dim=-1))


def homography_dlt(p1, p2):
    """N >= 4-point homography DLT (HomographyDirectLinearTransform.java).
    p1, p2: [..., N, 2]; returns [..., 3, 3] scaled to H[2, 2] = 1."""
    n1, T1 = normalize_points(p1)
    n2, T2 = normalize_points(p2)
    x, y = n1[..., 0], n1[..., 1]
    u, v = n2[..., 0], n2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], dim=-1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    h = _smallest_singular_vector(A)
    H = inv3(T2) @ h.reshape(h.shape[:-1] + (3, 3)) @ T1
    scale = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(scale) < 1e-12, 1.0, scale)


def homography_transfer_error(H, p1, p2):
    """Forward transfer error squared per point."""
    Hx = _homogeneous(p1) @ H.transpose(-1, -2)
    w = Hx[..., 2]
    proj = Hx[..., :2] / torch.where(torch.abs(w) < 1e-12, 1.0, w)[..., None]
    return torch.sum((proj - p2) ** 2, dim=-1)


def essential_from_fundamental(F, K1, K2):
    """E = K2ᵀ F K1 (MultiViewOps)."""
    return K2.transpose(-1, -2) @ F @ K1


def fundamental_from_essential(E, K1, K2):
    return inv3(K2.transpose(-1, -2)) @ E @ inv3(K1)


def decompose_essential(E):
    """E -> the 4 candidate (R, t) (DecomposeEssential.java).
    Returns R [..., 4, 3, 3], t [..., 4, 3] (unit translation)."""
    U, _, Vt = torch.linalg.svd(E)
    detU = torch.linalg.det(U)
    detV = torch.linalg.det(Vt.transpose(-1, -2))
    U = U * torch.where(detU < 0, -1.0, 1.0)[..., None, None]
    Vt = Vt * torch.where(detV < 0, -1.0, 1.0)[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]
    return (torch.stack([Ra, Ra, Rb, Rb], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def select_pose_cheirality(R4, t4, p1, p2):
    """The (R, t) with the most points in front of both cameras.

    R4 [..., 4, 3, 3], t4 [..., 4, 3]; p1, p2 [N, 2] normalized coords,
    or [..., N, 2]: a set of its own for each leading index of R4.
    Returns (R [..., 3, 3], t [..., 3], best_idx [...]), the choice made on
    the device (no host sync)."""
    from boofcv_tpu_torch.geo.triangulate import triangulate_two_view_linear
    lead = R4.shape[:-2]                                 # [..., 4]
    X = triangulate_two_view_linear(
        p1[..., None, :, :].expand(lead + p1.shape[-2:]),
        p2[..., None, :, :].expand(lead + p2.shape[-2:]), R4, t4)
    X2 = X @ R4.transpose(-1, -2).to(X.dtype) + t4[..., None, :].to(X.dtype)
    counts = torch.sum((X[..., 2] > 0) & (X2[..., 2] > 0), dim=-1)
    best = torch.argmax(counts, dim=-1)                  # [...]
    R = torch.take_along_dim(R4, best[..., None, None, None], dim=-3)
    t = torch.take_along_dim(t4, best[..., None, None], dim=-2)
    return R[..., 0, :, :], t[..., 0, :], best


def epipoles_from_fundamental(F):
    """Left and right epipoles, F e1 = 0 and Fᵀ e2 = 0
    (MultiViewOps.extractEpipoles).  Returns (e1 [3], e2 [3])."""
    F = F.to(_F64)
    e1 = torch.linalg.svd(F)[2][-1]
    e2 = torch.linalg.svd(F.T)[2][-1]
    return e1, e2


def cameras_from_fundamental(F):
    """Canonical projective pair from F (MultiViewOps.fundamentalToProjective):
    P1 = [I | 0], P2 = [[e2]x F | e2].  Returns (P1 [3, 4], P2 [3, 4])."""
    F = F.to(_F64)
    _, e2 = epipoles_from_fundamental(F)
    z = torch.zeros((), dtype=_F64, device=F.device)
    ex = torch.stack([torch.stack([z, -e2[2], e2[1]]),
                      torch.stack([e2[2], z, -e2[0]]),
                      torch.stack([-e2[1], e2[0], z])])
    P1 = torch.cat([torch.eye(3, dtype=_F64, device=F.device),
                    torch.zeros((3, 1), dtype=_F64, device=F.device)], dim=1)
    P2 = torch.cat([ex @ F, e2[:, None]], dim=1)
    return P1, P2


# ---------------------------------------------------------------------------
# Nister 5-point essential solver (EssentialNister5.java:62).  The ten cubic
# constraints are expanded numerically: evaluated at 20 fixed points and
# interpolated over the 20 cubic monomials (one small matmul); Nister's
# Gauss-Jordan elimination is a batched 10x10 solve; the degree-10
# polynomial's roots come from Durand-Kerner (``poly_roots``).
# ---------------------------------------------------------------------------

# Nister's monomial order: x3 y3 x2y xy2 x2z x2 y2z y2 xyz xy |
#                          xz2 xz x yz2 yz y z3 z2 z 1
_N5_POWERS = np.array([
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1), (2, 0, 0),
    (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0), (1, 0, 2), (1, 0, 1),
    (1, 0, 0), (0, 1, 2), (0, 1, 1), (0, 1, 0), (0, 0, 3), (0, 0, 2),
    (0, 0, 1), (0, 0, 0)], dtype=np.float64)


def _n5_sample_points():
    """The reference's 20 interpolation points (seed 42, the first draw
    with cond(V) < 5e3) and the inverse of their monomial matrix."""
    rng = np.random.default_rng(42)
    for _ in range(64):
        pts = rng.uniform(-1.0, 1.0, size=(20, 3))
        V = np.prod(pts[:, None, :] ** _N5_POWERS[None, :, :], axis=-1)
        if np.linalg.cond(V) < 5e3:
            return pts, np.linalg.inv(V)
    raise RuntimeError("could not condition Nister interpolation points")


_N5_PTS, _N5_VINV = _n5_sample_points()


def _polymul(a, b):
    """[..., m] x [..., n] -> [..., m+n-1], highest degree first."""
    m = a.shape[-1]
    n = b.shape[-1]
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = torch.zeros(lead + (m + n - 1,), dtype=a.dtype, device=a.device)
    for i in range(m):
        out[..., i:i + n] += a[..., i:i + 1] * b
    return out


def _eval_poly(c, z):
    out = c[..., 0:1].expand(z.shape).to(z.dtype)
    for i in range(1, c.shape[-1]):
        out = out * z + c[..., i:i + 1]
    return out


def essential_nister5(p1, p2):
    """Nister 5-point essential matrix: up to 10 solutions per sample.

    p1, p2: [..., 5, 2] normalized (K⁻¹) coordinates.  Returns
    (E [..., 10, 3, 3], valid [..., 10]); invalid solutions are NaN, so
    that RANSAC scores them unusable (a zero matrix would score a perfect
    Sampson error)."""
    p1 = p1.to(_F64)
    p2 = p2.to(_F64)
    A = _epipolar_design(p1, p2)                         # [..., 5, 9]
    _, v = _eigh_sym(A.transpose(-1, -2) @ A)
    # 4-dim nullspace basis -> E(x, y, z) = x E1 + y E2 + z E3 + E4
    Es = v[..., :, :4].transpose(-1, -2)
    Es = Es.reshape(Es.shape[:-1] + (3, 3))              # [..., 4, 3, 3]

    dev = p1.device
    pts = torch.from_numpy(_N5_PTS).to(dev)              # [20, 3]
    coef = torch.cat([pts, torch.ones((20, 1), dtype=_F64, device=dev)], -1)
    Epts = torch.einsum("sk,...kij->...sij", coef, Es)   # [..., 20, 3, 3]
    det = (Epts[..., 0, 0] * (Epts[..., 1, 1] * Epts[..., 2, 2]
                              - Epts[..., 1, 2] * Epts[..., 2, 1])
           - Epts[..., 0, 1] * (Epts[..., 1, 0] * Epts[..., 2, 2]
                                - Epts[..., 1, 2] * Epts[..., 2, 0])
           + Epts[..., 0, 2] * (Epts[..., 1, 0] * Epts[..., 2, 1]
                                - Epts[..., 1, 1] * Epts[..., 2, 0]))
    EEt = Epts @ Epts.transpose(-1, -2)
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    trace_con = 2.0 * (EEt @ Epts) - tr[..., None, None] * Epts
    P = torch.cat([det[..., None, :],
                   trace_con.reshape(trace_con.shape[:-2] + (9,)
                                     ).transpose(-1, -2)], dim=-2)
    C = P @ torch.from_numpy(_N5_VINV).to(dev).T         # [..., 10, 20]

    # Gauss-Jordan: G = C1⁻¹ C2 over the last 10 monomials
    Q, Rq = torch.linalg.qr(C[..., :, :10])
    G = torch.linalg.solve_triangular(Rq, Q.transpose(-1, -2) @ C[..., :, 10:],
                                      upper=True)

    # rows e..j (leading monomials x2z, x2, y2z, y2, xyz, xy) give
    # B(z) [x y 1]ᵀ = 0 with k = <e> - z<f>, l = <g> - z<h>, m = <i> - z<j>
    def row_pair(ei, fi):
        e = G[..., ei, :]
        f = G[..., fi, :]
        bx = torch.stack([-f[..., 0], e[..., 0] - f[..., 1],
                          e[..., 1] - f[..., 2], e[..., 2]], dim=-1)
        by = torch.stack([-f[..., 3], e[..., 3] - f[..., 4],
                          e[..., 4] - f[..., 5], e[..., 5]], dim=-1)
        b1 = torch.stack([-f[..., 6], e[..., 6] - f[..., 7],
                          e[..., 7] - f[..., 8], e[..., 8] - f[..., 9],
                          e[..., 9]], dim=-1)
        return bx, by, b1

    rows = [row_pair(4, 5), row_pair(6, 7), row_pair(8, 9)]
    bx_a, by_a, b1_a = rows[1]
    bx_b, by_b, b1_b = rows[2]
    m1 = _polymul(by_a, b1_b) - _polymul(b1_a, by_b)     # degree 7
    m2 = _polymul(b1_a, bx_b) - _polymul(bx_a, b1_b)     # degree 7
    m3 = _polymul(bx_a, by_b) - _polymul(by_a, bx_b)     # degree 6
    bx0, by0, b10 = rows[0]
    n_poly = _polymul(bx0, m1) + _polymul(by0, m2)       # degree 10
    n_poly = n_poly + _polymul(b10, m3)

    zr, zi = poly_roots(n_poly)                          # [..., 10] each
    scale = torch.amax(torch.abs(n_poly), dim=-1)
    lead_ok = torch.abs(n_poly[..., 0]) > 1e-10 * scale
    real = torch.abs(zi) <= 1e-6 * (1.0 + torch.abs(zr))

    # back-substitute x(z), y(z) from the null vector of B(z)
    z = zr
    B = torch.stack([
        torch.stack([_eval_poly(rows[r][0], z), _eval_poly(rows[r][1], z),
                     _eval_poly(rows[r][2], z)], dim=-1)
        for r in range(3)], dim=-2)                      # [..., 10, 3, 3]
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)
    cands = torch.stack([cross(B[..., 0, :], B[..., 1, :]),
                         cross(B[..., 0, :], B[..., 2, :]),
                         cross(B[..., 1, :], B[..., 2, :])], dim=-2)
    best = torch.argmax(torch.linalg.norm(cands, dim=-1), dim=-1)
    vvec = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    w = vvec[..., 2]
    w_ok = torch.abs(w) > 1e-12 * (1.0 + torch.linalg.norm(vvec, dim=-1))
    ws = torch.where(w_ok, w, 1.0)
    x = vvec[..., 0] / ws
    y = vvec[..., 1] / ws

    xyz1 = torch.stack([x, y, z, torch.ones_like(z)], dim=-1)   # [..., 10, 4]
    E = _frobenius_unit(torch.einsum("...rk,...kij->...rij", xyz1, Es))
    valid = (real & w_ok & lead_ok[..., None]
             & torch.all(torch.isfinite(E).flatten(-2), dim=-1))
    return torch.where(valid[..., None, None], E, float("nan")), valid
