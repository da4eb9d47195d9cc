"""Self-calibration, projective factorization and homography decomposition
(port of ``boofcv_tpu/geo/selfcalib.py``, whole).

Reference analog: boofcv-geo alg/geo/selfcalib/
(SelfCalibrationLinearDualQuadratic.java, DecomposeAbsoluteDualQuadratic.java,
SelfCalibrationGuessAndCheckFocus.java), alg/geo/h/HomographyDecomposition
(decomposeHomography, Faugeras' SVD method) and
alg/geo/structure/ProjectiveStructureByFactorization.java.

The homography decomposition, the linear dual quadratic and the focus sweep
are numpy on the host, as in the reference: their inputs are a few 3x4
matrices.  The factorization is dense linear algebra on the device
(``device``; None: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import as_tensor

# the ten parameters of the symmetric 4x4 dual quadric Q*, in order
_Q_INDEX = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (1, 3),
            (2, 2), (2, 3), (3, 3)]


def homography_decompose(H, K1=None, K2=None):
    """Decompose a metric homography H = R + t nᵀ / d into candidate
    (R, t/d, n) solutions.

    H maps normalized coords of view 1 to view 2 (pass K1, K2 to
    un-calibrate a pixel homography).  Returns a list of (R, t, n) numpy
    float64 triples: up to 4 solutions, each normal turned to n[2] >= 0
    (t negated with it)."""
    H = np.asarray(H, np.float64)
    if K1 is not None:
        H = np.linalg.inv(np.asarray(K2, np.float64)) @ H @ np.asarray(
            K1, np.float64)
    U, S, Vt = np.linalg.svd(H)
    H = H / S[1]
    U, S, Vt = np.linalg.svd(H)
    s = np.linalg.det(U) * np.linalg.det(Vt)
    d1, d2, d3 = S
    if abs(d1 - d3) < 1e-9:   # pure rotation
        return [(H, np.zeros(3), np.array([0.0, 0, 1]))]
    x1 = np.sqrt(max((d1 ** 2 - d2 ** 2) / (d1 ** 2 - d3 ** 2), 0.0))
    x3 = np.sqrt(max((d2 ** 2 - d3 ** 2) / (d1 ** 2 - d3 ** 2), 0.0))
    sols = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            n_p = np.array([e1 * x1, 0.0, e3 * x3])
            sin_t = e1 * e3 * x1 * x3 * (d1 - d3) / d2
            cos_t = (d2 ** 2 + d1 * d3) / ((d1 + d3) * d2)
            Rp = np.array([[cos_t, 0, -sin_t], [0, 1, 0], [sin_t, 0, cos_t]])
            tp = (d1 - d3) * np.array([e1 * x1, 0.0, -e3 * x3])
            R = s * U @ Rp @ Vt
            t = U @ tp
            n = Vt.T @ n_p
            if n[2] < 0:
                n = -n
                t = -t
            sols.append((R, t, n))
    return sols


def self_calibrate_dual_quadratic(Ps, zero_skew: bool = True,
                                  known_aspect: bool = True,
                                  principal_at_origin: bool = True):
    """Linear self-calibration from >= 3 projective cameras
    (SelfCalibrationLinearDualQuadratic).

    Ps: [V, 3, 4] projective cameras in one projective frame (P1 = [I | 0]
    recommended; pixels centred, as the reference's linear variant
    assumes the principal point at 0).  Returns (K, rectifying H [4, 4])
    with P_metric = P H, numpy float64."""
    Ps = np.asarray(Ps, np.float64)

    def q_coeffs(P, i, j):
        """Row expressing w_ij of w = P Q* Pᵀ as a combination of the ten
        parameters of Q*."""
        row = np.zeros(10)
        for n, (a, b) in enumerate(_Q_INDEX):
            row[n] = P[i, a] * P[j, b] + (P[i, b] * P[j, a] if a != b
                                          else 0.0)
        return row

    rows = []
    for P in Ps:
        if zero_skew:
            rows.append(q_coeffs(P, 0, 1))
        if principal_at_origin:
            rows.append(q_coeffs(P, 0, 2))
            rows.append(q_coeffs(P, 1, 2))
        if known_aspect:
            rows.append(q_coeffs(P, 0, 0) - q_coeffs(P, 1, 1))
    _, _, Vt = np.linalg.svd(np.stack(rows))
    q = Vt[-1]
    Q = np.zeros((4, 4))
    for n, (a, b) in enumerate(_Q_INDEX):
        Q[a, b] = q[n]
        Q[b, a] = q[n]
    # sign: make Q* positive semi-definite (rank 3)
    w, v = np.linalg.eigh(Q)
    if w.sum() < 0:
        Q = -Q
        w, v = np.linalg.eigh(Q)
    # DecomposeAbsoluteDualQuadratic: Q* = H diag(1, 1, 1, 0) Hᵀ
    order = np.argsort(w)[::-1]
    w = w[order]
    v = v[:, order]
    H = v[:, :4].copy()
    H[:, :3] = v[:, :3] * np.sqrt(np.clip(w[:3], 1e-12, None))
    H[:, 3] = v[:, 3]
    # K of camera 0 from w0 = P0 Q* P0ᵀ = K Kᵀ, K upper triangular: the
    # Cholesky factor of the inverse
    w0 = Ps[0] @ Q @ Ps[0].T
    w0 = w0 / w0[2, 2]
    Winv = np.linalg.inv((w0 + w0.T) / 2.0 + 1e-12 * np.eye(3))
    K = np.linalg.inv(np.linalg.cholesky(Winv).T)
    return K / K[2, 2], H


def projective_structure_factorization(obs, iterations: int = 10,
                                       device=None):
    """Projective structure by factorization (Sturm-Triggs;
    ProjectiveStructureByFactorization.java).

    obs: [V, N, 2] observations of N points in V views (every point seen in
    every view).  Each iteration balances the projective depths, factors
    the depth-scaled [3V, N] measurement matrix at rank 4 by SVD into
    cameras [V, 3, 4] and points [N, 4], and re-estimates the depths.
    Returns (Ps [V, 3, 4], X [N, 4]) float64, up to a common projective
    transform (the SVD's signs are the library's; products P X are not)."""
    obs = as_tensor(obs, torch.float64, device)
    V, N = obs.shape[0], obs.shape[1]
    # Hartley-style normalization per view, for conditioning
    mean = torch.mean(obs, dim=1, keepdim=True)
    scale = torch.mean(torch.linalg.vector_norm(obs - mean, dim=-1),
                       dim=1)[:, None, None] / np.sqrt(2.0)
    scale = torch.where(scale < 1e-12, 1.0, scale)
    on = (obs - mean) / scale
    hom = torch.cat([on, torch.ones_like(on[..., :1])], dim=-1)   # [V, N, 3]
    lam = torch.ones((V, N), dtype=torch.float64, device=obs.device)
    Ps = Xh = None
    for _ in range(iterations):
        # balance depths (row, then column normalization)
        lam = lam / torch.linalg.vector_norm(lam, dim=1, keepdim=True)
        lam = lam / torch.linalg.vector_norm(lam, dim=0, keepdim=True)
        M = (lam[..., None] * hom).permute(0, 2, 1).reshape(3 * V, N)
        U, s, Vt = torch.linalg.svd(M, full_matrices=False)
        Ps = (U[:, :4] * s[:4]).reshape(V, 3, 4)
        Xh = Vt[:4].T                                           # [N, 4]
        lam = torch.einsum("vij,nj->vni", Ps, Xh)[..., 2]
    # undo the normalization: x = x_n * scale + mean
    T = torch.zeros((V, 3, 3), dtype=torch.float64, device=obs.device)
    T[:, 0, 0] = scale[:, 0, 0]
    T[:, 1, 1] = scale[:, 0, 0]
    T[:, 0, 2] = mean[:, 0, 0]
    T[:, 1, 2] = mean[:, 0, 1]
    T[:, 2, 2] = 1.0
    return torch.einsum("vij,vjk->vik", T, Ps), Xh


def guess_and_check_focus(Ps, focal_candidates=None,
                          principal_at_origin: bool = True):
    """Brute-force focal self-calibration (SelfCalibrationGuessAndCheckFocus):
    for each candidate focal (shared, principal point at the origin) find
    the plane at infinity p that best makes every camera's P Q*(p) Pᵀ match
    K Kᵀ (10 Gauss-Newton steps from 0, forward differences, least squares),
    and keep the focal whose match is closest.

    Ps: [V, 3, 4] projective cameras with P1 = [I | 0].  Returns (f_best,
    H [4, 4]) with P_metric = P H, numpy float64."""
    Ps = np.asarray(Ps, np.float64)
    if focal_candidates is None:
        focal_candidates = np.geomspace(0.3, 3.0, 40)  # normalized units

    best = (np.inf, None, None)
    for f in focal_candidates:
        w1 = np.diag([f, f, 1.0]) @ np.diag([f, f, 1.0]).T

        def q_of(p):
            # Q*(p) = [[w1, -w1 p], [-pᵀ w1, pᵀ w1 p]]
            top = np.concatenate([w1, -(w1 @ p)[:, None]], axis=1)
            bot = np.concatenate([-(w1 @ p)[None, :],
                                  [[float(p @ w1 @ p)]]], axis=1)
            return np.concatenate([top, bot], axis=0)

        def resid(pv):
            Q = q_of(pv)
            r = []
            for i in range(1, Ps.shape[0]):
                wi = Ps[i] @ Q @ Ps[i].T
                wi = wi / np.linalg.norm(wi)
                r.append((wi - w1 / np.linalg.norm(w1)).ravel())
            return np.concatenate(r)

        p = np.zeros(3)
        for _ in range(10):
            r0 = resid(p)
            J = np.zeros((r0.size, 3))
            eps = 1e-6
            for k in range(3):
                dp = np.zeros(3)
                dp[k] = eps
                J[:, k] = (resid(p + dp) - r0) / eps
            try:
                dp = np.linalg.lstsq(J, -r0, rcond=None)[0]
            except np.linalg.LinAlgError:
                break
            p = p + dp
            if np.linalg.norm(dp) < 1e-12:
                break
        score = float(np.sum(resid(p) ** 2)) if Ps.shape[0] > 1 else 0.0
        if score < best[0]:
            best = (score, float(f), p.copy())

    _, f_best, p = best
    K = np.diag([f_best, f_best, 1.0])
    H = np.eye(4)
    H[:3, :3] = K
    H[3, :3] = -p @ K
    return f_best, H
