"""Trifocal tensor estimation and transfer (port of
``boofcv_tpu/geo/trifocal.py``, whole).

Reference analog: boofcv-geo alg/geo/trifocal/ — TrifocalLinearPoint7.java
(linear 7+ point solve with normalization), TrifocalTransfer.java (point
transfer), TrifocalExtractGeometries.java (epipoles + camera matrices),
TrifocalAlgebraicPoint7.java (algebraic refinement).

Float64 throughout.  The linear solve is one batched [..., 4N, 27]
nullspace (the eigenvector of the least eigenvalue of AᵀA), so a RANSAC
bank of samples solves in one call; transfer broadcasts a [..., 3, 3, 3]
tensor against [N] points.  An eigenvector's sign and a QR basis are each
library's own choice: tensors agree with the reference up to scale and
sign, epipoles up to sign.  ``torch.linalg.eigh`` and ``qr`` read their
status on the host on the card (one sync each).
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch.geo.epipolar import (_smallest_singular_vector,
                                           normalize_points)
from boofcv_tpu_torch.geo.smalllinalg import _eigh_sym, inv3

_F64 = torch.float64


def _design_rows(p1, p2, p3):
    """Linear constraints, four a correspondence (i, l in {0, 1}):
      x1^k (x2^i x3^l T_k[2,2] - x3^l T_k[i,2] - x2^i T_k[2,l] + T_k[i,l]) = 0
    with T flattened k*9 + a*3 + b.  [..., N, 2] each -> [..., 4N, 27]."""
    x1 = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    rows = []
    for i in range(2):
        for l in range(2):
            coef = torch.zeros(p1.shape[:-1] + (27,), dtype=_F64,
                               device=p1.device)
            for k in range(3):
                base = x1[..., k]
                coef[..., k * 9 + 8] = base * p2[..., i] * p3[..., l]
                coef[..., k * 9 + i * 3 + 2] = -base * p3[..., l]
                coef[..., k * 9 + 6 + l] = -base * p2[..., i]
                coef[..., k * 9 + i * 3 + l] = base
            rows.append(coef)
    return torch.cat(rows, dim=-2)


def _denormalize(Tn, N1, N2, N3):
    """T'_k = N2⁻¹ (Σ_r N1[r, k] T_r) N3⁻ᵀ, unit Frobenius norm."""
    mix = torch.einsum("...rk,...rij->...kij", N1, Tn)
    T = torch.einsum("...ia,...kab,...jb->...kij", inv3(N2), mix, inv3(N3))
    norm = torch.sqrt(torch.sum(T ** 2, dim=(-3, -2, -1), keepdim=True))
    return T / torch.where(norm == 0, 1.0, norm)


def trifocal_linear(p1, p2, p3):
    """Linear trifocal tensor from N >= 7 triple correspondences
    (TrifocalLinearPoint7).  p1/p2/p3: [..., N, 2] pixels.  Returns T
    [..., 3, 3, 3] with unit Frobenius norm."""
    n1, T1 = normalize_points(p1)
    n2, T2 = normalize_points(p2)
    n3, T3 = normalize_points(p3)
    t = _smallest_singular_vector(_design_rows(n1, n2, n3))
    return _denormalize(t.reshape(t.shape[:-1] + (3, 3, 3)), T1, T2, T3)


def transfer_1_to_3(T, p1, p2):
    """Point transfer view 1 + view 2 -> view 3
    (TrifocalTransfer.transfer_1_to_3).  T [..., 3, 3, 3] broadcasts
    against p1, p2 [N, 2] (a bank of K tensors gives [K, N, 2]).

    Two lines through x2, vertical (1, 0, -x2) and horizontal (0, 1, -y2);
    per point the one whose transferred vector is larger before
    dehomogenization (a line on x2's epipolar line transfers to ~0)."""
    x1 = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    one = torch.ones_like(p2[..., 0])
    zero = torch.zeros_like(p2[..., 0])
    l2v = torch.stack([one, zero, -p2[..., 0]], dim=-1)
    l2h = torch.stack([zero, one, -p2[..., 1]], dim=-1)
    x3v = torch.einsum("...nk,...ni,...kij->...nj", x1, l2v, T)
    x3h = torch.einsum("...nk,...ni,...kij->...nj", x1, l2h, T)
    use_v = (torch.linalg.vector_norm(x3v, dim=-1)
             >= torch.linalg.vector_norm(x3h, dim=-1))[..., None]
    x3 = torch.where(use_v, x3v, x3h)
    w = x3[..., 2]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return x3[..., :2] / w[..., None]


def transfer_error(T, p1, p2, p3):
    """Squared transfer error in view 3 (DistanceTrifocalTransferSq,
    single direction)."""
    pred = transfer_1_to_3(T, p1, p2)
    return torch.sum((pred - p3) ** 2, dim=-1)


def extract_epipoles(T):
    """Epipoles e2, e3 (unit norm) of one tensor [3, 3, 3]
    (TrifocalExtractGeometries): e2 is the common left null vector of the
    T_k, e3 the common right one."""
    U = torch.stack([_eigh_sym(T[k] @ T[k].T)[1][:, 0] for k in range(3)])
    V = torch.stack([_eigh_sym(T[k].T @ T[k])[1][:, 0] for k in range(3)])
    e2 = _eigh_sym(U.T @ U)[1][:, 0]
    e3 = _eigh_sym(V.T @ V)[1][:, 0]
    return e2 / torch.linalg.norm(e2), e3 / torch.linalg.norm(e3)


def tensor_from_cameras(P2, P3):
    """T_k[i, j] = P2[i, k] P3[j, 3] - P2[i, 3] P3[j, k] with P1 = [I | 0]
    (MultiViewOps.createTrifocal), unit Frobenius norm."""
    P2 = P2.to(_F64)
    P3 = P3.to(_F64)
    T = torch.stack([P2[:, k:k + 1] @ P3[:, 3:4].T
                     - P2[:, 3:4] @ P3[:, k:k + 1].T for k in range(3)])
    return T / torch.sqrt(torch.sum(T ** 2))


def _tensor_from_epipoles_ls(M, e2, e3):
    """Inner solve of the algebraic minimization: for given epipoles the
    geometrically valid tensor minimizing ||M t|| with ||t|| = 1 over
    t = E(e2, e3) [a; b] (HZ Algorithm 16.2: T_k[i,j] = A[i,k] e3[j]
    - e2[i] B[j,k]).  Returns (t [27], M t)."""
    dev = M.device
    # E [27, 18]: column i*3+k holds A[i, k], column 9 + j*3+k holds B[j, k]
    k, i, j = torch.meshgrid(*(torch.arange(3, device=dev),) * 3,
                             indexing="ij")
    r = (k * 9 + i * 3 + j).reshape(-1)
    E = torch.zeros((27, 18), dtype=_F64, device=dev)
    E[r, (i * 3 + k).reshape(-1)] = e3[j.reshape(-1)]
    E[r, (9 + j * 3 + k).reshape(-1)] = -e2[i.reshape(-1)]
    Q, _ = torch.linalg.qr(E)                     # orthonormal basis [27, 18]
    MQ = M @ Q
    y = _eigh_sym(MQ.T @ MQ)[1][:, 0]
    t = Q @ y
    return t, M @ t


def trifocal_algebraic_refine(T0, p1, p2, p3, iterations: int = 10,
                              damping: float = 1e-8):
    """Algebraic refinement of a trifocal tensor
    (TrifocalAlgebraicPoint7.java:48): minimize ||M t|| over the six
    epipole parameters with the tensor held on the valid manifold (HZ
    Algorithm 16.2): the inner linear solve per epipole guess, an outer
    Gauss-Newton with a forward-difference Jacobian whose step is kept only
    where it lowers the residual.  p1/p2/p3: [N, 2] pixels.  Returns T
    [3, 3, 3], unit norm."""
    n1, N1 = normalize_points(p1)
    n2, N2 = normalize_points(p2)
    n3, N3 = normalize_points(p3)
    M = _design_rows(n1, n2, n3).reshape(-1, 27)

    # initial epipoles from T0 carried into the conditioned coordinates
    # (the inverse of trifocal_linear's denormalization)
    mixed = torch.einsum("ia,kab,jb->kij", N2, T0.to(_F64), N3)
    Tn = torch.einsum("rk,rij->kij", inv3(N1), mixed)
    Tn = Tn / torch.sqrt(torch.sum(Tn ** 2))
    e2, e3 = extract_epipoles(Tn)

    def solve(e):
        return _tensor_from_epipoles_ls(M, e[:3] / torch.linalg.norm(e[:3]),
                                        e[3:] / torch.linalg.norm(e[3:]))

    eps = 1e-7
    eye6 = torch.eye(6, dtype=_F64, device=M.device)
    e = torch.cat([e2, e3])
    for _ in range(iterations):
        _, r0 = solve(e)
        cols = []
        for d in range(6):
            ep = e.clone()
            ep[d] += eps
            _, r = solve(ep)
            # sign-align with r0 so the differences are smooth
            r = r * torch.sign(torch.sum(r * r0) + 1e-300)
            cols.append((r - r0) / eps)
        J = torch.stack(cols, dim=-1)
        w, v = _eigh_sym(J.T @ J + damping * eye6)
        step = v @ ((v.T @ (J.T @ r0)) / torch.clamp(w, min=1e-12))
        e_new = e - step
        _, r_new = solve(e_new)
        better = torch.sum(r_new ** 2) < torch.sum(r0 ** 2)
        e = torch.where(better, e_new, e)
    t_fin, _ = solve(e)
    return _denormalize(t_fin.reshape(3, 3, 3), N1, N2, N3)
