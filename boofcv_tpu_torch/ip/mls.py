"""Moving-least-squares point-controlled image deformation (port of
``boofcv_tpu/ip/mls.py``).

Reference analog: boofcv-ip alg/distort/mls/ImageDeformPointMLS_F32.java
(Schaefer et al. 2006, affine and similarity variants).  The closed-form
solve is batched over every output pixel and every control point; the
dense warp is the inverse-map ``bilinear`` gather.
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch._config import as_tensor
from boofcv_tpu_torch.ip.interpolate import bilinear


def _weights(v, p, alpha: float = 2.0):
    """w_i = 1 / |p_i - v|^(2 alpha): v [..., 2], p [K, 2] -> [..., K]."""
    d2 = torch.sum((v[..., None, :] - p) ** 2, dim=-1)
    return 1.0 / torch.clamp(d2, min=1e-9) ** (alpha / 1.0)


def _frame(src_pts, dst_pts, height: int, width: int, alpha: float,
           device):
    """The control points (p in the output image, q where they come from),
    the pixel grid v [H, W, 2] (x, y), the weights and the weighted
    centroids p*, q*."""
    p = as_tensor(dst_pts, torch.float32, device)
    q = as_tensor(src_pts, torch.float32, device).to(p.device)
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=p.device),
        torch.arange(width, dtype=torch.float32, device=p.device),
        indexing="ij")
    v = torch.stack([xs, ys], dim=-1)
    w = _weights(v, p, alpha)                         # [H, W, K]
    wsum = torch.sum(w, dim=-1, keepdim=True)
    pstar = torch.einsum("hwk,kj->hwj", w, p) / wsum
    qstar = torch.einsum("hwk,kj->hwj", w, q) / wsum
    return p, q, v, w, pstar, qstar


def mls_affine(src_pts, dst_pts, height: int, width: int,
               alpha: float = 2.0, device=None):
    """Dense backward map of the affine MLS deformation: the output pixel v
    maps back to f(v) in the source; control points are [K, 2] (x, y).
    Returns (map_y, map_x) [H, W]."""
    p, q, v, w, pstar, qstar = _frame(src_pts, dst_pts, height, width,
                                      alpha, device)
    ph = p - pstar[..., None, :]                      # [H, W, K, 2]
    qh = q - qstar[..., None, :]
    # M = (sum w p^ p^T)^-1 (sum w p^ q^T); f(v) = (v - p*) M + q*
    A = torch.einsum("hwk,hwki,hwkj->hwij", w, ph, ph)
    B = torch.einsum("hwk,hwki,hwkj->hwij", w, ph, qh)
    det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    det = torch.where(torch.abs(det) < 1e-9, 1e-9, det)
    Ainv = torch.stack([
        torch.stack([A[..., 1, 1], -A[..., 0, 1]], -1),
        torch.stack([-A[..., 1, 0], A[..., 0, 0]], -1)],
        -2) / det[..., None, None]
    M = Ainv @ B
    f = torch.einsum("hwi,hwij->hwj", v - pstar, M) + qstar
    return f[..., 1], f[..., 0]


def mls_similarity(src_pts, dst_pts, height: int, width: int,
                   alpha: float = 2.0, device=None):
    """Similarity-constrained MLS backward map (rotation and scale)."""
    p, q, v, w, pstar, qstar = _frame(src_pts, dst_pts, height, width,
                                      alpha, device)
    ph = p - pstar[..., None, :]
    qh = q - qstar[..., None, :]
    mu = torch.clamp(torch.einsum("hwk,hwki->hw", w, ph * ph), min=1e-9)
    rel = v - pstar                                   # [H, W, 2]
    relp = torch.stack([rel[..., 1], -rel[..., 0]], dim=-1)   # -perp
    php = torch.stack([ph[..., 1], -ph[..., 0]], dim=-1)
    # A_i = w_i [p^; -p^perp] [v-p*; -(v-p*)perp]^T, f = sum q^ A_i / mu + q*
    r1 = torch.stack([torch.einsum("hwki,hwi->hwk", ph, rel),
                      torch.einsum("hwki,hwi->hwk", ph, relp)], dim=-1)
    r2 = torch.stack([torch.einsum("hwki,hwi->hwk", php, rel),
                      torch.einsum("hwki,hwi->hwk", php, relp)], dim=-1)
    Ai = torch.stack([r1, r2], dim=-2)                # [H, W, K, 2, 2]
    f = (torch.einsum("hwk,hwki,hwkij->hwj", w, qh, Ai) / mu[..., None]
         + qstar)
    return f[..., 1], f[..., 0]


def deform(image, src_pts, dst_pts, kind: str = "affine",
           alpha: float = 2.0, device=None) -> torch.Tensor:
    """Warp ``image`` so that the src control points land on the dst
    points."""
    img = as_tensor(image, torch.float32, device)
    h, w = img.shape[:2]
    fn = {"affine": mls_affine, "similarity": mls_similarity}[kind]
    my, mx = fn(src_pts, dst_pts, h, w, alpha, device=img.device)
    return bilinear(img, my, mx)
