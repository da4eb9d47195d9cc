"""SE(3) / SO(3) utilities (port of ``boofcv_tpu/geo/se3.py``: ``hat``,
``exp_so3``, ``log_so3``, ``exp_se3``, ``compose``, ``invert``).

Rotations are 3x3 matrices; everything broadcasts over leading batch dims.
"""

from __future__ import annotations

import math

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: [..., 3] -> [..., 3, 3]."""
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    K = hat(w)
    K2 = K @ K
    small = t2 < 1e-14
    t2s = torch.where(small, 1.0, t2)
    theta = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    return _eye_like(K) + a * K + b * K2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] axis-angle, with the reference's small-angle
    series and near-pi axis recovery from the symmetric part."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = theta < 1e-7
    near_pi = theta > math.pi - 1e-3
    sin_safe = torch.where(small | near_pi, 1.0, torch.sin(theta))
    scale = torch.where(small, 0.5 + theta ** 2 / 12.0,
                        theta / (2.0 * sin_safe))
    w_generic = v * scale[..., None]
    S = (0.5 * (R + R.transpose(-1, -2))
         - cos_t[..., None, None] * torch.eye(3, dtype=R.dtype,
                                              device=R.device))
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], -1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(S, -1, k[..., None, None].expand(
        S.shape[:-1] + (1,)))[..., 0]
    nrm = torch.linalg.norm(col, dim=-1, keepdim=True)
    axis = col / torch.where(nrm < 1e-12, 1.0, nrm)
    sign = torch.where(torch.sum(axis * v, dim=-1, keepdim=True) < 0.0,
                       -1.0, 1.0)
    w_pi = theta[..., None] * axis * sign
    return torch.where(near_pi[..., None], w_pi, w_generic)


def exp_se3(xi: torch.Tensor):
    """se(3) exp: [..., 6] (rotation first) -> (R, t)."""
    w = xi[..., :3]
    v = xi[..., 3:]
    R = exp_so3(w)
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    K = hat(w)
    K2 = K @ K
    small = t2 < 1e-14
    t2s = torch.where(small, 1.0, t2)
    theta = torch.sqrt(t2s)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta)) / (t2s * theta))
    V = _eye_like(K) + b * K + c * K2
    t = (V @ v[..., None])[..., 0]
    return R, t


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): apply b then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def invert(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]
