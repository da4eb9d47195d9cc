"""Colour-space conversions (port of ``boofcv_tpu/ip/color.py``).

Reference analog: boofcv-ip alg/color/*.  Elementwise on [..., 3] float32
tensors (a trailing channel axis); RGB in [0, 255] (or [0, 1] for the
XYZ / Lab functions), HSV hue in radians [0, 2pi) as in ColorHsv.java.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from boofcv_tpu_torch._config import as_tensor

# sRGB D65 matrices (ColorXyz.java) and the D65 white point (ColorLab.java)
_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_XYZ2RGB = ((3.240479, -1.53715, -0.498535),
            (-0.969256, 1.875991, 0.041556),
            (0.055648, -0.204043, 1.057311))
_D65 = (0.950456, 1.0, 1.088754)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """Plain band mean (BoofCV's Planar -> gray)."""
    return torch.mean(rgb.to(torch.float32), dim=-1)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """ColorHsv.rgbToHsv: h in radians [0, 2pi), s in [0, 1], v = max."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = v - mn
    s = torch.where(v != 0, delta / v, 0.0)
    safe = torch.where(delta == 0, 1.0, delta)
    hr = (g - b) / safe
    hg = 2.0 + (b - r) / safe
    hb = 4.0 + (r - g) / safe
    h = torch.where(r == v, hr, torch.where(g == v, hg, hb))
    h = h * (math.pi / 3.0)
    # hue wraps into [0, 2pi): negative sectors of the red branch go round
    h = torch.where(h < 0, h + 2 * math.pi, h)
    h = torch.where(delta == 0, 0.0, h)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h6 = h / (math.pi / 3.0)
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def rgb_to_yuv(rgb: torch.Tensor) -> torch.Tensor:
    """ColorYuv.rgbToYuv (analog YUV, not YCbCr)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = 0.492 * (b - y)
    v = 0.877 * (r - y)
    return torch.stack([y, u, v], dim=-1)


def yuv_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    y, u, v = yuv[..., 0], yuv[..., 1], yuv[..., 2]
    r = y + 1.13983 * v
    g = y - 0.39465 * u - 0.58060 * v
    b = y + 2.032 * u
    return torch.stack([r, g, b], dim=-1)


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """The sRGB piecewise curve: linear below 0.04045, a 2.4 power above."""
    return torch.where(c <= 0.04045, c / 12.92,
                       ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.0031308, 12.92 * c,
                       1.055 * c ** (1 / 2.4) - 0.055)


def _mat3(x: torch.Tensor, m) -> torch.Tensor:
    """x [..., 3] times the rows of a 3x3 matrix: [..., 3].  The matrix's
    entries are Python scalars (float32 in the product), so nothing is
    copied to the device."""
    c0, c1, c2 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack([c0 * a + c1 * b + c2 * c for a, b, c in m], dim=-1)


def _per_channel(x: torch.Tensor, op, consts) -> torch.Tensor:
    return torch.stack([op(x[..., i], k) for i, k in enumerate(consts)],
                       dim=-1)


def rgb_to_xyz(rgb_unit: torch.Tensor) -> torch.Tensor:
    """ColorXyz.rgbToXyz on [0, 1] RGB (sRGB gamma linearized first)."""
    return _mat3(_srgb_to_linear(rgb_unit), _RGB2XYZ)


def xyz_to_rgb(xyz: torch.Tensor) -> torch.Tensor:
    return _linear_to_srgb(torch.clamp(_mat3(xyz, _XYZ2RGB), 0.0, 1.0))


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has no ``cbrt``): the float64 power of |x|,
    rounded once to float32, with the sign put back."""
    r = torch.abs(x).to(torch.float64) ** (1.0 / 3.0)
    return (torch.sign(x) * r.to(x.dtype))


def xyz_to_lab(xyz: torch.Tensor) -> torch.Tensor:
    """ColorLab.java: CIELAB with the D65 white point."""
    xr = _per_channel(xyz, torch.div, _D65)
    eps = 0.008856
    kap = 903.3
    f = torch.where(xr > eps, _cbrt(xr), (kap * xr + 16.0) / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([L, a, b], dim=-1)


def lab_to_xyz(lab: torch.Tensor) -> torch.Tensor:
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    eps = 0.008856
    kap = 903.3

    def inv(f):
        f3 = f ** 3
        return torch.where(f3 > eps, f3, (116.0 * f - 16.0) / kap)

    x = inv(fx)
    y = torch.where(L > kap * eps, ((L + 16.0) / 116.0) ** 3, L / kap)
    z = inv(fz)
    return torch.stack([x * _D65[0], y * _D65[1], z * _D65[2]], dim=-1)


def rgb_to_lab(rgb_unit: torch.Tensor) -> torch.Tensor:
    return xyz_to_lab(rgb_to_xyz(rgb_unit))


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    return xyz_to_rgb(lab_to_xyz(lab))


def yuv420_to_rgb(y_plane, u_plane, v_plane, device=None) -> torch.Tensor:
    """Planar YUV 4:2:0 (e.g. Android Yuv420_888) -> RGB u8-range float32.

    Reference analog: boofcv-ip core/encoding/ConvertYuv420_888.java.
    y_plane [H, W]; u/v planes [H//2, W//2] (one chroma sample a 2x2 luma
    block), full-range BT.601 coefficients.  Chroma is upsampled 2x by
    nearest and edge-padded to an odd luma size."""
    y = as_tensor(y_plane, torch.float32, device)
    u = as_tensor(u_plane, torch.float32, device).to(y.device) - 128.0
    v = as_tensor(v_plane, torch.float32, device).to(y.device) - 128.0
    h, w = y.shape

    def up(c):
        c2 = c.repeat_interleave(2, 0).repeat_interleave(2, 1)
        pad_y, pad_x = max(h - c2.shape[0], 0), max(w - c2.shape[1], 0)
        if pad_y or pad_x:
            c2 = F.pad(c2[None, None], (0, pad_x, 0, pad_y),
                       mode="replicate")[0, 0]
        return c2[:h, :w]
    u = up(u)
    v = up(v)
    r = y + 1.402 * v
    g = y - 0.34414 * u - 0.71414 * v
    b = y + 1.772 * u
    return torch.clamp(torch.stack([r, g, b], -1), 0.0, 255.0)


def rgb_to_yuv420(rgb, device=None):
    """RGB -> planar YUV 4:2:0 (2x2-averaged chroma), the inverse of
    :func:`yuv420_to_rgb`.  Returns float planes (y [H, W], u and v
    [H//2, W//2]); a caller storing bytes rounds them itself."""
    rgb = as_tensor(rgb, torch.float32, device)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.1687 * r - 0.3313 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.4187 * g - 0.0813 * b + 128.0
    h, w = y.shape
    h2, w2 = h - h % 2, w - w % 2
    du = u[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(dim=(1, 3))
    dv = v[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(dim=(1, 3))
    return y, du, dv
