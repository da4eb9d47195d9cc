"""Pixel interpolation (port of ``boofcv_tpu/ip/interpolate.py``:
``nearest``, ``bilinear``, ``bicubic``, ``in_bounds``,
``sample_rect_bilinear``, ``sample_rect_bilinear_multi``).

BoofCV convention: integer coordinates hit pixel centres; out-of-range
samples clamp (EXTENDED border).  Coordinates are floored before the cast
to an integer: ``.long()`` alone truncates toward zero, which is wrong for
negative coordinates.
"""

from __future__ import annotations

import torch


def nearest(image: torch.Tensor, ys: torch.Tensor,
            xs: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel sample of an [H, W] (or [H, W, C]) image at float
    coords of any matching shape (round half to even, as ``jnp.round``)."""
    h, w = image.shape[:2]
    yi = torch.round(ys).long().clamp(0, h - 1)
    xi = torch.round(xs).long().clamp(0, w - 1)
    return image[yi, xi]


def bilinear(image: torch.Tensor, ys: torch.Tensor,
             xs: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an [H, W] (or [H, W, C]) image at float coords of
    any matching shape."""
    h, w = image.shape[:2]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = (ys - y0).to(image.dtype)
    fx = (xs - x0).to(image.dtype)
    # clamp each tap from the UNCLAMPED floor (EXTENDED semantics for
    # coordinates in (-1, 0))
    y0l = y0.long()
    x0l = x0.long()
    y0i = y0l.clamp(0, h - 1)
    x0i = x0l.clamp(0, w - 1)
    y1i = (y0l + 1).clamp(0, h - 1)
    x1i = (x0l + 1).clamp(0, w - 1)
    v00 = image[y0i, x0i]
    v01 = image[y0i, x1i]
    v10 = image[y1i, x0i]
    v11 = image[y1i, x1i]
    if image.dim() == 3:
        fy = fy[..., None]
        fx = fx[..., None]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def _cubic_weights(t, a: float = -0.5):
    """Keys cubic convolution weights for offsets (-1, 0, 1, 2)."""
    t2 = t * t
    t3 = t2 * t
    return (a * (t3 - 2 * t2 + t),
            (a + 2) * t3 - (a + 3) * t2 + 1,
            -(a + 2) * t3 + (2 * a + 3) * t2 - a * t,
            a * (t2 - t3))


def bicubic(image: torch.Tensor, ys: torch.Tensor,
            xs: torch.Tensor) -> torch.Tensor:
    """Bicubic (Keys a = -0.5) sample of an [H, W] image at float coords of
    any matching shape, EXTENDED border.  The weights keep the coordinates'
    dtype, as the reference's do: float64 coordinates give a float64
    result from a float32 image."""
    h, w = image.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = _cubic_weights(ys - y0)
    wx = _cubic_weights(xs - x0)
    y0l = y0.long()
    x0l = x0.long()
    acc = 0.0
    for iy, wyi in enumerate(wy):
        yy = (y0l + (iy - 1)).clamp(0, h - 1)
        row = 0.0
        for ix, wxi in enumerate(wx):
            xx = (x0l + (ix - 1)).clamp(0, w - 1)
            row = row + image[yy, xx] * wxi
        acc = acc + row * wyi
    return acc


def _rect_taps(cy, cx, radius: int, h: int, w: int):
    """Flat indices [..., N, P+1, P+1] of each track's (P+1)^2 support, with
    the support's top-left clamped into the image, and the fractions."""
    p = 2 * radius + 1
    y0f = torch.floor(cy)
    x0f = torch.floor(cx)
    yi = (y0f.long() - radius).clamp(0, max(h - p - 1, 0))
    xi = (x0f.long() - radius).clamp(0, max(w - p - 1, 0))
    d = torch.arange(p + 1, device=cy.device)
    flat = ((yi[..., None, None] + d[:, None]) * w
            + (xi[..., None, None] + d[None, :]))
    return flat, cy - y0f, cx - x0f


def _blend(sl, fy, fx, p: int):
    return ((1 - fy) * (1 - fx) * sl[..., :p, :p]
            + (1 - fy) * fx * sl[..., :p, 1:]
            + fy * (1 - fx) * sl[..., 1:, :p]
            + fy * fx * sl[..., 1:, 1:])


def sample_rect_bilinear(image: torch.Tensor, cy: torch.Tensor,
                         cx: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 patches of an [..., H, W] image centred at float (cy, cx)
    [..., N] -> [..., N, P, P].  Centres whose support leaves the image
    clamp the support to the border (KLT masks such tracks separately)."""
    return sample_rect_bilinear_multi(image[..., None, :, :], cy, cx,
                                      radius)[..., 0, :, :, :]


def sample_rect_bilinear_multi(images: torch.Tensor, cy: torch.Tensor,
                               cx: torch.Tensor, radius: int) -> torch.Tensor:
    """:func:`sample_rect_bilinear` for an [..., C, H, W] stack, one index
    set shared across the channels.  Returns [..., C, N, P, P]."""
    p = 2 * radius + 1
    c, h, w = images.shape[-3:]
    lead = images.shape[:-3]
    img = images if images.is_floating_point() else images.to(torch.float32)
    flat, fy, fx = _rect_taps(cy, cx, radius, h, w)
    taps = flat.reshape(lead + (1, -1)).expand(lead + (c, -1))
    sl = img.reshape(lead + (c, h * w)).gather(-1, taps).reshape(
        lead + (c,) + flat.shape[len(lead):])        # [..., C, N, P+1, P+1]
    fy = fy.to(img.dtype)[..., None, :, None, None]
    fx = fx.to(img.dtype)[..., None, :, None, None]
    return _blend(sl, fy, fx, p)


def in_bounds(shape_hw, ys: torch.Tensor, xs: torch.Tensor,
              border: float = 0.0) -> torch.Tensor:
    """Mask of the coordinates whose bilinear support lies inside the
    image (``border`` pixels in from its edge)."""
    h, w = shape_hw
    return ((ys >= border) & (ys <= h - 1 - border)
            & (xs >= border) & (xs <= w - 1 - border))
