"""Convolution (port of ``boofcv_tpu/ip/convolve.py``: ``horizontal``,
``vertical``, ``convolve2d``, ``separable``, ``convolve_down``,
``sparse_sample``; ``pad`` and ``pad_planes`` for [..., H, W]).

Reference analog: boofcv-ip alg/filter/convolve/*.

The port computes its stencils as shifted adds, one multiply-add per tap on
views of the padded image, instead of ``conv2d``, which cuDNN would run in
TF32 by default.

Conventions, as in the reference:
* kernels are correlation kernels (applied as written, scanning left to
  right), so asymmetric kernels need no flip;
* ``border=SKIP`` is the no-border variant: where the kernel does not fit,
  the output keeps the input pixel;
* ``border=NORMALIZED`` renormalizes the kernel over its in-image support:
  the zero-padded convolution divided by the same convolution of a ones
  image.
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch.core.border import (BorderType, pad,  # noqa: F401
                                          pad_planes)


def _conv2d_valid(image: torch.Tensor, kernel2d: torch.Tensor) -> torch.Tensor:
    """VALID correlation of an (H, W) image with a (kh, kw) kernel.  A
    kernel on another device than the image (a constant made on the host)
    is read as Python numbers: copying it up would cost a host sync."""
    kh, kw = kernel2d.shape
    oh, ow = image.shape[0] - kh + 1, image.shape[1] - kw + 1
    taps = kernel2d.to(dtype=image.dtype)
    if taps.device != image.device:
        taps = taps.tolist()
    out = None
    for i in range(kh):
        for j in range(kw):
            term = image[i:i + oh, j:j + ow] * taps[i][j]
            out = term if out is None else out + term
    return out


def horizontal(image: torch.Tensor, kernel: torch.Tensor,
               border: BorderType = BorderType.SKIP) -> torch.Tensor:
    """1D horizontal convolution (ConvolveImageNoBorder.horizontal etc.)."""
    return convolve2d(image, torch.as_tensor(kernel)[None, :], border)


def vertical(image: torch.Tensor, kernel: torch.Tensor,
             border: BorderType = BorderType.SKIP) -> torch.Tensor:
    """1D vertical convolution."""
    return convolve2d(image, torch.as_tensor(kernel)[:, None], border)


def convolve2d(image: torch.Tensor, kernel2d: torch.Tensor,
               border: BorderType = BorderType.SKIP) -> torch.Tensor:
    """2D convolution (GConvolveImageOps.convolve)."""
    kernel2d = torch.as_tensor(kernel2d)
    ry = (kernel2d.shape[0] - 1) // 2
    rx = (kernel2d.shape[1] - 1) // 2
    if border == BorderType.SKIP:
        h, w = image.shape
        out = image.clone()
        out[ry:h - ry, rx:w - rx] = _conv2d_valid(image, kernel2d)
        return out
    if border == BorderType.NORMALIZED:
        num = _conv2d_valid(pad(image, ry, rx, BorderType.ZERO), kernel2d)
        den = _conv2d_valid(pad(torch.ones_like(image), ry, rx,
                                BorderType.ZERO), kernel2d)
        ksum = torch.sum(kernel2d).to(device=image.device, dtype=image.dtype)
        return num * (ksum / den)
    return _conv2d_valid(pad(image, ry, rx, border), kernel2d)


def separable(image: torch.Tensor, kernel_x: torch.Tensor,
              kernel_y: torch.Tensor,
              border: BorderType = BorderType.EXTENDED) -> torch.Tensor:
    """Separable convolution: horizontal then vertical (BlurImageOps)."""
    return vertical(horizontal(image, kernel_x, border), kernel_y, border)


def convolve_down(image: torch.Tensor, kernel: torch.Tensor, skip: int,
                  axis: int) -> torch.Tensor:
    """Convolve-and-decimate along ``axis`` (1: x, 0: y) with an EXTENDED
    border (ConvolveImageDownNoBorder): every ``skip``-th output of the
    full-resolution correlation, starting at 0."""
    kernel = torch.as_tensor(kernel)
    radius = (kernel.shape[0] - 1) // 2
    if axis == 1:
        full = _conv2d_valid(pad(image, 0, radius, BorderType.EXTENDED),
                             kernel[None, :])
        return full[:, ::skip]
    full = _conv2d_valid(pad(image, radius, 0, BorderType.EXTENDED),
                         kernel[:, None])
    return full[::skip, :]


def sparse_sample(image: torch.Tensor, kernel2d: torch.Tensor,
                  ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """A 2D kernel evaluated at N integer pixel centres (ys, xs) [N]
    (ConvolveImageSparse), EXTENDED border; in the kernel's dtype."""
    kernel2d = torch.as_tensor(kernel2d).to(image.device)
    kh, kw = kernel2d.shape
    ry, rx = (kh - 1) // 2, (kw - 1) // 2
    h, w = image.shape
    dy = torch.arange(-ry, ry + 1, device=image.device)
    dx = torch.arange(-rx, rx + 1, device=image.device)
    yy = torch.clamp(ys.long()[:, None, None] + dy[None, :, None], 0, h - 1)
    xx = torch.clamp(xs.long()[:, None, None] + dx[None, None, :], 0, w - 1)
    patches = image[yy, xx].to(kernel2d.dtype)             # [N, kh, kw]
    return torch.einsum("nij,ij->n", patches, kernel2d)
