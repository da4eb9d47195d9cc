"""Convolution (port of ``boofcv_tpu/ip/convolve.py``: ``horizontal``,
``vertical``, ``convolve2d``, ``separable``; ``pad`` and ``pad_planes`` for
[..., H, W]).

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
    """VALID correlation of an (H, W) image with a (kh, kw) kernel."""
    kh, kw = kernel2d.shape
    oh, ow = image.shape[0] - kh + 1, image.shape[1] - kw + 1
    taps = kernel2d.to(device=image.device, dtype=image.dtype)
    out = None
    for i in range(kh):
        for j in range(kw):
            term = image[i:i + oh, j:j + ow] * taps[i, j]
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
