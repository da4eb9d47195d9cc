"""Image derivatives (port of ``boofcv_tpu/ip/derivative.py``).

Reference analog: boofcv-ip alg/filter/derivative/*.  BoofCV's convention
(GradientSobel.java): derivX grows with intensity left to right, derivY top
to bottom; cross-correlation with the stencils as written; EXTENDED border
unless the caller names another.  Sobel works on [..., H, W]; the other
stencils go through ``ip/convolve`` on [H, W], their kernels made on the
host and read as numbers (no copy to the card)."""

from __future__ import annotations

import torch

from boofcv_tpu_torch.core.border import BorderType
from boofcv_tpu_torch.ip import convolve


def sobel(image: torch.Tensor, border: BorderType = BorderType.EXTENDED):
    """Sobel gradient (GradientSobel.java) of an [..., H, W] image.
    Returns (derivX, derivY).

    Shifted adds on the 1-pixel padded image (no TF32-capable conv)."""
    img = image.to(torch.float32)
    h, w = img.shape[-2:]
    p = convolve.pad_planes(img, 1, 1, border)

    def at(dy, dx):
        return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    dx = ((at(-1, 1) - at(-1, -1)) + 2.0 * (at(0, 1) - at(0, -1))
          + (at(1, 1) - at(1, -1)))
    dy = ((at(1, -1) - at(-1, -1)) + 2.0 * (at(1, 0) - at(-1, 0))
          + (at(1, 1) - at(-1, 1)))
    return dx, dy


_DERIV_3 = (-1.0, 0.0, 1.0)


def _k(*rows) -> torch.Tensor:
    return torch.tensor(rows if len(rows) > 1 else rows[0],
                        dtype=torch.float32)


def _separable_gradient(image, smooth, border):
    img = image.to(torch.float32)
    d, s = _k(_DERIV_3), _k(smooth)
    dx = convolve.vertical(convolve.horizontal(img, d, border), s, border)
    dy = convolve.horizontal(convolve.vertical(img, d, border), s, border)
    return dx, dy


def prewitt(image: torch.Tensor, border: BorderType = BorderType.EXTENDED):
    """Prewitt gradient (GradientPrewitt.java): [1, 1, 1] smoothing."""
    return _separable_gradient(image, (1.0, 1.0, 1.0), border)


def _difference(image, kernel, border):
    img = image.to(torch.float32)
    k = _k(kernel)
    return (convolve.horizontal(img, k, border),
            convolve.vertical(img, k, border))


def three(image: torch.Tensor, border: BorderType = BorderType.EXTENDED):
    """Central-difference gradient (GradientThree.java): [-0.5, 0, 0.5]."""
    return _difference(image, (-0.5, 0.0, 0.5), border)


def two0(image: torch.Tensor, border: BorderType = BorderType.EXTENDED):
    """Forward difference f(x+1) - f(x) (GradientTwo0.java)."""
    return _difference(image, (0.0, -1.0, 1.0), border)


def two1(image: torch.Tensor, border: BorderType = BorderType.EXTENDED):
    """Backward difference f(x) - f(x-1) (GradientTwo1.java)."""
    return _difference(image, (-1.0, 1.0, 0.0), border)


def laplacian(image: torch.Tensor, border: BorderType = BorderType.EXTENDED):
    """4-connected Laplacian (DerivativeLaplacian.java)."""
    k = _k((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))
    return convolve.convolve2d(image.to(torch.float32), k, border)


def hessian_three(image: torch.Tensor,
                  border: BorderType = BorderType.EXTENDED):
    """Second derivatives from the image (HessianThree.java): (dxx, dyy,
    dxy), [0.5, 0, -1, 0, 0.5] for dxx and dyy, a /4 cross for dxy."""
    img = image.to(torch.float32)
    k2 = _k((0.5, 0.0, -1.0, 0.0, 0.5))
    kxy = _k((0.25, 0.0, -0.25), (0.0, 0.0, 0.0), (-0.25, 0.0, 0.25))
    return (convolve.horizontal(img, k2, border),
            convolve.vertical(img, k2, border),
            convolve.convolve2d(img, kxy, border))


def hessian_from_gradient(dx: torch.Tensor, dy: torch.Tensor,
                          border: BorderType = BorderType.EXTENDED):
    """Hessian by differentiating the gradient with Sobel
    (HessianFromGradient.java): (dxx, dyy, dxy)."""
    dxx, dxy = sobel(dx, border)
    _, dyy = sobel(dy, border)
    return dxx, dyy, dxy


def gradient_magnitude_angle(dx: torch.Tensor, dy: torch.Tensor):
    """(|g|, atan2(dy, dx)) of a gradient."""
    return torch.sqrt(dx * dx + dy * dy), torch.arctan2(dy, dx)
