"""Integral images (port of ``boofcv_tpu/ip/integral.py``).

Reference analog: boofcv-ip alg/transform/ii/*.  BoofCV convention
(IntegralImageOps.transform): ``II[y, x] = sum of I over rows 0..y, cols
0..x`` *inclusive*, so II has the image's shape and block sums use the
exclusive-corner trick with an implicit zero row and column above and left
of the image.  The prefix sums run in float32, as the reference's do: past
2^24 they round.

Box and Haar features read four corners each; the ``_grid`` forms evaluate
one feature at every pixel from shifted copies of the whole image.
"""

from __future__ import annotations

import torch


def transform(image: torch.Tensor) -> torch.Tensor:
    """Inclusive 2D prefix sum, same shape as the input."""
    return torch.cumsum(torch.cumsum(image.to(torch.float32), dim=0), dim=1)


def _sample(ii: torch.Tensor, y, x) -> torch.Tensor:
    """II at (y, x); -1 (or less) reads the implicit zero row / column,
    larger indices clamp into the image."""
    h, w = ii.shape
    y, x = torch.broadcast_tensors(torch.as_tensor(y, device=ii.device),
                                   torch.as_tensor(x, device=ii.device))
    vals = ii[torch.clamp(y, 0, h - 1).long(), torch.clamp(x, 0, w - 1).long()]
    return torch.where((y >= 0) & (x >= 0), vals, 0.0)


def block_sum(ii: torch.Tensor, x0, y0, x1, y1) -> torch.Tensor:
    """Sum of the pixels in the inclusive rectangle [x0..x1] x [y0..y1]
    (IntegralImageOps.block_zero).  The corners may be tensors
    (broadcast)."""
    x0 = x0 - 1
    y0 = y0 - 1
    br = _sample(ii, y1, x1)
    tl = _sample(ii, y0, x0)
    tr = _sample(ii, y0, x1)
    bl = _sample(ii, y1, x0)
    return br + tl - tr - bl


def _shift_axis(ii: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    n = ii.shape[dim]
    k = min(abs(d), n)
    if d > 0:       # read below / right: the last row or column repeats
        edge = ii.narrow(dim, n - 1, 1)
        reps = [k if i == dim else -1 for i in range(2)]
        return torch.cat([ii.narrow(dim, k, n - k), edge.expand(reps)], dim)
    if d < 0:       # read above / left: zeros
        zeros = torch.zeros_like(ii.narrow(dim, 0, k))
        return torch.cat([zeros, ii.narrow(dim, 0, n - k)], dim)
    return ii


def _shift_static(ii: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """II sampled at (y+dy, x+dx) for every pixel with :func:`_sample`'s
    border rule (zeros above and left, clamp below and right)."""
    return _shift_axis(_shift_axis(ii, dy, 0), dx, 1)


def block_sum_grid(ii: torch.Tensor, x0: int, y0: int, x1: int,
                   y1: int) -> torch.Tensor:
    """:func:`block_sum` at every pixel: the corners are static offsets
    from the pixel.  Returns [H, W]."""
    br = _shift_static(ii, y1, x1)
    tl = _shift_static(ii, y0 - 1, x0 - 1)
    tr = _shift_static(ii, y0 - 1, x1)
    bl = _shift_static(ii, y1, x0 - 1)
    return br + tl - tr - bl


def deriv_xx_grid(ii: torch.Tensor, size: int) -> torch.Tensor:
    """Whole-image :func:`deriv_xx` (same filter layout)."""
    b = size // 3
    r = size // 2
    hy = (2 * b - 1) // 2
    total = block_sum_grid(ii, -r, -hy, r, hy)
    mid = block_sum_grid(ii, -(b // 2), -hy, -(b // 2) + b - 1, hy)
    return total - 3.0 * mid


def deriv_yy_grid(ii: torch.Tensor, size: int) -> torch.Tensor:
    b = size // 3
    r = size // 2
    hx = (2 * b - 1) // 2
    total = block_sum_grid(ii, -hx, -r, hx, r)
    mid = block_sum_grid(ii, -hx, -(b // 2), hx, -(b // 2) + b - 1)
    return total - 3.0 * mid


def deriv_xy_grid(ii: torch.Tensor, size: int) -> torch.Tensor:
    b = size // 3
    tl = block_sum_grid(ii, -b, -b, -1, -1)
    tr = block_sum_grid(ii, 1, -b, b, -1)
    bl = block_sum_grid(ii, -b, 1, -1, b)
    br = block_sum_grid(ii, 1, 1, b, b)
    return tl + br - tr - bl


def haar_x(ii: torch.Tensor, cy, cx, radius) -> torch.Tensor:
    """Haar x-wavelet response at centre (cy, cx): right half minus left
    half (DerivativeIntegralImage.kernelHaarX region layout)."""
    r = radius
    right = block_sum(ii, cx, cy - r, cx + r - 1, cy + r - 1)
    left = block_sum(ii, cx - r, cy - r, cx - 1, cy + r - 1)
    return right - left


def haar_y(ii: torch.Tensor, cy, cx, radius) -> torch.Tensor:
    r = radius
    bottom = block_sum(ii, cx - r, cy, cx + r - 1, cy + r - 1)
    top = block_sum(ii, cx - r, cy - r, cx + r - 1, cy - 1)
    return bottom - top


def deriv_xx(ii: torch.Tensor, cy, cx, size) -> torch.Tensor:
    """Approximate d^2/dx^2 box filter of SURF's Fast Hessian
    (DerivativeIntegralImage.kernelDerivXX; size = block size, e.g. 9):
    three vertical bands of width size/3, the middle one weighted -2."""
    b = size // 3                     # lobe width
    r = size // 2
    hy = (2 * b - 1) // 2             # lobe height is 2b-1 centred at cy
    total = block_sum(ii, cx - r, cy - hy, cx + r, cy + hy)
    mid = block_sum(ii, cx - b // 2, cy - hy, cx - b // 2 + b - 1, cy + hy)
    return total - 3.0 * mid


def deriv_yy(ii: torch.Tensor, cy, cx, size) -> torch.Tensor:
    b = size // 3
    r = size // 2
    hx = (2 * b - 1) // 2
    total = block_sum(ii, cx - hx, cy - r, cx + hx, cy + r)
    mid = block_sum(ii, cx - hx, cy - b // 2, cx + hx, cy - b // 2 + b - 1)
    return total - 3.0 * mid


def deriv_xy(ii: torch.Tensor, cy, cx, size) -> torch.Tensor:
    """d^2/dxdy box filter: four b x b blocks in the quadrants."""
    b = size // 3
    tl = block_sum(ii, cx - b, cy - b, cx - 1, cy - 1)
    tr = block_sum(ii, cx + 1, cy - b, cx + b, cy - 1)
    bl = block_sum(ii, cx - b, cy + 1, cx - 1, cy + b)
    br = block_sum(ii, cx + 1, cy + 1, cx + b, cy + b)
    return tl + br - tr - bl
