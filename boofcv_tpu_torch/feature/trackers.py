"""Object trackers: circulant (KCF-style), mean-shift likelihood, SFOT and
Comaniciu 2003 (port of ``boofcv_tpu/feature/trackers.py``).

Reference analog: boofcv-recognition alg/tracker/ —
circulant/CirculantTracker.java (dense FFT correlation tracker),
meanshift/TrackerMeanShiftLikelihood.java (back-projection mean-shift),
sfot/SparseFlowObjectTracker.java, meanshift/TrackerMeanShiftComaniciu2003.

The circulant tracker's training and detection are elementwise in the
Fourier domain (``torch.fft``); the mean-shift trackers are iterated
weighted centroids with a fixed count of iterations and no host read
inside.  SFOT tracks a grid of points with ``klt.track_pyramid``, so on
the card it launches the ``klt_track`` kernel once a frame.  Dtypes follow
the JAX package under float64: the likelihood histogram and the
mean-shift centre after its first iteration are float64; the window's Hann
taper and the target response are computed in float64 and rounded to
float32 (the reference's weakly typed constants).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from boofcv_tpu_torch._config import as_tensor
from boofcv_tpu_torch.ip.interpolate import bilinear

F32 = torch.float32


class CirculantState(NamedTuple):
    """CirculantTracker work state (alphaf in the Fourier domain)."""
    alphaf: torch.Tensor     # [n, n] complex64
    template: torch.Tensor   # [n, n] float32 (z in the paper)
    cy: torch.Tensor         # scalar centre
    cx: torch.Tensor
    size: int                # region size (square)


def _hann2d(n: int, device) -> torch.Tensor:
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * torch.arange(
        n, dtype=torch.float64, device=device) / (n - 1))
    return (w[:, None] * w[None, :]).to(F32)


def _gauss_response(n: int, device,
                    sigma_factor: float = 0.0625) -> torch.Tensor:
    """The target response, built in the shifted frame with wrapped
    distances so the peak sits exactly at (0, 0) for any n.  sigma^2 is
    the reference's float32 value, computed on the host (no upload)."""
    sigma = np.sqrt(np.float32(n * n)) * np.float32(sigma_factor)
    y = (torch.arange(n, device=device) + n // 2) % n - n // 2
    d2 = y[:, None] ** 2 + y[None, :] ** 2
    return torch.exp((-0.5 * d2).to(F32) / float(sigma * sigma))


def _get_window(image: torch.Tensor, cy, cx, n: int) -> torch.Tensor:
    d = torch.arange(n, dtype=F32, device=image.device) - (n - 1) / 2.0
    win = bilinear(image, cy + d[:, None], cx + d[None, :])
    return (win / 255.0 - 0.5) * _hann2d(n, image.device)


def _gaussian_kernel_correlation(x, y, sigma: float = 0.2):
    """k = exp(-|x - y|^2 / (sigma^2 n)) at every cyclic shift, through
    the FFT (CirculantTracker.dense_gauss_kernel)."""
    n = x.shape[0] * x.shape[1]
    xy = torch.real(torch.fft.ifft2(torch.fft.fft2(x)
                                    * torch.conj(torch.fft.fft2(y))))
    d2 = torch.clamp(torch.sum(x * x) + torch.sum(y * y) - 2.0 * xy,
                     min=0.0) / n
    return torch.exp(-d2 / (sigma ** 2))


def _train(z: torch.Tensor, n: int, lambda_: float) -> torch.Tensor:
    k = _gaussian_kernel_correlation(z, z)
    yf = torch.fft.fft2(_gauss_response(n, z.device))
    return yf / (torch.fft.fft2(k) + lambda_)


def circulant_init(image, cy: float, cx: float, size: int = 64,
                   lambda_: float = 1e-4, device=None) -> CirculantState:
    """Initialize on the first frame (CirculantTracker.initialize)."""
    img = as_tensor(image, F32, device)
    cy = torch.tensor(cy, dtype=F32, device=img.device)
    cx = torch.tensor(cx, dtype=F32, device=img.device)
    z = _get_window(img, cy, cx, size)
    return CirculantState(_train(z, size, lambda_), z, cy, cx, size)


def circulant_track(state: CirculantState, image,
                    interp_factor: float = 0.075,
                    lambda_: float = 1e-4) -> CirculantState:
    """One frame: find the response peak, move the centre, retrain and
    blend the model (CirculantTracker.performTracking).  No host read."""
    n = state.size
    img = as_tensor(image, F32, state.cy.device)
    x = _get_window(img, state.cy, state.cx, n)
    k = _gaussian_kernel_correlation(x, state.template)
    resp = torch.real(torch.fft.ifft2(state.alphaf * torch.fft.fft2(k)))
    idx = torch.argmax(resp)
    py, px = idx // n, idx % n
    # the response is circular: displacements in [-n/2, n/2)
    dy = torch.where(py > n // 2, py - n, py).to(F32)
    dx = torch.where(px > n // 2, px - n, px).to(F32)
    cy, cx = state.cy + dy, state.cx + dx
    z = _get_window(img, cy, cx, n)
    a = interp_factor
    return CirculantState((1 - a) * state.alphaf + a * _train(z, n, lambda_),
                          (1 - a) * state.template + a * z, cy, cx, n)


# ---------------------------------------------------------------------------
# Mean-shift likelihood tracker
# ---------------------------------------------------------------------------

class MeanShiftState(NamedTuple):
    hist: torch.Tensor   # [B] P(target | bin), float64
    cy: torch.Tensor
    cx: torch.Tensor
    radius: int
    num_bins: int


def _bins(values: torch.Tensor, num_bins: int, top: float) -> torch.Tensor:
    return torch.clamp((values / top * num_bins).to(torch.int32), 0,
                       num_bins - 1)


def meanshift_init(image, cy, cx, radius: int = 15, num_bins: int = 32,
                   device=None) -> MeanShiftState:
    """A discriminative histogram, P(fg | bin), from a foreground patch
    against the ring around it (as the reference's likelihood models,
    e.g. LikelihoodHueSatHistInd, are normalized).  ``int(cy)`` picks the
    patch: a host read when ``cy`` is a device tensor."""
    img = as_tensor(image, F32, device)
    dev = img.device
    h, w = img.shape
    iy, ix = int(cy), int(cx)

    def patch_hist(r_in: int, r_out: int):
        off = torch.arange(-r_out, r_out + 1, device=dev)
        ys = torch.clamp(iy + off, 0, h - 1)
        xs = torch.clamp(ix + off, 0, w - 1)
        patch = img[ys[:, None], xs[None, :]]
        ring = (off.abs()[:, None] > r_in) | (off.abs()[None, :] > r_in)
        mask = ring if r_in > 0 else torch.ones_like(ring)
        hist = torch.zeros(num_bins, dtype=torch.float64, device=dev)
        # 0/1 votes: exact in any order
        hist.index_add_(0, _bins(patch, num_bins, 256.0).reshape(-1).long(),
                        mask.reshape(-1).to(torch.float64))
        return hist / torch.clamp(torch.sum(hist), min=1e-12)

    fg = patch_hist(0, radius)
    bg = patch_hist(radius, 2 * radius)
    return MeanShiftState(fg / (fg + bg + 1e-6),
                          torch.tensor(float(cy), dtype=F32, device=dev),
                          torch.tensor(float(cx), dtype=F32, device=dev),
                          radius, num_bins)


def _plus(c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """c + d in the dtype JAX promotes the two to (float64 once the centre
    is float64; torch would keep a 0-dim operand's dtype out of it)."""
    dt = torch.promote_types(c.dtype, d.dtype)
    return c.to(dt) + d.to(dt)


def meanshift_track(state: MeanShiftState, image,
                    iterations: int = 10) -> MeanShiftState:
    """Back-projection weighted centroid iterations
    (TrackerMeanShiftLikelihood.process), a fixed count, no host read."""
    img = as_tensor(image, F32, state.cy.device)
    h, w = img.shape
    likelihood = state.hist[_bins(img, state.num_bins, 256.0).long()]
    r = state.radius
    d = torch.arange(-r, r + 1, dtype=F32, device=img.device)
    cy, cx = state.cy, state.cx
    for _ in range(iterations):
        yy = torch.clamp(torch.round(_plus(cy, d)).long(), 0, h - 1)
        xx = torch.clamp(torch.round(_plus(cx, d)).long(), 0, w - 1)
        wgt = likelihood[yy[:, None], xx[None, :]]
        tot = torch.sum(wgt) + 1e-12
        cy, cx = (torch.sum(wgt * _plus(cy, d[:, None])) / tot,
                  torch.sum(wgt * _plus(cx, d[None, :])) / tot)
    return state._replace(cy=cy, cx=cx)


# ---------------------------------------------------------------------------
# SFOT: sparse-flow object tracker
# ---------------------------------------------------------------------------

class SfotState(NamedTuple):
    """Rotated-rectangle region (RectangleRotate_F64 analog)."""
    cy: torch.Tensor
    cx: torch.Tensor
    height: torch.Tensor
    width: torch.Tensor
    yaw: torch.Tensor


def sfot_init(cy, cx, height, width, yaw=0.0, device=None) -> SfotState:
    f = lambda v: as_tensor(v, F32, device)
    return SfotState(f(cy), f(cx), f(height), f(width), f(yaw))


def _sfot_grid(state: SfotState, grid: int):
    """A grid of sample points inside the rotated rectangle."""
    u = ((torch.arange(grid, dtype=F32, device=state.cy.device) + 0.5)
         / grid - 0.5)
    uy, ux = torch.meshgrid(u * state.height, u * state.width,
                            indexing="ij")
    c, s = torch.cos(state.yaw), torch.sin(state.yaw)
    xs = state.cx + c * ux.reshape(-1) - s * uy.reshape(-1)
    ys = state.cy + s * ux.reshape(-1) + c * uy.reshape(-1)
    return ys, xs


def _masked_median(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Median of v where m, the mean of the two middle values of an even
    count (the float32 maximum when m is empty); no host read."""
    s = torch.sort(torch.where(m, v, 3.4e38)).values
    k = torch.clamp(torch.sum(m) - 1, min=0)
    lo = s.gather(0, (k // 2).reshape(1))[0]
    hi = s.gather(0, ((k + 1) // 2).reshape(1))[0]
    return 0.5 * (lo + hi)


def sfot_track(prev_image, image, state: SfotState, grid: int = 9,
               scales=(1, 2, 4), template_radius: int = 3,
               min_tracks: int = 8):
    """Sparse-flow object tracking step (SparseFlowObjectTracker.java):
    pyramidal KLT of a grid of points inside the region, then the rotated
    rectangle moves by the median translation, scales by the median
    pairwise distance ratio and turns by the median pairwise angle change
    (the Median-Flow recipe).  Returns (state, ok) with ``ok`` a 0-dim
    bool tensor."""
    from boofcv_tpu_torch.core.pyramid import PyramidConfig
    from boofcv_tpu_torch.feature import klt
    from boofcv_tpu_torch.ip import pyramid_ops

    dev = state.cy.device
    cfgp = PyramidConfig(scales=tuple(scales))
    p_prev = pyramid_ops.pyramid_average(as_tensor(prev_image, F32, dev),
                                         cfgp)
    p_cur = pyramid_ops.pyramid_average(as_tensor(image, F32, dev), cfgp)
    ys, xs = _sfot_grid(state, grid)
    cfg = klt.KltConfig(template_radius=template_radius)
    tmpl = klt.sample_templates(p_prev, pyramid_ops.gradient(p_prev), ys, xs,
                                scales, template_radius)
    nys, nxs, fault = klt.track_pyramid(p_cur, tmpl, ys, xs, scales, cfg)
    ok = fault == klt.TRACK_OK
    dty = _masked_median(nys - ys, ok)
    dtx = _masked_median(nxs - xs, ok)

    # medians of the pairwise scale and rotation over valid pairs
    iu, ju = torch.triu_indices(grid * grid, grid * grid, 1, device=dev)
    pdx0, pdy0 = xs[iu] - xs[ju], ys[iu] - ys[ju]
    pdx1, pdy1 = nxs[iu] - nxs[ju], nys[iu] - nys[ju]
    d0 = torch.sqrt(pdx0 ** 2 + pdy0 ** 2)
    d1 = torch.sqrt(pdx1 ** 2 + pdy1 ** 2)
    pm = ok[iu] & ok[ju] & (d0 > 2.0)
    ratio = torch.where(d0 > 1e-6, d1 / torch.clamp(d0, min=1e-6), 1.0)
    dang = torch.arctan2(pdy1, pdx1) - torch.arctan2(pdy0, pdx0)
    dang = torch.arctan2(torch.sin(dang), torch.cos(dang))
    # with no valid pair (every baseline under the 2 px gate) the medians
    # are the sentinel: keep the translation, hold scale and rotation
    has_pairs = torch.any(pm)
    scale = torch.where(has_pairs, _masked_median(ratio, pm), 1.0)
    drot = torch.where(has_pairs, _masked_median(dang, pm), 0.0)
    good = torch.sum(ok) >= min_tracks
    new = SfotState(
        cy=torch.where(good, state.cy + dty, state.cy),
        cx=torch.where(good, state.cx + dtx, state.cx),
        height=torch.where(good, state.height * scale, state.height),
        width=torch.where(good, state.width * scale, state.width),
        yaw=torch.where(good, state.yaw + drot, state.yaw))
    return new, good


# ---------------------------------------------------------------------------
# Comaniciu 2003 kernel-based mean-shift (scale-adaptive)
# ---------------------------------------------------------------------------

class ComaniciuState(NamedTuple):
    """TrackerMeanShiftComaniciu2003 analog state."""
    q: torch.Tensor      # [B] key-frame (target) histogram, normalized
    cy: torch.Tensor
    cx: torch.Tensor
    ry: torch.Tensor     # region half-height
    rx: torch.Tensor     # region half-width
    ry0: float           # original half sizes (minimum-size clamp)
    rx0: float
    num_bins: int
    max_value: float     # top of the intensity range (maxPixelValue)


_GRID = 24               # samples a side of the histogram's lattice


def _unit_lattice(n: int, device):
    """``jnp.linspace(-1, 1, n, dtype=float32)`` by its formula (start
    (1 - i/(n-1)) + stop i/(n-1), then the stop) as the [n, n] lattice.
    The quotient divides by a tensor: the card divides by a Python scalar
    as a multiply by its reciprocal, which rounds otherwise."""
    step = torch.arange(n - 1, dtype=F32, device=device)
    step = step / torch.full_like(step, n - 1)
    u = torch.cat([-1.0 * (1 - step) + 1.0 * step,
                   torch.ones(1, dtype=F32, device=device)])
    return torch.meshgrid(u, u, indexing="ij")


def _comaniciu_hist(img, cy, cx, ry, rx, num_bins: int, n: int = _GRID,
                    max_value: float = 256.0):
    """Epanechnikov-weighted intensity histogram of an axis-aligned region
    on an n x n normalized lattice (LocalWeightedHistogramRotRect with no
    rotation): a one-hot sum over the lattice, a fixed order that repeats
    on the card.  Returns (hist [B], bins [n, n], kern [n, n])."""
    uu, vv = _unit_lattice(n, img.device)
    kern = torch.clamp(1.0 - (uu * uu + vv * vv), min=0.0)
    vals = bilinear(img, cy + uu * ry, cx + vv * rx)
    bins = _bins(vals, num_bins, max_value)
    one_hot = bins[..., None] == torch.arange(num_bins, device=img.device)
    hist = torch.sum(torch.where(one_hot, kern[..., None], 0.0),
                     dim=(0, 1))
    return hist / torch.clamp(torch.sum(hist), min=1e-12), bins, kern


def comaniciu_init(image, cy, cx, ry, rx, num_bins: int = 32,
                   max_pixel_value: float | None = None,
                   device=None) -> ComaniciuState:
    """``max_pixel_value``: the top of the intensity range used for binning
    (the reference's maxPixelValue).  None reads the key frame's maximum
    (one host read) to tell a [0, 1] float image from an 8-bit one."""
    img = as_tensor(image, F32, device)
    if max_pixel_value is None:
        max_pixel_value = 1.0 if float(torch.max(img)) <= 1.0 else 256.0
    f = lambda v: torch.tensor(float(v), dtype=F32, device=img.device)
    q, _, _ = _comaniciu_hist(img, f(cy), f(cx), f(ry), f(rx), num_bins,
                              max_value=max_pixel_value)
    return ComaniciuState(q, f(cy), f(cx), f(ry), f(rx), float(ry),
                          float(rx), num_bins, float(max_pixel_value))


def _comaniciu_shift(img, q, cy, cx, ry, rx, num_bins: int,
                     iterations: int, min_change: float,
                     max_value: float = 256.0):
    """Mean-shift to the Bhattacharyya-maximizing location at one scale:
    sample weights sqrt(q[b] / p[b]) (Comaniciu 2003 eq. 25), the
    weighted centroid of the Epanechnikov lattice; a fixed count of
    iterations, each point frozen once it moves less than ``min_change``.
    Returns (cy, cx, bhattacharyya) as 0-dim tensors."""
    uu, vv = _unit_lattice(_GRID, img.device)
    frozen = torch.zeros((), dtype=torch.bool, device=img.device)
    for _ in range(iterations):
        p, bins, kern = _comaniciu_hist(img, cy, cx, ry, rx, num_bins,
                                        max_value=max_value)
        b = bins.long()
        w = torch.sqrt(q[b] / torch.clamp(p[b], min=1e-12)) * kern
        tot = torch.sum(w) + 1e-12
        ny = torch.sum(w * (cy + uu * ry)) / tot
        nx = torch.sum(w * (cx + vv * rx)) / tot
        small = torch.hypot(ny - cy, nx - cx) < min_change
        cy = torch.where(frozen, cy, ny)
        cx = torch.where(frozen, cx, nx)
        frozen = frozen | small
    p, _, _ = _comaniciu_hist(img, cy, cx, ry, rx, num_bins,
                              max_value=max_value)
    return cy, cx, torch.sum(torch.sqrt(p * q))


def comaniciu_track(state: ComaniciuState, image, max_iterations: int = 30,
                    min_change: float = 1e-2, scale_change: float = 0.1,
                    gamma: float = 0.1, minimum_size_ratio: float = 0.25,
                    update_histogram: bool = False) -> ComaniciuState:
    """One frame of TrackerMeanShiftComaniciu2003.process: mean-shift at
    three scales (1 -/+ scale_change), the scale of the best Bhattacharyya
    similarity kept, blended with the previous one by ``gamma``, clamped
    to ``minimum_size_ratio`` of the original size; the key histogram
    refreshed on request.  The three results come back in one host read,
    the new region goes up in one copy."""
    img = as_tensor(image, F32, state.cy.device)
    scales = ((1.0 - scale_change, 1.0, 1.0 + scale_change)
              if scale_change > 0 else (1.0,))
    rows = []
    for s in scales:
        ry, rx = state.ry * s, state.rx * s
        cy, cx, bh = _comaniciu_shift(img, state.q, state.cy, state.cx, ry,
                                      rx, state.num_bins, max_iterations,
                                      min_change, max_value=state.max_value)
        rows.append(torch.stack([bh, cy, cx, ry, rx]))
    host = torch.cat([torch.stack(rows).reshape(-1),
                      torch.stack([state.ry, state.rx])]).tolist()
    prev_ry, prev_rx = host[-2:]
    bh, cy, cx, ry, rx = max(tuple(host[5 * i:5 * i + 5])
                             for i in range(len(rows)))
    # scale damping and the minimum-size clamp
    ry = max(gamma * prev_ry + (1.0 - gamma) * ry,
             minimum_size_ratio * state.ry0)
    rx = max(gamma * prev_rx + (1.0 - gamma) * rx,
             minimum_size_ratio * state.rx0)
    cy, cx, ry, rx = torch.tensor([cy, cx, ry, rx], dtype=F32,
                                  device=img.device).unbind()
    q = state.q
    if update_histogram:
        q, _, _ = _comaniciu_hist(img, cy, cx, ry, rx, state.num_bins,
                                  max_value=state.max_value)
    return state._replace(q=q, cy=cy, cx=cx, ry=ry, rx=rx)
