"""SIFT: difference-of-Gaussian detector and gradient-histogram descriptor
(port of ``boofcv_tpu/feature/sift.py``, whole).

Reference analog: boofcv-feature alg/feature/detect/interest/
SiftScaleSpace.java + SiftDetector.java:83,165 (DoG extrema, edge
rejection, subpixel interpolation), alg/feature/describe/
DescribePointSift.java (4x4x8 histograms), OrientationHistogramSift.

An octave's DoG stack is one [S+2, H, W] tensor; its 3x3x3 extrema are
``max_pool3d`` (which pads with -inf, as the reference's ``reduce_window``
does); ``torch.roll`` wraps as ``jnp.roll`` does.  The octave ladder is a
Python loop: shapes halve per octave, and dead detection slots carry a
``valid`` mask.  The orientation and descriptor histograms are sums of
one-hot products over each keypoint's samples: the reference's
``.at[bin].add(w)`` adds real weights, and a scatter-add on the card adds
them in an order that changes from launch to launch, while a sum over a
fixed axis repeats.  Sigmas are float64 as in the reference, which carries
the sample lattices into float64.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from boofcv_tpu_torch._config import as_tensor
from boofcv_tpu_torch.core.border import BorderType
from boofcv_tpu_torch.feature import extract as ex
from boofcv_tpu_torch.ip import blur as blur_mod
from boofcv_tpu_torch.ip.interpolate import bilinear


class SiftKeypoints(NamedTuple):
    ys: torch.Tensor
    xs: torch.Tensor
    sigmas: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor


def gaussian_scale_stack(image, sigma0: float = 1.6, num_scales: int = 3,
                         assume_blurred: bool = False):
    """([S+3, H, W] Gaussian stack of one octave, numpy sigmas)
    (SiftScaleSpace).  ``assume_blurred`` treats ``image`` as carrying
    sigma0 already: an octave's base is the previous stack's 2x-sigma level
    taken every second pixel."""
    img = image.to(torch.float32)
    k = 2.0 ** (1.0 / num_scales)
    levels = [img if sigma0 <= 0 or assume_blurred else blur_mod.gaussian(
        img, sigma=sigma0, border=BorderType.EXTENDED)]
    sigmas = [sigma0]
    cur_sigma = sigma0
    for i in range(1, num_scales + 3):
        target = sigma0 * k ** i
        inc = math.sqrt(max(target ** 2 - cur_sigma ** 2, 1e-6))
        levels.append(blur_mod.gaussian(levels[-1], sigma=inc,
                                        border=BorderType.EXTENDED))
        sigmas.append(target)
        cur_sigma = target
    return torch.stack(levels), np.asarray(sigmas)


def _roll2(x, sy: int, sx: int):
    return torch.roll(x, (sy, sx), (1, 2))


def _detect_from_stack(stack, sigmas, max_features: int,
                       contrast_threshold: float, edge_ratio: float,
                       border: int) -> SiftKeypoints:
    """DoG extrema of one octave's stack (SiftDetector.process): subpixel
    positions and interpolated sigmas in the stack's own pixels."""
    dog = stack[1:] - stack[:-1]                         # [S+2, H, W]
    s, h, w = dog.shape
    pool = lambda x: F.max_pool3d(x[None, None], 3, stride=1, padding=1)[0, 0]
    is_max = (dog >= pool(dog)) & (dog > contrast_threshold)
    is_min = (dog <= -pool(-dog)) & (dog < -contrast_threshold)
    cand = is_max | is_min
    cand[0] = False
    cand[-1] = False

    # edge rejection by the 2x2 spatial Hessian ratio (SiftDetector:165)
    dxx = _roll2(dog, 0, -1) - 2 * dog + _roll2(dog, 0, 1)
    dyy = _roll2(dog, -1, 0) - 2 * dog + _roll2(dog, 1, 0)
    dxy = 0.25 * (_roll2(dog, -1, -1) - _roll2(dog, -1, 1)
                  - _roll2(dog, 1, -1) + _roll2(dog, 1, 1))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_ratio
    cand &= (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)

    score = torch.where(cand, torch.abs(dog), 0.0).reshape(s, -1)
    flat_img = torch.amax(score, dim=0).reshape(h, w)    # best scale a pixel
    best_s = torch.argmax(score, dim=0)
    detn = ex.detect(flat_img, max_features=max_features, radius=2,
                     threshold=contrast_threshold, border=border)
    si = best_s[detn.ys.long() * w + detn.xs.long()]
    # the interpolated sigma of scale si, chosen among s host constants (a
    # table copied to the card would be a host sync)
    mid = sigmas[:-1] + np.diff(sigmas) / 2
    sig = torch.full(si.shape, float(mid[0]), dtype=torch.float64,
                     device=dog.device)
    for i in range(1, s):
        sig = torch.where(si >= i, float(mid[i]), sig)
    ys, xs = ex.subpixel_quadratic(flat_img, detn)
    return SiftKeypoints(ys, xs, sig, detn.scores, detn.valid)


def _octave_ladder(image, num_octaves: int, sigma0: float, num_scales: int,
                   min_size: int, first_octave: int = 0):
    """Yield (octave stack, its sigmas, scale factor, offset) per octave.

    Octave o's base is octave o-1's 2x-sigma0 level taken every second
    pixel (SiftScaleSpace.java:51).  ``first_octave=-1`` starts from the
    image upsampled 2x bilinearly with half-pixel centres (as
    ``jax.image.resize`` does), so input pixel u lands at 2u + 0.5 and every
    octave maps to full resolution as x * 2^o - 0.25.  Stops when the image
    gets smaller than ``min_size``."""
    base = image.to(torch.float32)
    if first_octave < -1 or first_octave > 0:
        raise ValueError("first_octave must be -1 or 0")
    off = 0.0
    if first_octave == -1:
        h, w = base.shape
        base = F.interpolate(base[None, None], size=(2 * h, 2 * w),
                             mode="bilinear", align_corners=False)[0, 0]
        off = -0.25
    assume = False
    for o in range(first_octave, first_octave + num_octaves):
        if min(base.shape) < min_size:
            return
        stack, sigmas = gaussian_scale_stack(base, sigma0, num_scales,
                                             assume_blurred=assume)
        yield stack, sigmas, 2.0 ** o, off
        base = stack[num_scales][::2, ::2]
        assume = True


def _empty(max_features: int, device) -> SiftKeypoints:
    z = torch.zeros((max_features,), dtype=torch.float32, device=device)
    return SiftKeypoints(z, z, z, z, torch.zeros((max_features,),
                                                 dtype=torch.bool,
                                                 device=device))


def _full_res(kp: SiftKeypoints, f: float, off: float) -> SiftKeypoints:
    return SiftKeypoints(kp.ys * f + off, kp.xs * f + off, kp.sigmas * f,
                         kp.scores, kp.valid)


def detect(image, max_features: int = 200, sigma0: float = 1.6,
           num_scales: int = 3, contrast_threshold: float = 1.0,
           edge_ratio: float = 10.0, border: int = 8,
           num_octaves: int = 1, first_octave: int = 0,
           device=None) -> SiftKeypoints:
    """DoG extrema across ``num_octaves`` octaves (SiftDetector.process over
    SiftScaleSpace's pyramid), in full-resolution coordinates with
    full-range sigmas; ``max_features`` slots an octave.  A numpy image
    goes to ``device`` (default the card)."""
    image = as_tensor(image, torch.float32, device)
    parts = [_full_res(_detect_from_stack(stack, sigmas, max_features,
                                          contrast_threshold, edge_ratio,
                                          border), f, off)
             for stack, sigmas, f, off in _octave_ladder(
                 image, num_octaves, sigma0, num_scales, 2 * border + 1,
                 first_octave)]
    if not parts:
        return _empty(max_features, image.device)
    return SiftKeypoints(*[torch.cat(leaves) for leaves in zip(*parts)])


def _gradients(image):
    img = image.to(torch.float32)
    gy = torch.roll(img, -1, 0) - torch.roll(img, 1, 0)
    gx = torch.roll(img, -1, 1) - torch.roll(img, 1, 1)
    return gx, gy


def _histogram(bins, weights, n_bins: int):
    """[N, n_bins] sums of ``weights`` [N, ...] by ``bins`` [N, ...]: a
    one-hot product summed over the samples in a fixed order."""
    n = bins.shape[0]
    b = bins.reshape(n, -1, 1)
    one_hot = b == torch.arange(n_bins, device=bins.device)
    return torch.sum(torch.where(one_hot, weights.reshape(n, -1, 1), 0.0),
                     dim=1)


def orientation_histogram(image, ys, xs, sigmas, num_bins: int = 36):
    """Dominant gradient orientation per keypoint
    (OrientationHistogramSift): a 17x17 lattice spaced sigma/1.6 (the fixed
    window-to-scale constant), Gaussian weighted, ``num_bins`` bins."""
    gx, gy = _gradients(image)
    r = 8
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=gx.device)
    rel = sigmas[:, None, None] / 1.6
    yy = ys[:, None, None] + d[None, :, None] * rel
    xx = xs[:, None, None] + d[None, None, :] * rel
    sgx = bilinear(gx, yy, xx)
    sgy = bilinear(gy, yy, xx)
    mag = torch.hypot(sgx, sgy)
    wgt = torch.exp(-0.5 * (d[None, :, None] ** 2 + d[None, None, :] ** 2)
                    / (r / 2.0) ** 2)
    ang = torch.remainder(torch.arctan2(sgy, sgx), 2 * np.pi)
    bins = torch.clamp((ang / (2 * np.pi) * num_bins).to(torch.int32),
                       0, num_bins - 1)
    hist = _histogram(bins, mag * wgt, num_bins)
    return torch.argmax(hist, dim=1).to(torch.float32) * (2 * np.pi
                                                           / num_bins)


def describe(image, ys, xs, sigmas, angles, width_grid: int = 4,
             width_sub: int = 4, num_bins: int = 8):
    """SIFT descriptors [N, 128] (DescribePointSift.process): 4x4 cells x 8
    orientation bins on a rotated 16x16 lattice, Gaussian weighted, L2
    normalized, clipped at 0.2 and normalized again."""
    gx, gy = _gradients(image)
    half = width_grid * width_sub / 2.0
    d = (torch.arange(width_grid * width_sub, dtype=torch.float32,
                      device=gx.device) - half + 0.5)   # -7.5 .. 7.5
    scale = sigmas / 1.6
    ca = torch.cos(angles)
    sa = torch.sin(angles)
    u = d[None, :, None] * torch.ones_like(d)[None, None, :]
    v = torch.ones_like(d)[None, :, None] * d[None, None, :]
    rx = (ca[:, None, None] * u - sa[:, None, None] * v) * scale[:, None, None]
    ry = (sa[:, None, None] * u + ca[:, None, None] * v) * scale[:, None, None]
    sgx = bilinear(gx, ys[:, None, None] + ry, xs[:, None, None] + rx)
    sgy = bilinear(gy, ys[:, None, None] + ry, xs[:, None, None] + rx)
    rgx = ca[:, None, None] * sgx + sa[:, None, None] * sgy
    rgy = -sa[:, None, None] * sgx + ca[:, None, None] * sgy
    mag = torch.hypot(rgx, rgy)
    wgt = torch.exp(-0.5 * (u ** 2 + v ** 2) / (half ** 2))
    ang = torch.remainder(torch.arctan2(rgy, rgx), 2 * np.pi)
    abin = torch.clamp((ang / (2 * np.pi) * num_bins).to(torch.int32),
                       0, num_bins - 1)
    cell_u = torch.clamp(((u + half) / width_sub).to(torch.int32), 0,
                         width_grid - 1)
    cell_v = torch.clamp(((v + half) / width_sub).to(torch.int32), 0,
                         width_grid - 1)
    idx = (cell_v * width_grid + cell_u) * num_bins + abin   # [N, P, P]
    desc = _histogram(idx, mag * wgt, width_grid * width_grid * num_bins)
    norm = torch.linalg.norm(desc, dim=1, keepdim=True) + 1e-12
    desc = torch.clamp(desc / norm, max=0.2)
    norm = torch.linalg.norm(desc, dim=1, keepdim=True) + 1e-12
    return desc / norm


def detect_describe(image, max_features: int = 200, num_octaves: int = 4,
                    sigma0: float = 1.6, num_scales: int = 3,
                    contrast_threshold: float = 1.0,
                    edge_ratio: float = 10.0, border: int = 8,
                    first_octave: int = 0, device=None):
    """The multi-octave pipeline: (keypoints, descriptors [M, 128]).

    Orientation and descriptor are sampled at octave resolution (each
    octave's sigma0 level), so the support scales with the keypoint;
    keypoints come back in full-resolution coordinates, ``max_features``
    slots an octave with dead slots masked by ``valid``.  A numpy image goes
    to ``device`` (default the card)."""
    image = as_tensor(image, torch.float32, device)
    kps, descs = [], []
    for stack, sigmas, f, off in _octave_ladder(image, num_octaves, sigma0,
                                                num_scales, 2 * border + 1,
                                                first_octave):
        kp = _detect_from_stack(stack, sigmas, max_features,
                                contrast_threshold, edge_ratio, border)
        base = stack[0]
        ang = orientation_histogram(base, kp.ys, kp.xs, kp.sigmas)
        descs.append(describe(base, kp.ys, kp.xs, kp.sigmas, ang))
        kps.append(_full_res(kp, f, off))
    if not kps:
        return (_empty(max_features, image.device),
                torch.zeros((max_features, 128), dtype=torch.float32,
                            device=image.device))
    kp = SiftKeypoints(*[torch.cat(leaves) for leaves in zip(*kps)])
    return kp, torch.cat(descs)
