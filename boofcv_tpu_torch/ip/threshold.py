"""Binarization / thresholding (port of ``boofcv_tpu/ip/threshold.py``,
whole).

Reference analog: boofcv-ip alg/filter/binary/ThresholdImageOps.java,
GThresholdImageOps.java, ComputeOtsu.java, ThresholdSauvola.java,
ThresholdNick.java, ThresholdBlock*.java.  Output is a {0,1} uint8 image,
matching BoofCV's GrayU8 binary convention.

Otsu and entropy work in float64 on the histogram and return a 0-dim
float64 tensor on the image's device; ``argmax`` takes the first maximum
in both packages, so on a plateau the threshold sits just above the low
mode, as in the reference.  Callers read it with ``float()`` (one host
sync).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from boofcv_tpu_torch.ip import blur as _blur
from boofcv_tpu_torch.ip import pixel_math as pm
from boofcv_tpu_torch.ip.stats import local_mean_std

_F64 = torch.float64


def _compare(image, value, down: bool) -> torch.Tensor:
    if down:
        return (image <= value).to(torch.uint8)
    return (image > value).to(torch.uint8)


def threshold(image: torch.Tensor, value, down: bool = True) -> torch.Tensor:
    """Global fixed threshold (ThresholdImageOps.threshold).

    down=True: 1 where I <= value; down=False: 1 where I > value.  A Python
    number compares in the image's dtype; a tensor (Otsu's float64 value)
    in the promoted dtype, as ``jnp`` promotes a float32 image against a
    float64 array (torch would round a 0-dim tensor to the image's dtype).
    """
    if isinstance(value, torch.Tensor):
        image = image.to(torch.promote_types(image.dtype, value.dtype))
    return _compare(image, value, down)


def _bin_threshold(idx, min_value, max_value, num_bins):
    return (min_value + (idx.to(_F64) + 0.5) * (max_value - min_value)
            / num_bins)


def compute_otsu(image: torch.Tensor, min_value=0.0, max_value=255.0,
                 num_bins: int = 256) -> torch.Tensor:
    """Otsu's threshold from the histogram (ComputeOtsu.java).

    Returns the threshold in image units (maximizing between-class
    variance), a 0-dim float64 tensor."""
    hist = pm.histogram(image, min_value, max_value, num_bins).to(_F64)
    total = torch.sum(hist)
    bin_centers = torch.arange(num_bins, dtype=_F64, device=hist.device)
    w0 = torch.cumsum(hist, 0)
    w1 = total - w0
    sum0 = torch.cumsum(hist * bin_centers, 0)
    sum_all = sum0[-1]
    m0 = sum0 / torch.where(w0 == 0, 1.0, w0)
    m1 = (sum_all - sum0) / torch.where(w1 == 0, 1.0, w1)
    between = w0 * w1 * (m0 - m1) ** 2
    return _bin_threshold(torch.argmax(between), min_value, max_value,
                          num_bins)


def compute_entropy(image: torch.Tensor, min_value=0.0, max_value=255.0,
                    num_bins: int = 256) -> torch.Tensor:
    """Maximum-entropy threshold (GThresholdImageOps.computeEntropy)."""
    hist = pm.histogram(image, min_value, max_value, num_bins).to(_F64)
    p = hist / torch.sum(hist)
    eps = 1e-12
    c0 = torch.cumsum(p, 0)
    c1 = 1.0 - c0
    plogp = torch.where(p > 0, p * torch.log(p + eps), 0.0)
    h0 = torch.cumsum(plogp, 0)
    h_all = h0[-1]
    ent = (torch.log(torch.clamp(c0, min=eps))
           - h0 / torch.clamp(c0, min=eps)
           + torch.log(torch.clamp(c1, min=eps))
           - (h_all - h0) / torch.clamp(c1, min=eps))
    ent = torch.where((c0 > 0) & (c1 > 0), ent, float("-inf"))
    return _bin_threshold(torch.argmax(ent), min_value, max_value, num_bins)


def local_mean(image: torch.Tensor, radius: int, scale: float = 0.95,
               down: bool = True) -> torch.Tensor:
    """Adaptive threshold vs local mean (ThresholdImageOps.localMean)."""
    m = _blur.mean(image.to(torch.float32), radius)
    return _compare(image, m * scale, down)


def local_gaussian(image: torch.Tensor, radius: int, scale: float = 0.95,
                   down: bool = True) -> torch.Tensor:
    """Adaptive threshold vs local Gaussian-weighted mean."""
    m = _blur.gaussian(image.to(torch.float32), radius=radius)
    return _compare(image, m * scale, down)


def sauvola(image: torch.Tensor, radius: int, k: float = 0.3,
            down: bool = True) -> torch.Tensor:
    """Sauvola adaptive threshold (ThresholdSauvola.java):
    T = m * (1 + k * (s / R - 1)), R = 128 for 8-bit input."""
    m, s = local_mean_std(image, radius)
    return _compare(image, m * (1.0 + k * (s / 128.0 - 1.0)), down)


def nick(image: torch.Tensor, radius: int, k: float = -0.2,
         down: bool = True) -> torch.Tensor:
    """NICK threshold (ThresholdNick.java): T = m + k*sqrt((sum(I^2)-m^2)/N)."""
    m, s = local_mean_std(image, radius)
    return _compare(image, m + k * s, down)


def block_min_max(image: torch.Tensor, block_size: int, scale: float = 0.95,
                  down: bool = True,
                  min_spread: float = 10.0) -> torch.Tensor:
    """Block min/max threshold (ThresholdBlockMinMax.java).

    Partitions into blocks, thresholds at the midpoint of each block's
    local min/max (textureless blocks => background).
    """
    h, w = image.shape
    bh, bw = -(-h // block_size), -(-w // block_size)
    ph, pw = bh * block_size, bw * block_size
    padded = F.pad(image.to(torch.float32)[None], (0, pw - w, 0, ph - h),
                   mode="replicate")[0]
    blocks = padded.reshape(bh, block_size, bw, block_size)
    bmin = torch.amin(blocks, dim=(1, 3))
    bmax = torch.amax(blocks, dim=(1, 3))
    t = (bmin + bmax) / 2.0 * scale
    textured = (bmax - bmin) >= min_spread
    rep = lambda a: a.repeat_interleave(block_size, 0).repeat_interleave(
        block_size, 1)[:h, :w]
    t_img = rep(t)
    tex_img = rep(textured)
    if down:
        binary = image <= t_img
        return (binary & tex_img | ~tex_img).to(torch.uint8)
    binary = image > t_img
    return (binary & tex_img).to(torch.uint8)
