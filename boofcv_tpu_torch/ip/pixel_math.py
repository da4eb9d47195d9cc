"""Elementwise pixel math + statistics (port of
``boofcv_tpu/ip/pixel_math.py``, whole).

Reference analog: boofcv-ip alg/misc/PixelMath.java, ImageMiscOps.java,
ImageStatistics.java, ImageNormalization.java — generated per-dtype loops;
here each is a one-line torch expression, kept as a named function so the
capability surface is explicit and greppable.  The random fills take a
``torch.Generator`` where the reference takes a key (``jax.random`` streams
cannot be reproduced, so they agree in distribution, not in value).
"""

from __future__ import annotations

import torch


# ---- PixelMath ----------------------------------------------------------

def abs(image):  # noqa: A001 - mirrors PixelMath.abs
    return torch.abs(image)

def negative(image):
    return -image

def invert(image, max_value=255.0):
    """invert intensity: max - I (GrayImageOps.invert)."""
    return max_value - image

def divide(image, denominator):
    return image / denominator

def multiply(image, scale):
    return image * scale

def plus(image, value):
    return image + value

def minus(image, value, reverse=False):
    return value - image if reverse else image - value

def log(image, val=1.0):
    """log(val + I) (PixelMath.log)."""
    return torch.log(val + image)

def log_sign(image, val=1.0):
    """sgn(I) * log(val + |I|) (PixelMath.logSign)."""
    return torch.sign(image) * torch.log(val + torch.abs(image))

def pow2(image):
    return image * image

def sqrt(image):
    return torch.sqrt(image)

def add(a, b):
    return a + b

def subtract(a, b):
    return a - b

def multiply_images(a, b):
    return a * b

def divide_images(a, b):
    return a / b

def bound_image(image, lo, hi):
    return torch.clamp(image, lo, hi)

def diff_abs(a, b):
    return torch.abs(a - b)

def average_band(image_hwc):
    """Mean across bands (PixelMath.averageBand on Planar)."""
    return torch.mean(image_hwc, dim=-1)

def stdev_band(image_hwc):
    return torch.std(image_hwc, dim=-1, correction=0)

def minimum_band(image_hwc):
    return torch.amin(image_hwc, dim=-1)

def maximum_band(image_hwc):
    return torch.amax(image_hwc, dim=-1)


# ---- ImageStatistics ----------------------------------------------------

def min(image):  # noqa: A001
    return torch.min(image)

def max(image):  # noqa: A001
    return torch.max(image)

def max_abs(image):
    return torch.max(torch.abs(image))

def sum(image):  # noqa: A001
    return torch.sum(image)

def mean(image):
    return torch.mean(image)

def variance(image, mean_value=None):
    if mean_value is None:
        return torch.var(image, correction=0)
    return torch.mean((image - mean_value) ** 2)

def mean_diff_sq(a, b):
    return torch.mean((a - b) ** 2)

def mean_diff_abs(a, b):
    return torch.mean(torch.abs(a - b))

def histogram(image, min_value, max_value, num_bins):
    """ImageStatistics.histogram — counts per equal-width bin (int64; the
    counts are exact whatever order the card adds in)."""
    scaled = (image - min_value) * (num_bins / (max_value - min_value))
    idx = torch.clamp(scaled.to(torch.int32), 0, num_bins - 1)
    return torch.bincount(idx.reshape(-1), minlength=num_bins)


# ---- ImageMiscOps -------------------------------------------------------

def fill(image, value):
    return torch.full_like(image, value)

def fill_uniform(generator, shape, lo, hi, dtype=torch.float32):
    """Uniform fill in [lo, hi), drawn from ``generator`` on its device."""
    dev = generator.device
    if not dtype.is_floating_point:
        return torch.randint(int(lo), int(hi), tuple(shape), dtype=dtype,
                             generator=generator, device=dev)
    u = torch.rand(tuple(shape), dtype=dtype, generator=generator,
                   device=dev)
    return lo + (hi - lo) * u

def fill_gaussian(generator, shape, mean_v, sigma, lo, hi,
                  dtype=torch.float32):
    vals = mean_v + sigma * torch.randn(tuple(shape), generator=generator,
                                        device=generator.device)
    return torch.clamp(vals, lo, hi).to(dtype)

def add_gaussian_noise(generator, image, sigma, lo, hi):
    noise = torch.randn(image.shape, dtype=image.dtype, generator=generator,
                        device=image.device)
    return torch.clamp(image + sigma * noise, lo, hi)

def flip_vertical(image):
    return torch.flip(image, (0,))

def flip_horizontal(image):
    return torch.flip(image, (1,))

def rotate_cw(image):
    return torch.rot90(image, -1, (0, 1))

def rotate_ccw(image):
    return torch.rot90(image, 1, (0, 1))

def transpose(image):
    return torch.swapaxes(image, 0, 1)

def insert_band(image_hwc, band, values):
    out = image_hwc.clone()
    out[..., band] = values
    return out

def extract_band(image_hwc, band):
    return image_hwc[..., band]


# ---- ImageNormalization -------------------------------------------------

def _nonzero(m):
    return torch.where(m == 0, 1.0, m)

def normalize_max_abs(image, target=1.0):
    """Scale so max |value| = target (ImageNormalization.maxAbsOfOne)."""
    m = torch.max(torch.abs(image))
    return image * (target / _nonzero(m))

def normalize_zero_mean_unit_var(image):
    mu = torch.mean(image)
    sd = torch.std(image, correction=0)
    return (image - mu) / _nonzero(sd)

def normalize_zero_mean_max_one(image):
    mu = torch.mean(image)
    shifted = image - mu
    m = torch.max(torch.abs(shifted))
    return shifted / _nonzero(m)

