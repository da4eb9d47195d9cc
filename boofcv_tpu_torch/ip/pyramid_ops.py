"""Pyramid construction (port of ``boofcv_tpu/ip/pyramid_ops.py``).

Reference analog: boofcv-ip alg/transform/pyramid/*:
PyramidDiscreteSampleBlur (blur then subsample), PyramidDiscreteAverage
(2x2 mean), per-level gradients (PyramidOps.gradient), and a float-scale
Gaussian scale space."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from boofcv_tpu_torch.core.border import BorderType
from boofcv_tpu_torch.core.kernel import gaussian_kernel
from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.ip import blur, convolve, derivative
from boofcv_tpu_torch.utils.profiling import span


def _octave_steps(config: PyramidConfig):
    """The number of halvings between consecutive levels; raises on a step
    that is not a power of 2."""
    steps = []
    for prev_s, s in zip(config.scales, config.scales[1:]):
        step = s // prev_s
        if step & (step - 1) or s % prev_s:
            raise ValueError(
                f"pyramid scales must step by powers of 2, got {prev_s}"
                f" -> {s} (a silent wrong-scale level otherwise)")
        steps.append(step.bit_length() - 1)
    return steps


def pyramid_discrete(image: torch.Tensor,
                     config: PyramidConfig) -> Tuple[torch.Tensor, ...]:
    """Blur-and-decimate pyramid (PyramidDiscreteSampleBlur) of an [H, W]
    image: each halving blurs with a Gaussian of ``config.sigma`` (1 when
    unset, NORMALIZED border), crops odd dims and keeps every other pixel,
    so level sizes are :func:`pyramid_shapes`'."""
    sigma = config.sigma if config.sigma > 0 else 1.0
    k = gaussian_kernel(sigma=sigma, dtype=torch.float32,
                        device=image.device)
    levels = [image.to(torch.float32)]
    cur = levels[0]
    for halvings in _octave_steps(config):
        for _ in range(halvings):
            blurred = convolve.separable(cur, k, k, BorderType.NORMALIZED)
            h, w = blurred.shape
            cur = blurred[: h - h % 2: 2, : w - w % 2: 2]
        levels.append(cur)
    return tuple(levels)


def pyramid_average(image: torch.Tensor,
                    config: PyramidConfig) -> Tuple[torch.Tensor, ...]:
    """2x2 block-average pyramid (PyramidDiscreteAverage) of an [..., H, W]
    image.  Odd dims are cropped before each 2x2 mean, so level sizes are
    floor(h/s).  When every leading index views one frame (an expanded
    tensor: the streams of a batched step replaying one sequence) the
    pyramid is built once and its levels are expanded the same way."""
    with span("pyramid"):
        return _pyramid_average(image, config)


def _pyramid_average(image: torch.Tensor,
                     config: PyramidConfig) -> Tuple[torch.Tensor, ...]:
    lead = image.shape[:-2]
    if lead and not any(image.stride()[:-2]):
        one = _pyramid_average(image[(0,) * len(lead)], config)
        return tuple(level.expand(lead + level.shape) for level in one)
    levels = [image.to(torch.float32)]
    cur = levels[0]
    for halvings in _octave_steps(config):
        for _ in range(halvings):
            h, w = cur.shape[-2:]
            cur = cur[..., : h - h % 2, : w - w % 2].reshape(
                lead + (h // 2, 2, w // 2, 2)).mean(dim=(-3, -1))
        levels.append(cur)
    return tuple(levels)


_GRADIENTS = {"sobel": derivative.sobel, "three": derivative.three,
              "prewitt": derivative.prewitt}


def gradient(pyramid: Sequence[torch.Tensor], method: str = "sobel"):
    """Per-level gradient (PyramidOps.gradient): ``method`` "sobel" (on
    [..., h, w] levels), "three" or "prewitt" (on [h, w]).  Returns
    (dxs, dys)."""
    with span("gradient"):
        fn = _GRADIENTS[method]
        grads = [fn(level) for level in pyramid]
        return tuple(g[0] for g in grads), tuple(g[1] for g in grads)


def gaussian_scale_space(image: torch.Tensor, sigmas: Sequence[float]):
    """Float-scale Gaussian scale space (PyramidFloatGaussianScale analog):
    every level a Gaussian blur of the full-resolution image."""
    img = image.to(torch.float32)
    return tuple(blur.gaussian(img, sigma=s) for s in sigmas)
