"""Pyramid construction (port of ``boofcv_tpu/ip/pyramid_ops.py``:
``pyramid_average`` and ``gradient``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.ip import derivative


def pyramid_average(image: torch.Tensor,
                    config: PyramidConfig) -> Tuple[torch.Tensor, ...]:
    """2x2 block-average pyramid (PyramidDiscreteAverage) of an [..., H, W]
    image.  Odd dims are cropped before each 2x2 mean, so level sizes are
    floor(h/s).  When every leading index views one frame (an expanded
    tensor: the streams of a batched step replaying one sequence) the
    pyramid is built once and its levels are expanded the same way."""
    lead = image.shape[:-2]
    if lead and not any(image.stride()[:-2]):
        one = pyramid_average(image[(0,) * len(lead)], config)
        return tuple(level.expand(lead + level.shape) for level in one)
    levels = [image.to(torch.float32)]
    cur = levels[0]
    for prev_s, s in zip(config.scales, config.scales[1:]):
        step = s // prev_s
        if step & (step - 1) or s % prev_s:
            raise ValueError(
                f"pyramid scales must step by powers of 2, got {prev_s}"
                f" -> {s} (a silent wrong-scale level otherwise)")
        while step > 1:
            h, w = cur.shape[-2:]
            cur = cur[..., : h - h % 2, : w - w % 2].reshape(
                lead + (h // 2, 2, w // 2, 2)).mean(dim=(-3, -1))
            step //= 2
        levels.append(cur)
    return tuple(levels)


def gradient(pyramid: Sequence[torch.Tensor]):
    """Per-level Sobel gradient (PyramidOps.gradient).  Returns
    (dxs, dys)."""
    grads = [derivative.sobel(level) for level in pyramid]
    return tuple(g[0] for g in grads), tuple(g[1] for g in grads)
