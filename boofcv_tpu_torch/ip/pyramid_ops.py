"""Pyramid construction (port of ``boofcv_tpu/ip/pyramid_ops.py``:
``pyramid_average`` and ``gradient``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.ip import derivative


def pyramid_average(image: torch.Tensor,
                    config: PyramidConfig) -> Tuple[torch.Tensor, ...]:
    """2x2 block-average pyramid (PyramidDiscreteAverage).  Odd dims are
    cropped before each 2x2 mean, so level sizes are floor(h/s)."""
    levels = [image.to(torch.float32)]
    cur = levels[0]
    for prev_s, s in zip(config.scales, config.scales[1:]):
        step = s // prev_s
        if step & (step - 1) or s % prev_s:
            raise ValueError(
                f"pyramid scales must step by powers of 2, got {prev_s}"
                f" -> {s} (a silent wrong-scale level otherwise)")
        while step > 1:
            h, w = cur.shape
            cur = cur[: h - h % 2, : w - w % 2].reshape(
                h // 2, 2, w // 2, 2).mean(dim=(1, 3))
            step //= 2
        levels.append(cur)
    return tuple(levels)


def gradient(pyramid: Sequence[torch.Tensor]):
    """Per-level Sobel gradient (PyramidOps.gradient).  Returns
    (dxs, dys)."""
    grads = [derivative.sobel(level) for level in pyramid]
    return tuple(g[0] for g in grads), tuple(g[1] for g in grads)
