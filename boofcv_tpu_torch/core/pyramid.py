"""Image-pyramid config (port of ``boofcv_tpu/core/pyramid.py``).

A pyramid is a tuple of [h, w] tensors, one per level."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple


@dataclass(frozen=True)
class PyramidConfig:
    """Discrete pyramid scales, e.g. (1, 2, 4, 8) (PkltConfig.pyramidScaling)."""

    scales: Tuple[int, ...] = (1, 2, 4, 8)
    sigma: float = -1.0  # blur before each decimation of pyramid_discrete; <0: 1

    def __post_init__(self):
        s = self.scales
        if not s or s[0] != 1:
            raise ValueError("pyramid scales must start at 1")
        for a, b in zip(s, s[1:]):
            if b % a != 0 or b <= a:
                raise ValueError("scales must be increasing and divisible")


def pyramid_shapes(config: PyramidConfig, height: int,
                   width: int) -> Sequence[tuple[int, int]]:
    """(h, w) of each level: floor division by its scale."""
    return [(height // s, width // s) for s in config.scales]
