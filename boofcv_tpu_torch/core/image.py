"""Image representation policy (port of ``boofcv_tpu/core/image.py``).

Reference analog: boofcv-types struct/image/* (ImageBase.java:30,
ImageGray.java:62, Planar.java).  A gray image is an [H, W] tensor, an
interleaved colour image [H, W, C], a planar image [C, H, W] or a leading
batch axis, a subimage a slice.  Integer source data (U8/U16) becomes
float32 at the edge; every compute op of the port is float.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boofcv_tpu_torch._config import as_tensor


class ImageShape(NamedTuple):
    height: int
    width: int

    @property
    def hw(self) -> tuple[int, int]:
        return (self.height, self.width)


def to_float32(image, device=None) -> torch.Tensor:
    """Any supported input (uint8/16, float) as float32 without rescaling
    (ConvertImage semantics: U8 [0, 255] stays [0, 255]).  A tensor stays
    on its device; anything else goes to ``device`` (None: the card)."""
    return as_tensor(image, device=device).to(torch.float32)


def to_uint8(image: torch.Tensor) -> torch.Tensor:
    """Clamp and round (half to even) back to U8 (ConvertImage
    float->U8).  The value is whole before the cast, so the cast is
    exact."""
    return torch.clamp(torch.round(image), 0, 255).to(torch.uint8)


def rescale_to_unit(image, device=None) -> torch.Tensor:
    """U8 [0, 255] -> float32 [0, 1]."""
    return to_float32(image, device) / 255.0
