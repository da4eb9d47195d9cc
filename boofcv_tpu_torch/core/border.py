"""Image border rules (port of ``boofcv_tpu/core/border.py``).

Reference analog: boofcv-types struct/border/BorderType.java.  Padding
up-front maps onto ``torch.nn.functional.pad`` modes.
"""

from __future__ import annotations

import enum

import torch
import torch.nn.functional as F


class BorderType(enum.Enum):
    """Out-of-bounds pixel rule (struct/border/BorderType.java:28)."""

    SKIP = "skip"
    EXTENDED = "extended"      # replicate edge pixel
    NORMALIZED = "normalized"
    REFLECT = "reflect"        # mirror without repeating the edge pixel
    WRAP = "wrap"
    ZERO = "zero"


_PAD_MODES = {
    BorderType.EXTENDED: "replicate",
    BorderType.REFLECT: "reflect",
    BorderType.WRAP: "circular",
    BorderType.ZERO: "constant",
}


def pad_mode(border: BorderType) -> str:
    """``F.pad`` mode for a border rule (ZERO pads with 0)."""
    try:
        return _PAD_MODES[border]
    except KeyError:
        raise ValueError(f"border {border} has no pad-mode equivalent") from None


def pad(image: torch.Tensor, radius_y: int, radius_x: int,
        border: BorderType = BorderType.EXTENDED) -> torch.Tensor:
    """Pad an (H, W) or (H, W, C) image by (radius_y, radius_x) each side.

    ``F.pad``'s non-constant modes need a leading batch/channel dim, so the
    image is viewed as [1, C, H, W] for the call."""
    mode = pad_mode(border)
    chw = image[None] if image.dim() == 2 else image.permute(2, 0, 1)
    out = F.pad(chw[None], (radius_x, radius_x, radius_y, radius_y),
                mode=mode)[0]
    return out[0] if image.dim() == 2 else out.permute(1, 2, 0)


def pad_planes(image: torch.Tensor, radius_y: int, radius_x: int,
               border: BorderType = BorderType.EXTENDED) -> torch.Tensor:
    """:func:`pad` for [..., H, W]: every leading axis counts planes (the
    streams of a batched step), never channels-last."""
    h, w = image.shape[-2:]
    out = F.pad(image.reshape(1, -1, h, w),
                (radius_x, radius_x, radius_y, radius_y),
                mode=pad_mode(border))
    return out.reshape(image.shape[:-2] + out.shape[-2:])
