"""Image border rules (port of ``boofcv_tpu/core/border.py``).

Reference analog: boofcv-types struct/border/BorderType.java.  Padding
up-front maps onto ``torch.nn.functional.pad`` modes.  ``F.pad`` reflects
only radii below the size and wraps only radii up to it, where ``jnp.pad``
repeats the reflection or the period any number of times; past those
limits the padded image is built by index with the reference's
``reflect_index`` / ``wrap_index``.
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


def clamp_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """EXTENDED border as an index remap."""
    return torch.clamp(idx, 0, size - 1)


def wrap_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    return torch.remainder(idx, size)


def reflect_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Reflect-without-duplication: -1 -> 1, size -> size-2 (any distance;
    a size-1 axis reflects onto its one pixel)."""
    if size == 1:
        return torch.zeros_like(idx)
    period = 2 * (size - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= size, period - idx, idx)


def _past_f_pad(image: torch.Tensor, radius_y: int, radius_x: int,
                border: BorderType, ydim: int) -> torch.Tensor | None:
    """The padded image built by index where ``F.pad`` cannot reflect or
    wrap that far (rows on ``ydim``, columns on the next axis); None where it
    can."""
    h, w = image.shape[ydim], image.shape[ydim + 1]
    remap = {BorderType.REFLECT: reflect_index,
             BorderType.WRAP: wrap_index}.get(border)
    if remap is None or (radius_y < h and radius_x < w):
        return None
    at = lambda r, n: remap(torch.arange(-r, n + r, device=image.device), n)
    rows = image.index_select(ydim, at(radius_y, h))
    return rows.index_select(ydim + 1, at(radius_x, w))


def pad(image: torch.Tensor, radius_y: int, radius_x: int,
        border: BorderType = BorderType.EXTENDED) -> torch.Tensor:
    """Pad an (H, W) or (H, W, C) image by (radius_y, radius_x) each side.

    ``F.pad``'s non-constant modes need a leading batch/channel dim, so the
    image is viewed as [1, C, H, W] for the call."""
    mode = pad_mode(border)
    far = _past_f_pad(image, radius_y, radius_x, border, 0)
    if far is not None:
        return far
    chw = image[None] if image.dim() == 2 else image.permute(2, 0, 1)
    out = F.pad(chw[None], (radius_x, radius_x, radius_y, radius_y),
                mode=mode)[0]
    return out[0] if image.dim() == 2 else out.permute(1, 2, 0)


def pad_planes(image: torch.Tensor, radius_y: int, radius_x: int,
               border: BorderType = BorderType.EXTENDED) -> torch.Tensor:
    """:func:`pad` for [..., H, W]: every leading axis counts planes (the
    streams of a batched step), never channels-last."""
    h, w = image.shape[-2:]
    far = _past_f_pad(image, radius_y, radius_x, border, image.dim() - 2)
    if far is not None:
        return far
    out = F.pad(image.reshape(1, -1, h, w),
                (radius_x, radius_x, radius_y, radius_y),
                mode=pad_mode(border))
    return out.reshape(image.shape[:-2] + out.shape[-2:])
