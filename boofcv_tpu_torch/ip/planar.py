"""Multi-band (planar / interleaved) images for single-band ops (port of
``boofcv_tpu/ip/planar.py``).

Reference analog: the Planar<T> overloads across boofcv-ip
(GBlurImageOps, GConvolveImageOps, ConvertImage.java:38), which loop the
single-band op over the bands.  The JAX package makes the bands one
``vmap`` axis.  The port folds them into a leading batch axis for the
functions that take [..., H, W] (:data:`TAKES_PLANES`: ``derivative.sobel``
and ``pyramid_ops.pyramid_average``: one call for all the bands) and loops
over the bands for every other function (the blurs, ``convolve.*``,
``enhance.*``, anything the caller passes), one call a band.  Both give
what a call per band gives, bit for bit.

Convention: interleaved [H, W, C]; ``band_axis`` names the band axis.
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch.ip import derivative, pyramid_ops

TAKES_PLANES = frozenset({derivative.sobel, pyramid_ops.pyramid_average})


def _tree_map(fn, out):
    if isinstance(out, torch.Tensor):
        return fn(out)
    return type(out)(_tree_map(fn, leaf) for leaf in out)


def _stack(outs, band_axis: int):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs, dim=band_axis)
    return type(first)(_stack([o[i] for o in outs], band_axis)
                       for i in range(len(first)))


def per_band(fn, image: torch.Tensor, *args, band_axis: int = -1,
             **kwargs):
    """Apply a single-band ``fn(image2d, *args, **kwargs)`` to every band
    of a multi-band image.  Tensor outputs and tuples or lists of them
    (``sobel``'s (dx, dy), pyramids) come back with the band axis at
    ``band_axis`` of every [H', W'] leaf."""
    img = torch.movedim(image, band_axis, 0)
    if fn in TAKES_PLANES:
        return _tree_map(lambda leaf: torch.movedim(leaf, 0, band_axis),
                         fn(img, *args, **kwargs))
    return _stack([fn(band, *args, **kwargs) for band in img], band_axis)


def planar(fn):
    """Wrap a single-band op into a multi-band one:
    ``planar(blur.gaussian)(rgb, sigma=2)``.  2-D inputs pass through, so
    the wrapped op takes gray and planar images (the G*Ops dispatch)."""

    def wrapped(image, *args, band_axis: int = -1, **kwargs):
        if image.dim() == 2:
            return fn(image, *args, **kwargs)
        return per_band(fn, image, *args, band_axis=band_axis, **kwargs)

    wrapped.__name__ = f"planar_{getattr(fn, '__name__', 'op')}"
    wrapped.__doc__ = (f"Multi-band wrapper of "
                       f"{getattr(fn, '__name__', fn)}.")
    return wrapped


def average_bands(image: torch.Tensor, band_axis: int = -1) -> torch.Tensor:
    """ConvertImage.average: planar -> gray by band mean."""
    return torch.mean(image.to(torch.float32), dim=band_axis)


def split_bands(image: torch.Tensor, band_axis: int = -1) -> list:
    """Interleaved -> list of single-band images (ConvertImage split)."""
    return list(torch.unbind(image, dim=band_axis))


def merge_bands(bands, band_axis: int = -1) -> torch.Tensor:
    """List of single-band images -> interleaved (ConvertImage merge)."""
    return torch.stack(list(bands), dim=band_axis)
