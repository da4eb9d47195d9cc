"""Bytes and operations that one KLT tracking call needs, from its inputs
alone (the pyramid's shapes, the track positions at entry, the template
size), whatever kernel does the work.

The rewrite of ``chip_smoke.touched_bytes`` / ``_klt_bound`` that calls no
port function.  Bytes: every float32 pixel that some track's bilinear
support ((P+1)^2 at its entry position on that level) covers, read once;
the templates and their two gradients at every level; the positions in;
positions and a fault code out.  Operations: one evaluation a track and
level (P^2 bilinear samples of 8, an error, its absolute value and the two
gradient products: 14 a pixel, and 10 for the 2x2 solve), a floor: the
iterations a track takes depend on the data.
"""

from __future__ import annotations

import numpy as np

FLOPS_PER_PIXEL = 14
FLOPS_PER_SOLVE = 10


def capture(args, kwargs) -> dict:
    """What ``count`` needs of a ``track_pyramid(pyramid, templates, ys,
    xs, scales, cfg)`` call: shapes and references, no device work."""
    pyramid, templates, ys, xs, scales = args[:5]
    return {"shapes": [tuple(p.shape[-2:]) for p in pyramid],
            "p": int(templates.desc[0].shape[-1]), "ys": ys, "xs": xs,
            "scales": list(scales)}


def union_pixels(h: int, w: int, cy, cx, p: int) -> int:
    """Pixels of an h x w image covered by the (p+1)^2 supports at
    centres (cy, cx), each moved inside the image."""
    r = (p - 1) // 2
    y0 = np.clip(np.floor(cy).astype(np.int64) - r, 0, max(h - p - 1, 0))
    x0 = np.clip(np.floor(cx).astype(np.int64) - r, 0, max(w - p - 1, 0))
    mask = np.zeros((h, w), bool)
    for dy in range(p + 1):
        for dx in range(p + 1):
            mask[np.clip(y0 + dy, 0, h - 1), np.clip(x0 + dx, 0, w - 1)] = True
    return int(mask.sum())


def count(rec: dict) -> tuple:
    ys = np.asarray(rec["ys"].detach().cpu(), np.float64).reshape(
        -1, rec["ys"].shape[-1])
    xs = np.asarray(rec["xs"].detach().cpu(), np.float64).reshape(ys.shape)
    streams, n = ys.shape
    p = rec["p"]
    levels = len(rec["scales"])
    pixels = sum(union_pixels(h, w, ys[b] / s, xs[b] / s, p)
                 for b in range(streams)
                 for (h, w), s in zip(rec["shapes"], rec["scales"]))
    tracks = streams * n
    nbytes = (4 * pixels + tracks * levels * 3 * p * p * 4
              + tracks * 2 * 4 + tracks * (2 * 4 + 4))
    flops = tracks * levels * (p * p * FLOPS_PER_PIXEL + FLOPS_PER_SOLVE)
    return nbytes, flops
