"""Bytes and operations that one sparse SAD block match needs, from its
inputs alone (the two images' shape, the candidate positions, the
disparity range and the block radii), whatever kernels do the work.

Bytes: every float32 pixel of the left image under some candidate's block
and of the right image under some candidate's strip of blocks (the rows
of the block, the columns from x - r - (max - 1) to x + r - min, inside
the image), read once; the positions in; a disparity and a valid flag
out.  Operations: for every candidate and disparity, a difference, an
absolute value and a sum a block pixel.
"""

from __future__ import annotations

import numpy as np


def capture(args, kwargs) -> dict:
    """What ``count`` needs of a ``sparse_block_match(left, right, ys, xs,
    cfg)`` call."""
    left, right, ys, xs = args[:4]
    cfg = args[4] if len(args) > 4 else kwargs["cfg"]
    return {"shape": tuple(left.shape[-2:]), "ys": ys, "xs": xs,
            "min": int(cfg.min_disparity), "max": int(cfg.max_disparity),
            "rx": int(cfg.radius_x), "ry": int(cfg.radius_y)}


def _covered(h, w, y0, y1, x0, x1) -> int:
    """Pixels of an h x w image inside the union of row spans [y0, y1]
    by column spans [x0, x1] (inclusive, clipped to the image)."""
    mask = np.zeros((h, w), bool)
    for a, b, c, d in zip(np.clip(y0, 0, h), np.clip(y1 + 1, 0, h),
                          np.clip(x0, 0, w), np.clip(x1 + 1, 0, w)):
        mask[a:b, c:d] = True
    return int(mask.sum())


def count(rec: dict) -> tuple:
    ys = np.asarray(rec["ys"].detach().cpu(), np.int64).reshape(
        -1, rec["ys"].shape[-1])
    xs = np.asarray(rec["xs"].detach().cpu(), np.int64).reshape(ys.shape)
    h, w = rec["shape"]
    rx, ry, lo, hi = rec["rx"], rec["ry"], rec["min"], rec["max"]
    n_disp = hi - lo
    pixels = 0
    for b in range(ys.shape[0]):
        y, x = ys[b], xs[b]
        pixels += _covered(h, w, y - ry, y + ry, x - rx, x + rx)
        pixels += _covered(h, w, y - ry, y + ry, x - rx - (hi - 1), x + rx - lo)
    cands = ys.size
    block = (2 * rx + 1) * (2 * ry + 1)
    nbytes = 4 * pixels + cands * 2 * 4 + cands * (4 + 1)
    flops = cands * n_disp * block * 3
    return nbytes, flops
