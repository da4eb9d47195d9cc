"""Fault: RANSAC keeps no inlier, so every step retires every track it
tracked and respawns into the emptied slots; the pose stays the refined
one and usable.  Listed under ``faults`` in a test cell's settings, and
read on the card by ``control.py --fault retire_all``; never in a
benchmark cell."""

import torch


def apply(port):
    from boofcv_tpu_torch.geo import robust
    orig = robust.ransac_pnp

    def broken(*a, **k):
        res, pose = orig(*a, **k)
        return res._replace(inliers=torch.zeros_like(res.inliers)), pose

    robust.ransac_pnp = broken

    def undo():
        robust.ransac_pnp = orig
    return undo
