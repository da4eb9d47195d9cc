"""Fault for the harness's own tests: the refine's pose is turned by
1e-3 rad about the optical axis where it is produced."""

import math

import torch


def apply(port):
    from boofcv_tpu_torch.geo import pnp
    orig = pnp.gauss_newton_pose

    def broken(*a, **k):
        R, t = orig(*a, **k)
        c, s = math.cos(1e-3), math.sin(1e-3)
        turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                            dtype=R.dtype, device=R.device)
        return turn @ R, t

    pnp.gauss_newton_pose = broken

    def undo():
        pnp.gauss_newton_pose = orig
    return undo
