"""Rectified-stereo geometry (port of ``boofcv_tpu/geo/rectify.py``:
``pixel_to_3d_rectified``)."""

from __future__ import annotations

import torch


def pixel_to_3d_rectified(xs, ys, disp, rectK, baseline: float):
    """Rectified pixel + disparity -> 3D in the rectified left-camera frame
    (StereoSparse3D.process analog).  float64 on the VO path."""
    f = rectK[0, 0]
    cx = rectK[0, 2]
    cy = rectK[1, 2]
    safe = torch.where(disp > 0, disp, 1.0)
    z = f * baseline / safe
    x = (xs - cx) * z / f
    y = (ys - cy) * z / f
    return torch.stack([x, y, z], dim=-1)
