"""Convolution helpers (port of ``boofcv_tpu/ip/convolve.py``: ``pad``, and
``pad_planes`` for [..., H, W]).

The port computes its small stencils as shifted adds instead of
``conv2d``, which cuDNN would run in TF32 by default."""

from __future__ import annotations

from boofcv_tpu_torch.core.border import (BorderType, pad,  # noqa: F401
                                          pad_planes)
