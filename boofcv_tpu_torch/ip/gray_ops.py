"""Basic gray-level intensity maps (port of ``boofcv_tpu/ip/gray_ops.py``).

Reference analog: boofcv-ip alg/filter/basic/GrayImageOps.java —
brighten, stretch, invert (with clamping to the image's value range).
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch._config import as_tensor


def brighten(image, beta: float, max_value: float = 255.0) -> torch.Tensor:
    """I + beta, clamped (GrayImageOps.brighten)."""
    return torch.clamp(as_tensor(image, torch.float32) + beta, 0.0,
                       max_value)


def stretch(image, gamma: float, beta: float,
            max_value: float = 255.0) -> torch.Tensor:
    """gamma*I + beta, clamped (GrayImageOps.stretch)."""
    return torch.clamp(as_tensor(image, torch.float32) * gamma + beta, 0.0,
                       max_value)


def invert(image, max_value: float = 255.0) -> torch.Tensor:
    """max - I (GrayImageOps.invert)."""
    return max_value - as_tensor(image, torch.float32)
