"""Precision policy of the port (counterpart of ``boofcv_tpu/_config.py``).

The reference runs images, pyramids and KLT in float32; world points, the
pose, ``pixel_to_3d_rectified`` and the returned pose in float64; the P3P
hypothesis bank, its K x N scoring and the Gauss-Newton refine loop in
float32, followed by a float64 Newton-polar re-orthogonalisation.  The port
keeps those dtypes function by function (``IMAGE_DTYPE`` / ``GEO_DTYPE``).

The port's entry points run on the card unless the caller names another
device: :func:`resolve_device` maps ``None`` to CUDA and raises without one.

Nothing on the path may run in TF32: PyTorch lets cuDNN convolutions use it
by default on Hopper.  Importing the package turns both TF32 switches off
for the process, as importing the reference turns float64 on for JAX.  The
path also avoids ``conv2d`` altogether (shifted adds and pooling instead).
"""

from __future__ import annotations

import torch

IMAGE_DTYPE = torch.float32
GEO_DTYPE = torch.float64

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    card.  Without a card ``None`` raises; nothing moves to the CPU
    quietly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False): "
            "boofcv_tpu_torch runs on the card unless the caller passes a "
            "device, e.g. device='cpu'")
    return torch.device("cuda")


def as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """``x`` as a tensor of ``dtype``: a tensor stays on its device unless
    ``device`` names another; anything else (numpy, lists) goes to
    :func:`resolve_device` (``device``)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.to(dtype) if dtype is not None else x
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))
