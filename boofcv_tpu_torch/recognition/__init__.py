"""Fiducials, QR codes, calibration targets, the TLD tracker, bag of
words and DeepBoof classifiers (port of boofcv_tpu.recognition).

The detectors keep the reference's split: thresholds, labels, corner
responses and homographies on the device; contours (the native tracer),
shape fits, lattice assembly and decoding in numpy on the host; TLD's
pyramids, KLT and patches on the device, its fern cascade and learning on
the host.  Each entry point takes ``device=`` (default the card); an image
that is already a tensor stays on its device unless ``device`` names
another.
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import as_tensor
from boofcv_tpu_torch.geo import epipolar


def image_on_device(image, device=None) -> tuple:
    """(float32 [H, W] tensor on the device, float32 numpy copy on the
    host) of ``image``, a numpy array or a tensor."""
    img = as_tensor(image, torch.float32, device)
    if isinstance(image, torch.Tensor):
        return img, image.detach().to(torch.float32).cpu().numpy()
    return img, np.asarray(image, np.float32)


def homographies(src, dst, device) -> np.ndarray:
    """[..., 3, 3] float64 numpy homographies mapping ``src`` to ``dst``
    ([..., N, 2] each, broadcast), fitted as one batched DLT on ``device``
    (one host sync for the batch)."""
    s = torch.as_tensor(np.asarray(src, np.float64), device=device)
    d = torch.as_tensor(np.asarray(dst, np.float64), device=device)
    s, d = torch.broadcast_tensors(s, d)
    return epipolar.homography_dlt(s, d).cpu().numpy()
