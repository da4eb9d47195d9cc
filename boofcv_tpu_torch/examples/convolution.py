"""Convolution: 1D separable, 2D, and edge-renormalized variants (port of
``boofcv_tpu/examples/convolution.py``).

Reference analog: examples/imageprocessing/ExampleConvolution.java —
horizontal/vertical 1D kernels, full 2D kernels, normalized borders. Oracle:
separable Gaussian equals the equivalent 2D kernel; normalized borders keep
a constant image constant. The JAX example's ``--tpu`` flag and
``setup_backend`` have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.convolution [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.core.border import BorderType
from boofcv_tpu_torch.core.kernel import gaussian_kernel
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.ip import convolve


def _scene():
    rng = np.random.default_rng(5)
    return rng.uniform(0, 255, (48, 64)).astype(np.float32)


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    img = torch.as_tensor(_scene(), device=dev)
    k1 = gaussian_kernel(sigma=1.5, device=dev)
    sep = convolve.separable(img, k1, k1, BorderType.EXTENDED)
    full = convolve.convolve2d(img, torch.outer(k1, k1), BorderType.EXTENDED)
    err_sep = float(torch.abs(sep - full).max())
    # normalized border: a constant image stays exactly constant
    const = torch.full((32, 40), 77.0, dtype=torch.float32, device=dev)
    normed = convolve.separable(const, k1, k1, BorderType.NORMALIZED)
    err_norm = float(torch.abs(normed - 77.0).max())
    # horizontal derivative kernel responds to a vertical edge only
    d = torch.tensor([-1.0, 0.0, 1.0], device=dev)
    edge = torch.zeros((30, 40), dtype=torch.float32, device=dev)
    edge[:, 20:] = 100.0
    h_max = float(torch.abs(convolve.horizontal(edge, d,
                                                BorderType.EXTENDED)).max())
    v_max = float(torch.abs(convolve.vertical(edge, d,
                                              BorderType.EXTENDED)).max())
    print(f"device: {dev}")
    print(f"separable-vs-2D max err {err_sep:.2e}; normalized-border "
          f"constancy err {err_norm:.2e}; edge response h "
          f"{h_max:.0f} / v {v_max:.0f}")
    ok = err_sep < 1e-3 and err_norm < 1e-3 and h_max > 50 and v_max < 1e-3
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
