"""Wavelet shrinkage denoising (port of
``boofcv_tpu/examples/wavelet_denoise.py``).

Reference analog: examples/imageprocessing/ExampleWaveletDenoise.java —
BayesShrink thresholding of DWT coefficients.  Oracle: denoising a
known-clean image with added Gaussian noise must halve the MSE.

    python -m boofcv_tpu_torch.examples.wavelet_denoise [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.ip import wavelet


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float32)
    clean = (120 + 60 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
             + 40 * ((xx // 32 + yy // 32) % 2))
    sigma = 20.0
    noisy = clean + rng.normal(0, sigma, clean.shape).astype(np.float32)
    out = wavelet.denoise_bayes(torch.as_tensor(noisy, device=dev),
                                levels=3).cpu().numpy()
    mse_in = float(np.mean((noisy - clean) ** 2))
    mse_out = float(np.mean((out - clean) ** 2))
    print(f"device: {dev}")
    print(f"noise sigma {sigma}: MSE {mse_in:.1f} -> {mse_out:.1f} "
          f"({mse_in / mse_out:.1f}x reduction, BayesShrink)")
    ok = mse_out < 0.5 * mse_in
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
