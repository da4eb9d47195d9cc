"""Image enhancement: histogram equalization, sharpening, wavelet denoise
(port of ``boofcv_tpu/examples/image_enhancement.py``).

Reference analogs: examples/enhance/ExampleImageEnhancement.java and
ExampleWaveletDenoise.java.

    python -m boofcv_tpu_torch.examples.image_enhancement [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.io import simulate
from boofcv_tpu_torch.ip import enhance, wavelet


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    rng = np.random.default_rng(16)
    # noise_texture is about [0, 255]: squeeze it into a low-contrast band
    base = simulate.noise_texture(rng, size=160, octaves=4) * 0.25 + 96.0
    img = torch.as_tensor(base[:128, :128], dtype=torch.float32, device=dev)
    lo, hi = float(img.min()), float(img.max())
    print(f"device: {dev}")
    # equalization stretches a low-contrast image to the full range
    eq = enhance.equalize_histogram(img)
    print(f"equalize: input range [{lo:.0f}, {hi:.0f}] -> "
          f"[{float(eq.min()):.0f}, {float(eq.max()):.0f}]")
    ok = float(eq.max()) - float(eq.min()) > 1.8 * (hi - lo)
    # sharpening raises the local gradient energy
    sh = enhance.sharpen4(img)
    g0 = float(torch.abs(torch.diff(img, dim=1)).mean())
    g1 = float(torch.abs(torch.diff(sh, dim=1)).mean())
    print(f"sharpen4: mean |gradient| {g0:.2f} -> {g1:.2f}")
    ok &= g1 > g0
    # wavelet denoising removes most of an added noise layer
    noisy = img + torch.as_tensor(rng.normal(0, 12, tuple(img.shape)),
                                  dtype=torch.float32, device=dev)
    den = wavelet.denoise_bayes(noisy, levels=3)
    e_noisy = float(torch.sqrt(torch.mean((noisy - img) ** 2)))
    e_den = float(torch.sqrt(torch.mean((den - img) ** 2)))
    print(f"wavelet denoise (BayesShrink): RMSE {e_noisy:.1f} -> "
          f"{e_den:.1f}")
    ok &= e_den < 0.7 * e_noisy
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
