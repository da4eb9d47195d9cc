"""Frequency-domain filtering with the discrete Fourier transform (port of
``boofcv_tpu/examples/fourier_transform.py``).

Reference analog: examples/imageprocessing/ExampleFourierTransform.java —
forward DFT, magnitude display, low-pass filtering by spectrum
multiplication.  Oracle: a Gaussian low-pass applied in the frequency domain
matches spatial Gaussian smoothing, and kills the injected high-frequency
stripe. The JAX example's ``--tpu`` flag and ``setup_backend`` have no
counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.fourier_transform [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.ip import fft


def _scene():
    """(smooth, stripe): a slow sinusoid and high-frequency stripes."""
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    smooth = 100 + 40 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
    stripe = 30 * np.sin(xx * 2.6)                 # high-frequency noise
    return smooth, stripe


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    smooth, stripe = _scene()
    img = smooth + stripe
    mag = fft.magnitude(fft.forward(img, device=dev)).cpu().numpy()
    transfer = fft.gaussian_lowpass_transfer(96, 128, sigma_frac=0.06,
                                             device=dev)
    out = fft.filter_frequency(img, transfer, device=dev).cpu().numpy()
    print(f"device: {dev}")
    resid_smooth = np.abs(out - smooth)[8:-8, 8:-8]
    stripe_power_in = np.std(stripe)
    stripe_power_out = np.std((out - smooth)[8:-8, 8:-8])
    print(f"spectrum peak at DC: {bool(mag.argmax() == 0)}; "
          f"stripe std {stripe_power_in:.1f} -> {stripe_power_out:.1f} "
          f"after low-pass (median |out-smooth| "
          f"{np.median(resid_smooth):.2f})")
    ok = (mag.argmax() == 0 and stripe_power_out < 0.15 * stripe_power_in
          and np.median(resid_smooth) < 4.0)
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
