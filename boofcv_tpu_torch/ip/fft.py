"""Discrete Fourier transform ops (port of ``boofcv_tpu/ip/fft.py``).

Reference analog: boofcv-ip alg/transform/fft/ (GeneralPurposeFFT_F32_*,
DiscreteFourierTransformOps.java).  ``torch.fft`` (cuFFT on the card) does
the transforms, as the JAX package calls ``jnp.fft``; this module gives the
reference's utility surface.  Dtypes follow the JAX package under float64:
a float32 image has a complex64 spectrum, the low-pass transfer function is
float64, so a filtered float32 image comes back in float64.
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch._config import as_tensor, resolve_device


def forward(image, device=None) -> torch.Tensor:
    """2D FFT of a real image -> complex spectrum."""
    return torch.fft.fft2(as_tensor(image, torch.float32, device))


def inverse(spectrum: torch.Tensor) -> torch.Tensor:
    """Inverse 2D FFT -> real image."""
    return torch.real(torch.fft.ifft2(spectrum))


def magnitude(spectrum: torch.Tensor) -> torch.Tensor:
    return torch.abs(spectrum)


def phase(spectrum: torch.Tensor) -> torch.Tensor:
    return torch.angle(spectrum)


def shift(spectrum: torch.Tensor) -> torch.Tensor:
    """Centre the zero frequency (DiscreteFourierTransformOps.shift)."""
    return torch.fft.fftshift(spectrum)


def unshift(spectrum: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifftshift(spectrum)


def multiply_spectra(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise complex product (frequency-domain convolution)."""
    return a * b


def filter_frequency(image, transfer: torch.Tensor,
                     device=None) -> torch.Tensor:
    """Apply a frequency-domain transfer function (same shape, real or
    complex, zero frequency at the corner) and return the real image."""
    return inverse(forward(image, device) * transfer)


def gaussian_lowpass_transfer(height: int, width: int, sigma_frac: float,
                              device=None) -> torch.Tensor:
    """Gaussian low-pass transfer function (float64); sigma as a fraction
    of the Nyquist frequency."""
    dev = resolve_device(device)
    fy = torch.fft.fftfreq(height, dtype=torch.float64, device=dev)
    fx = torch.fft.fftfreq(width, dtype=torch.float64, device=dev)
    d2 = fy[:, None] ** 2 + fx[None, :] ** 2
    s = sigma_frac * 0.5
    return torch.exp(-0.5 * d2 / (s * s))

