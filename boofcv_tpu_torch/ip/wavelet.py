"""Discrete wavelet transform and wavelet denoising (port of
``boofcv_tpu/ip/wavelet.py``).

Reference analog: boofcv-ip alg/transform/wavelet/ (WaveletTransformOps,
the Haar / Daubechies-4 coefficient sets of FactoryWaveletDaub /
FactoryWaveletHaar) and alg/denoise/wavelet/ (DenoiseVisuShrink,
DenoiseBayesShrink, DenoiseSureShrink).

Each level is a pair of periodic filter banks, one a shifted
multiply-add per tap; images are edge-padded to even sizes per level.  The
thresholds are elementwise on the subbands.  The noise estimate takes the
median as ``jnp.median`` does, the mean of the two middle values of an even
count (``torch.median`` returns the lower one).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from boofcv_tpu_torch._config import as_tensor

WAVELETS = {
    "haar": np.array([1.0, 1.0]) / math.sqrt(2.0),
    "daub4": np.array([(1 + math.sqrt(3)), (3 + math.sqrt(3)),
                       (3 - math.sqrt(3)), (1 - math.sqrt(3))])
    / (4 * math.sqrt(2)),
}


def _filters(name: str):
    """(lo, hi) taps as the float32 values of the reference's filters, held
    as Python scalars: a multiply by one rounds as by a float32 tensor,
    and nothing is copied to the device."""
    lo = np.asarray(WAVELETS[name], np.float64)
    n = len(lo)
    hi = np.array([(-1) ** i * lo[n - 1 - i] for i in range(n)])
    return ([float(v) for v in lo.astype(np.float32)],
            [float(v) for v in hi.astype(np.float32)])


def _analysis_1d(x, lo, hi, axis: int):
    """Periodic downsampling filter bank along ``axis``: (approx, detail)."""
    n = x.shape[axis]
    k = len(lo)
    idx = torch.arange(n + k - 1, device=x.device) % n
    xe = torch.index_select(x, axis, idx)

    def corr(f):
        # correlation, then keep the even phases
        y = sum(torch.narrow(xe, axis, i, n) * f[i] for i in range(k))
        return torch.index_select(
            y, axis, torch.arange(0, n, 2, device=x.device))

    return corr(lo), corr(hi)


def _synthesis_1d(a, d, lo, hi, axis: int):
    """Inverse of :func:`_analysis_1d`: x[m] = sum_i lo[i] ya[(m-i) mod n]
    + hi[i] yd[(m-i) mod n] with ya / yd the zero-upsampled subbands."""
    k = len(lo)

    def up(x):
        shape = list(x.shape)
        shape[axis] *= 2
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        out.index_copy_(axis, torch.arange(0, shape[axis], 2,
                                           device=x.device), x)
        return out

    def conv(x, f):
        return sum(f[i] * torch.roll(x, i, dims=axis) for i in range(k))

    return conv(up(a), lo) + conv(up(d), hi)


def dwt2(image, wavelet: str = "haar", device=None):
    """One-level 2D DWT: (LL, (LH, HL, HH)).  Odd dimensions are
    edge-padded to even first, so ``idwt2(..., out_shape=image.shape)``
    recovers the image exactly."""
    img = as_tensor(image, torch.float32, device)
    lo, hi = _filters(wavelet)
    if img.shape[0] % 2:
        img = torch.cat([img, img[-1:]], dim=0)
    if img.shape[1] % 2:
        img = torch.cat([img, img[:, -1:]], dim=1)
    a, d = _analysis_1d(img, lo, hi, axis=1)
    aa, ad = _analysis_1d(a, lo, hi, axis=0)
    da, dd = _analysis_1d(d, lo, hi, axis=0)
    return aa, (da, ad, dd)


def idwt2(ll, bands, wavelet: str = "haar", out_shape=None):
    """Inverse of :func:`dwt2`; ``out_shape`` crops the padding."""
    lo, hi = _filters(wavelet)
    da, ad, dd = bands
    a = _synthesis_1d(ll, ad, lo, hi, axis=0)
    d = _synthesis_1d(da, dd, lo, hi, axis=0)
    x = _synthesis_1d(a, d, lo, hi, axis=1)
    if out_shape is not None:
        x = x[:out_shape[0], :out_shape[1]]
    return x


def wavedec2(image, wavelet: str = "haar", levels: int = 3, device=None):
    """Multi-level decomposition: (LL_n, [bands_n, ..., bands_1])."""
    coeffs = []
    cur = as_tensor(image, torch.float32, device)
    for _ in range(levels):
        cur, bands = dwt2(cur, wavelet)
        coeffs.append(bands)
    return cur, coeffs[::-1]


def waverec2(ll, coeffs, wavelet: str = "haar", out_shape=None):
    """Inverse of :func:`wavedec2`.  Each level's output size is the next
    finer level's subband size; ``out_shape`` crops the finest level."""
    cur = ll
    for i, bands in enumerate(coeffs):
        nxt = coeffs[i + 1][0].shape if i + 1 < len(coeffs) else out_shape
        cur = idwt2(cur, bands, wavelet, out_shape=nxt)
    return cur


# ---------------------------------------------------------------------------
# Denoising threshold rules (alg/denoise/wavelet/)
# ---------------------------------------------------------------------------

def _soft(x, t):
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of all the values: the middle one of an odd count,
    (lower + upper) * 0.5 of an even one."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _noise_sigma(hh: torch.Tensor) -> torch.Tensor:
    """Robust noise estimate median(|HH|) / 0.6745."""
    return _median(torch.abs(hh)) / 0.6745


def denoise_visu(image, wavelet: str = "haar", levels: int = 3,
                 device=None):
    """VisuShrink: the universal threshold sigma sqrt(2 log n)
    (DenoiseVisuShrink_F32)."""
    img = as_tensor(image, torch.float32, device)
    ll, coeffs = wavedec2(img, wavelet, levels)
    sigma = _noise_sigma(coeffs[-1][2])
    t = sigma * math.sqrt(2.0 * math.log(img.shape[0] * img.shape[1]))
    out = [tuple(_soft(b, t) for b in bands) for bands in coeffs]
    return waverec2(ll, out, wavelet, out_shape=img.shape)


def denoise_sure(image, wavelet: str = "haar", levels: int = 3,
                 device=None):
    """SureShrink: the per-subband threshold minimizing Stein's unbiased
    risk estimate (DenoiseSureShrink_F32), with the hybrid rule's fall-back
    to the universal threshold for a sparse subband.  SURE(t) is evaluated
    at every sorted magnitude (one sort of the subband)."""
    img = as_tensor(image, torch.float32, device)
    ll, coeffs = wavedec2(img, wavelet, levels)
    sigma = torch.clamp(_noise_sigma(coeffs[-1][2]), min=1e-12)

    def sure_threshold(b):
        y = (b / sigma).reshape(-1)
        n = y.shape[0]
        a = torch.sort(y * y).values
        cum = torch.cumsum(a, 0)
        k = torch.arange(1, n + 1, dtype=torch.float32, device=b.device)
        # risk at t^2 = a[k-1]: n - 2k + cum[k-1] + (n-k) a[k-1]
        risk = (n - 2.0 * k) + cum + (n - k) * a
        t_sure = torch.sqrt(torch.index_select(
            a, 0, torch.argmin(risk).reshape(1))[0])
        # the two constants of the subband's size, in float32 on the host
        nf = np.float32(n)
        t_univ = float(np.sqrt(np.float32(2.0) * np.log(nf)))
        magic = float(np.log2(nf) ** np.float32(1.5) / np.sqrt(nf))
        energy = (cum[-1] - n) / n
        t = torch.where(energy <= magic, t_univ,
                        torch.clamp(t_sure, max=t_univ))
        return t * sigma

    out = [tuple(_soft(b, sure_threshold(b)) for b in bands)
           for bands in coeffs]
    return waverec2(ll, out, wavelet, out_shape=img.shape)


def denoise_bayes(image, wavelet: str = "haar", levels: int = 3,
                  device=None):
    """BayesShrink: per-subband t = sigma^2 / sigma_x
    (DenoiseBayesShrink_F32)."""
    img = as_tensor(image, torch.float32, device)
    ll, coeffs = wavedec2(img, wavelet, levels)
    sigma = _noise_sigma(coeffs[-1][2])
    s2 = sigma * sigma
    out = []
    for bands in coeffs:
        thr = []
        for b in bands:
            sig_x = torch.sqrt(torch.clamp(torch.mean(b * b) - s2,
                                           min=1e-12))
            thr.append(_soft(b, s2 / sig_x))
        out.append(tuple(thr))
    return waverec2(ll, out, wavelet, out_shape=img.shape)
