"""The rest of ``ip/`` and ``core/image``: colour, planar images, steerable
kernels, enhancement, FFT, wavelets, MLS and ``interpolate.in_bounds``;
the port against the JAX package on the same seeded numpy inputs, on the
CPU.

Tolerances: casts, clamps, rounding, integer histograms, compares, index
remaps and integer-valued stencils are exact; elementwise float32
arithmetic that IEEE rounds is exact; transcendental functions (exp, pow,
cbrt, atan2, cos) and float reductions, whose rounding or order differs
between XLA and PyTorch, agree to 1e-5 relative (float32) on values of
order one; the FFT paths (pocketfft in both, other plans) to 2e-4
absolute on 0-255 images; the wavelet denoisers to 5e-3 absolute on 0-255
images (their thresholds come from a float32 cumulative sum and a median);
the MLS maps (float32 weights summed in another order) to 1e-3 px; the
float32 Sobel of a non-integer image (shifted adds against XLA's
convolution) to 1e-5 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.core import image as jimage
from boofcv_tpu.ip import blur as jblur
from boofcv_tpu.ip import color as jcolor
from boofcv_tpu.ip import derivative as jderiv
from boofcv_tpu.ip import enhance as jenhance
from boofcv_tpu.ip import fft as jfft
from boofcv_tpu.ip import gray_ops as jgray
from boofcv_tpu.ip import interpolate as jinterp
from boofcv_tpu.ip import mls as jmls
from boofcv_tpu.ip import planar as jplanar
from boofcv_tpu.ip import steerable as jsteer
from boofcv_tpu.ip import wavelet as jwave
from boofcv_tpu.ip import weights as jweights
from boofcv_tpu_torch.core import image as timage
from boofcv_tpu_torch.ip import blur as tblur
from boofcv_tpu_torch.ip import color as tcolor
from boofcv_tpu_torch.ip import derivative as tderiv
from boofcv_tpu_torch.ip import enhance as tenhance
from boofcv_tpu_torch.ip import fft as tfft
from boofcv_tpu_torch.ip import gray_ops as tgray
from boofcv_tpu_torch.ip import interpolate as tinterp
from boofcv_tpu_torch.ip import mls as tmls
from boofcv_tpu_torch.ip import planar as tplanar
from boofcv_tpu_torch.ip import pyramid_ops as tpyr
from boofcv_tpu_torch.ip import steerable as tsteer
from boofcv_tpu_torch.ip import wavelet as twave
from boofcv_tpu_torch.ip import weights as tweights

torch.set_num_threads(1)
CPU = "cpu"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _gray(seed=0, h=40, w=52, integer=True):
    img = np.random.default_rng(seed).uniform(0, 255, (h, w))
    return (np.round(img) if integer else img).astype(np.float32)


def _rgb(seed=1, h=12, w=16, top=255.0):
    return np.random.default_rng(seed).uniform(0, top, (h, w, 3)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- core/image

def test_core_image_conversions_equal_jax():
    vals = np.array([[-3.0, 0.4, 2.5, 3.5], [254.5, 255.49, 300.0, 7.0]],
                    np.float32)
    np.testing.assert_array_equal(_np(timage.to_uint8(_t(vals))),
                                  _np(jimage.to_uint8(jnp.asarray(vals))))
    u8 = np.random.default_rng(0).integers(0, 256, (5, 6)).astype(np.uint8)
    got = timage.to_float32(u8, device=CPU)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), _np(jimage.to_float32(u8)))
    np.testing.assert_array_equal(_np(timage.rescale_to_unit(u8, CPU)),
                                  _np(jimage.rescale_to_unit(u8)))
    assert timage.ImageShape(3, 4).hw == jimage.ImageShape(3, 4).hw


# --------------------------------------------------------- gray ops, weights

def test_gray_ops_equal_jax():
    img = _gray(2, integer=False)
    for tf, jf, args in ((tgray.brighten, jgray.brighten, (40.0,)),
                         (tgray.stretch, jgray.stretch, (1.7, -20.0)),
                         (tgray.invert, jgray.invert, ())):
        np.testing.assert_array_equal(_np(tf(_t(img), *args)),
                                      _np(jf(jnp.asarray(img), *args)))


def test_weights_match_jax():
    np.testing.assert_array_equal(
        _np(tweights.uniform_pixel(3, device=CPU)),
        _np(jweights.uniform_pixel(3)))
    for kw in ({}, {"sigma": 1.3}, {"normalize": False}):
        np.testing.assert_allclose(
            _np(tweights.gaussian_pixel(4, device=CPU, **kw)),
            _np(jweights.gaussian_pixel(4, **kw)), rtol=1e-6, atol=1e-9)
    d2 = np.random.default_rng(3).uniform(0, 30, (7, 9)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tweights.distance_sq_gaussian(_t(d2), 2.5)),
        _np(jweights.distance_sq_gaussian(jnp.asarray(d2), 2.5)), rtol=1e-6)
    np.testing.assert_array_equal(
        _np(tweights.distance_uniform(_t(d2), 4.0)),
        _np(jweights.distance_uniform(jnp.asarray(d2), 4.0)))


# ------------------------------------------------------------------ colour

def test_hsv_matches_jax_and_round_trips():
    rgb = _rgb()
    rgb[0, 0] = [10.0, 10.0, 10.0]          # grey: hue 0, delta 0
    rgb[0, 1] = [200.0, 10.0, 100.0]        # red max, negative sector wraps
    rgb[0, 2] = [0.0, 0.0, 0.0]             # black: s 0
    hsv = tcolor.rgb_to_hsv(_t(rgb))
    want = _np(jcolor.rgb_to_hsv(jnp.asarray(rgb)))
    np.testing.assert_allclose(_np(hsv), want, rtol=1e-6, atol=1e-6)
    assert float(hsv[..., 0].min()) >= 0.0
    assert float(hsv[..., 0].max()) < 2 * np.pi
    back = tcolor.hsv_to_rgb(hsv)
    np.testing.assert_allclose(_np(back),
                               _np(jcolor.hsv_to_rgb(jnp.asarray(want))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(back), rgb, atol=1e-3)


def test_yuv_and_gray_match_jax():
    rgb = _rgb(4)
    for tf, jf in ((tcolor.rgb_to_yuv, jcolor.rgb_to_yuv),
                   (tcolor.yuv_to_rgb, jcolor.yuv_to_rgb),
                   (tcolor.rgb_to_gray, jcolor.rgb_to_gray)):
        np.testing.assert_allclose(_np(tf(_t(rgb))),
                                   _np(jf(jnp.asarray(rgb))), rtol=1e-6,
                                   atol=1e-4)


def test_xyz_and_lab_match_jax():
    rgb = _rgb(5, top=1.0)
    rgb[0, 0] = [0.01, 0.02, 0.03]          # the linear part of the curve
    rgb[0, 1] = [0.001, 0.0, 0.002]         # Lab's linear branch
    for tf, jf, src in ((tcolor.rgb_to_xyz, jcolor.rgb_to_xyz, rgb),
                        (tcolor.rgb_to_lab, jcolor.rgb_to_lab, rgb)):
        np.testing.assert_allclose(_np(tf(_t(src))),
                                   _np(jf(jnp.asarray(src))), rtol=1e-5,
                                   atol=2e-5)
    lab = _np(jcolor.rgb_to_lab(jnp.asarray(rgb)))
    xyz = _np(jcolor.rgb_to_xyz(jnp.asarray(rgb)))
    np.testing.assert_allclose(_np(tcolor.xyz_to_rgb(_t(xyz))),
                               _np(jcolor.xyz_to_rgb(jnp.asarray(xyz))),
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(_np(tcolor.lab_to_rgb(_t(lab))),
                               _np(jcolor.lab_to_rgb(jnp.asarray(lab))),
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(_np(tcolor.lab_to_rgb(_t(lab))), rgb,
                               atol=1e-4)


@pytest.mark.parametrize("h,w", [(16, 20), (17, 23)])
def test_yuv420_matches_jax(h, w):
    rgb = _rgb(6, h, w)
    ty, tu, tv = tcolor.rgb_to_yuv420(_t(rgb))
    jy, ju, jv = jcolor.rgb_to_yuv420(jnp.asarray(rgb))
    for a, b in ((ty, jy), (tu, ju), (tv, jv)):
        assert a.shape == b.shape
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-4)
    # byte planes, rounded as a caller storing them would
    y8, u8, v8 = [np.round(_np(p)).astype(np.uint8) for p in (jy, ju, jv)]
    np.testing.assert_allclose(
        _np(tcolor.yuv420_to_rgb(y8, u8, v8, device=CPU)),
        _np(jcolor.yuv420_to_rgb(y8, u8, v8)), rtol=1e-6, atol=1e-4)


# ------------------------------------------------------------------ planar

def test_per_band_loops_and_batches_bit_equal_to_band_calls():
    rgb = _rgb(7, 24, 30)
    t = _t(rgb)
    blurred = tplanar.per_band(tblur.gaussian, t, sigma=1.5)
    for c in range(3):
        assert torch.equal(blurred[..., c],
                           tblur.gaussian(t[..., c], sigma=1.5))
    np.testing.assert_allclose(
        _np(blurred), _np(jplanar.per_band(jblur.gaussian, jnp.asarray(rgb),
                                           sigma=1.5)), atol=2e-4)
    assert tderiv.sobel in tplanar.TAKES_PLANES
    dx, dy = tplanar.planar(tderiv.sobel)(t)
    jdx, jdy = jplanar.planar(jderiv.sobel)(jnp.asarray(rgb))
    for c in range(3):
        bx, by = tderiv.sobel(t[..., c])
        assert torch.equal(dx[..., c], bx) and torch.equal(dy[..., c], by)
    # float32 Sobel sums in another order than XLA's convolution
    np.testing.assert_allclose(_np(dx), _np(jdx), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(_np(dy), _np(jdy), rtol=1e-5, atol=1e-3)


def test_planar_pyramid_band_first_and_passthrough():
    from boofcv_tpu_torch.core.pyramid import PyramidConfig
    chw = _t(_rgb(8, 32, 48)).permute(2, 0, 1).contiguous()
    levels = tplanar.per_band(tpyr.pyramid_average, chw,
                              PyramidConfig((1, 2, 4)), band_axis=0)
    assert [tuple(lv.shape) for lv in levels] == [(3, 32, 48), (3, 16, 24),
                                                  (3, 8, 12)]
    for c in range(3):
        one = tpyr.pyramid_average(chw[c], PyramidConfig((1, 2, 4)))
        for a, b in zip(levels, one):
            assert torch.equal(a[c], b)
    gray = _t(_gray(9))
    assert torch.equal(tplanar.planar(tblur.mean)(gray, 2),
                       tblur.mean(gray, 2))


def test_split_merge_average_equal_jax():
    rgb = _rgb(10)
    bands = tplanar.split_bands(_t(rgb))
    for a, b in zip(bands, jplanar.split_bands(jnp.asarray(rgb))):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert torch.equal(tplanar.merge_bands(bands), _t(rgb))
    np.testing.assert_allclose(_np(tplanar.average_bands(_t(rgb))),
                               _np(jplanar.average_bands(jnp.asarray(rgb))),
                               rtol=1e-6)


# --------------------------------------------------------------- steerable

@pytest.mark.parametrize("ox,oy", [(1, 0), (0, 1), (2, 0), (0, 2), (1, 1)])
def test_steerable_basis_matches_jax(ox, oy):
    np.testing.assert_allclose(
        _np(tsteer.gaussian_basis_2d(ox, oy, 1.5, 4, device=CPU)),
        _np(jsteer.gaussian_basis_2d(ox, oy, 1.5, 4)), rtol=1e-5,
        atol=1e-7)


def test_steered_kernels_and_kernel_math_match_jax():
    for a in (0.0, 0.7, 2.1):
        np.testing.assert_allclose(
            _np(tsteer.steer_first_derivative(a, 1.2, 3, device=CPU)),
            _np(jsteer.steer_first_derivative(a, 1.2, 3)), atol=1e-6)
        np.testing.assert_allclose(
            _np(tsteer.steer_second_derivative(a, 1.2, 3, device=CPU)),
            _np(jsteer.steer_second_derivative(a, 1.2, 3)), atol=1e-6)
    a = np.array([1.0, 2.0, -1.0, 0.5], np.float32)
    b = np.array([0.25, 0.5, 0.25], np.float32)
    np.testing.assert_allclose(_np(tsteer.convolve_kernels_1d(_t(a), _t(b))),
                               _np(jsteer.convolve_kernels_1d(a, b)),
                               rtol=1e-6)
    k2 = _np(jsteer.convolve_kernel_2d_from_1d(a, b))
    np.testing.assert_array_equal(
        _np(tsteer.convolve_kernel_2d_from_1d(_t(a), _t(b))), k2)
    np.testing.assert_array_equal(_np(tsteer.transpose(_t(k2))),
                                  _np(jsteer.transpose(k2)))
    np.testing.assert_allclose(_np(tsteer.normalize_sum_to_one(_t(k2))),
                               _np(jsteer.normalize_sum_to_one(k2)),
                               rtol=1e-6)
    zero = np.zeros((3, 3), np.float32)
    assert torch.equal(tsteer.normalize_sum_to_one(_t(zero)), _t(zero))


# ----------------------------------------------------------------- enhance

def test_equalize_histogram_equals_jax():
    low = np.round(_gray(11) * 0.3 + 90).astype(np.float32)
    got = tenhance.equalize_histogram(_t(low))
    np.testing.assert_array_equal(_np(got),
                                  _np(jenhance.equalize_histogram(
                                      jnp.asarray(low))))
    assert float(got.max()) - float(got.min()) > 200


@pytest.mark.parametrize("radius", [1, 3])
def test_equalize_local_equals_jax(radius):
    img = _gray(12, 20, 26)
    np.testing.assert_array_equal(
        _np(tenhance.equalize_local(_t(img), radius)),
        _np(jenhance.equalize_local(jnp.asarray(img), radius)))


def test_sharpen_equals_jax():
    img = _gray(13)
    for tf, jf in ((tenhance.sharpen4, jenhance.sharpen4),
                   (tenhance.sharpen8, jenhance.sharpen8)):
        np.testing.assert_array_equal(_np(tf(_t(img))),
                                      _np(jf(jnp.asarray(img))))


# --------------------------------------------------------------------- fft

def test_fft_round_trip_and_shifts_match_jax():
    img = _gray(14, 32, 48, integer=False)
    spec = tfft.forward(_t(img))
    jspec = jfft.forward(img)
    assert spec.dtype == torch.complex64
    np.testing.assert_allclose(_np(spec), _np(jspec), atol=2e-2, rtol=1e-5)
    np.testing.assert_allclose(_np(tfft.inverse(spec)), img, atol=2e-4)
    np.testing.assert_array_equal(_np(tfft.shift(spec)),
                                  np.fft.fftshift(_np(spec)))
    assert torch.equal(tfft.unshift(tfft.shift(spec)), spec)
    np.testing.assert_allclose(_np(tfft.magnitude(spec)),
                               _np(jfft.magnitude(jspec)), rtol=1e-4,
                               atol=2e-2)
    np.testing.assert_array_equal(
        _np(tfft.multiply_spectra(spec, spec)), _np(spec * spec))


def test_lowpass_filter_matches_jax_and_numpy():
    img = _gray(15, 30, 44, integer=False)
    tr = tfft.gaussian_lowpass_transfer(30, 44, 0.2, device=CPU)
    jtr = jfft.gaussian_lowpass_transfer(30, 44, 0.2)
    assert tr.dtype == torch.float64
    np.testing.assert_allclose(_np(tr), _np(jtr), rtol=1e-13)
    out = tfft.filter_frequency(_t(img), tr)
    assert out.dtype == torch.float64
    want = np.real(np.fft.ifft2(np.fft.fft2(img.astype(np.float64)) *
                                _np(jtr)))
    np.testing.assert_allclose(_np(out), _np(jfft.filter_frequency(img, jtr)),
                               atol=2e-4)
    np.testing.assert_allclose(_np(out), want, atol=2e-4)
    assert float(out.std()) < img.std()


# ----------------------------------------------------------------- wavelet

@pytest.mark.parametrize("wave", ["haar", "daub4"])
@pytest.mark.parametrize("shape", [(32, 40), (33, 27)])
def test_dwt_matches_jax_and_reconstructs(wave, shape):
    img = _gray(16, *shape, integer=False)
    ll, bands = twave.dwt2(_t(img), wave)
    jll, jbands = jwave.dwt2(jnp.asarray(img), wave)
    np.testing.assert_allclose(_np(ll), _np(jll), atol=1e-4)
    for a, b in zip(bands, jbands):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-4)
    rec = twave.idwt2(ll, bands, wave, out_shape=shape)
    np.testing.assert_allclose(_np(rec), img, atol=2e-4)


@pytest.mark.parametrize("wave", ["haar", "daub4"])
def test_wavedec_waverec_match_jax(wave):
    img = _gray(17, 45, 62, integer=False)
    ll, coeffs = twave.wavedec2(_t(img), wave, levels=3)
    jll, jcoeffs = jwave.wavedec2(jnp.asarray(img), wave, levels=3)
    np.testing.assert_allclose(_np(ll), _np(jll), atol=5e-4)
    for bands, jb in zip(coeffs, jcoeffs):
        for a, b in zip(bands, jb):
            assert a.shape == b.shape
            np.testing.assert_allclose(_np(a), _np(b), atol=5e-4)
    rec = twave.waverec2(ll, coeffs, wave, out_shape=img.shape)
    np.testing.assert_allclose(_np(rec), img, atol=5e-4)


@pytest.mark.parametrize("n", [7, 8, 64, 65])
def test_noise_median_is_jnp_median_on_odd_and_even_counts(n):
    x = np.random.default_rng(n).normal(0, 3, n).astype(np.float32)
    got = twave._median(_t(x))
    np.testing.assert_array_equal(_np(got), _np(jnp.median(x)))
    if n % 2 == 0:
        # torch.median returns the lower middle value: not the reference's
        assert float(got) != float(torch.median(_t(x)))
    hh = x.reshape(1, n)
    np.testing.assert_array_equal(_np(twave._noise_sigma(_t(hh))),
                                  _np(jwave._noise_sigma(jnp.asarray(hh))))


def _noisy_scene(seed, h=48, w=64, sigma=10.0):
    yy, xx = np.mgrid[0:h, 0:w]
    clean = (120 + 60 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
             + 40 * ((xx // 16 + yy // 16) % 2)).astype(np.float32)
    noisy = clean + np.random.default_rng(seed).normal(0, sigma, clean.shape)
    return clean, noisy.astype(np.float32)


@pytest.mark.parametrize("rule", ["denoise_visu", "denoise_bayes",
                                  "denoise_sure"])
@pytest.mark.parametrize("wave", ["haar", "daub4"])
def test_denoisers_match_jax(rule, wave):
    clean, noisy = _noisy_scene(18)
    got = getattr(twave, rule)(_t(noisy), wave, levels=2)
    want = _np(getattr(jwave, rule)(jnp.asarray(noisy), wave, levels=2))
    np.testing.assert_allclose(_np(got), want, atol=5e-3)
    assert np.mean((_np(got) - clean) ** 2) < 0.8 * np.mean(
        (noisy - clean) ** 2)


# --------------------------------------------------------------------- MLS

_SRC = np.array([[10.0, 8.0], [40.0, 12.0], [25.0, 30.0], [8.0, 35.0],
                 [45.0, 38.0]], np.float32)
_DST = _SRC + np.array([[1.5, -1.0], [-2.0, 0.5], [0.0, 2.0], [1.0, 1.0],
                        [-1.0, -1.5]], np.float32)


@pytest.mark.parametrize("kind", ["affine", "similarity"])
def test_mls_maps_match_jax(kind):
    tf = {"affine": tmls.mls_affine, "similarity": tmls.mls_similarity}[kind]
    jf = {"affine": jmls.mls_affine, "similarity": jmls.mls_similarity}[kind]
    my, mx = tf(_SRC, _DST, 42, 50, device=CPU)
    jy, jx = jf(_SRC, _DST, 42, 50)
    np.testing.assert_allclose(_np(my), _np(jy), atol=1e-3)
    np.testing.assert_allclose(_np(mx), _np(jx), atol=1e-3)
    img = _gray(19, 42, 50, integer=False)
    out = tmls.deform(_t(img), _SRC, _DST, kind=kind)
    want = _np(jmls.deform(jnp.asarray(img), _SRC, _DST, kind=kind))
    np.testing.assert_allclose(_np(out), want, atol=0.3)
    # the control points map back onto their sources
    for (sx, sy), (dx, dy) in zip(_SRC, _DST):
        if dx == int(dx) and dy == int(dy):
            assert abs(float(my[int(dy), int(dx)]) - sy) < 1e-2


def test_mls_identity_leaves_the_image():
    img = _gray(20, 30, 34, integer=False)
    out = tmls.deform(_t(img), _SRC[:4] * 0.6, _SRC[:4] * 0.6)
    # a map 1e-5 px off the grid moves a 0-255 texture by up to 3e-3
    np.testing.assert_allclose(_np(out), img, atol=5e-3)


# -------------------------------------------------------------- in_bounds

def test_in_bounds_equals_jax():
    rng = np.random.default_rng(21)
    ys = rng.uniform(-2, 14, 200).astype(np.float32)
    xs = rng.uniform(-2, 20, 200).astype(np.float32)
    ys[:4] = [0.0, 11.0, -1e-6, 11.0 + 1e-6]
    for border in (0.0, 1.5):
        np.testing.assert_array_equal(
            _np(tinterp.in_bounds((12, 18), _t(ys), _t(xs), border)),
            _np(jinterp.in_bounds((12, 18), jnp.asarray(ys),
                                  jnp.asarray(xs), border)))


@pytest.mark.parametrize("name", ["wavelet_denoise", "image_enhancement"])
def test_example_passes_on_the_cpu(name):
    import importlib
    mod = importlib.import_module(f"boofcv_tpu_torch.examples.{name}")
    assert mod.main(["--device", "cpu"]) == 0


def test_slice_imports_no_jax():
    """The slice's modules and examples import torch and numpy, never JAX
    or the JAX package."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mods = ["core.image", "ip.gray_ops", "ip.weights", "ip.color",
            "ip.planar", "ip.steerable", "ip.enhance", "ip.fft",
            "ip.wavelet", "ip.mls", "utils.unionfind",
            "feature.segmentation", "feature.background",
            "feature.template", "feature.dense", "feature.lines",
            "feature.trackers", "examples.background_moving_camera",
            "examples.segment_superpixels", "examples.segment_graph_fh04",
            "examples.watershed_with_seeds", "examples.line_segments_ransac",
            "examples.template_matching", "examples.tracker_mean_shift",
            "examples.wavelet_denoise", "examples.image_enhancement"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module('boofcv_tpu_torch.' + m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'boofcv_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          env=dict(os.environ, PYTHONPATH=root),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
