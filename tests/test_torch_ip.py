"""Image processing: the port against the JAX package on the same numpy
inputs (integer-valued 0-255 images, like a camera's), atol 1e-4."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.core import border as jborder
from boofcv_tpu.core.pyramid import PyramidConfig as JPyramidConfig
from boofcv_tpu.ip import derivative as jderiv
from boofcv_tpu.ip import interpolate as jinterp
from boofcv_tpu.ip import pyramid_ops as jpyr
from boofcv_tpu_torch.core import border as tborder
from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.ip import derivative as tderiv
from boofcv_tpu_torch.ip import interpolate as tinterp
from boofcv_tpu_torch.ip import pyramid_ops as tpyr

torch.set_num_threads(1)
ATOL = 1e-4


def _image(seed, h=123, w=161):
    rng = np.random.default_rng(seed)
    return np.round(rng.uniform(0, 255, (h, w))).astype(np.float32)


def _close(a, b, atol=ATOL):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=atol)


@pytest.mark.parametrize("border", ["EXTENDED", "REFLECT", "WRAP", "ZERO"])
def test_pad(border):
    img = _image(0, 9, 11)
    ref = jborder.pad(jnp.asarray(img), 2, 3, jborder.BorderType[border])
    out = tborder.pad(torch.from_numpy(img), 2, 3, tborder.BorderType[border])
    _close(ref, out, 0)
    img3 = np.stack([img, img + 1], -1)
    ref = jborder.pad(jnp.asarray(img3), 1, 2, jborder.BorderType[border])
    out = tborder.pad(torch.from_numpy(img3), 1, 2,
                      tborder.BorderType[border])
    _close(ref, out, 0)


@pytest.mark.parametrize("border", ["EXTENDED", "REFLECT", "WRAP", "ZERO"])
@pytest.mark.parametrize("h,w", [(3, 4), (1, 5), (7, 1)])
def test_pad_any_radius(border, h, w):
    """Radii from 0 to 3x the size on each axis (every one where ``F.pad``'s
    reflect or circular mode stops: size - 1, size, size + 1), bit-equal to
    ``jnp.pad`` (2-D, channels-last and planes)."""
    img = _image(9, h, w)
    b_j, b_t = jborder.BorderType[border], tborder.BorderType[border]
    radii = lambda n: sorted({0, 1, n - 1, n, n + 1, 2 * n, 2 * n + 1, 3 * n})
    for ry in radii(h):
        for rx in radii(w):
            ref = np.asarray(jborder.pad(jnp.asarray(img), ry, rx, b_j))
            _close(ref, tborder.pad(torch.from_numpy(img), ry, rx, b_t), 0)
            planes = tborder.pad_planes(
                torch.from_numpy(np.stack([img, img])), ry, rx, b_t)
            _close(np.stack([ref, ref]), planes, 0)
    img3 = np.stack([img, 2 * img], -1)
    ref = jborder.pad(jnp.asarray(img3), 3 * h, 3 * w, b_j)
    _close(ref, tborder.pad(torch.from_numpy(img3), 3 * h, 3 * w, b_t), 0)


@pytest.mark.parametrize("scales", [(1, 2, 4), (1, 2, 4, 8), (1, 4)])
def test_pyramid_average(scales):
    img = _image(1)
    ref = jpyr.pyramid_average(jnp.asarray(img), JPyramidConfig(scales))
    out = tpyr.pyramid_average(torch.from_numpy(img), PyramidConfig(scales))
    assert len(ref) == len(out)
    for a, b in zip(ref, out):
        _close(a, b)


def test_sobel():
    img = _image(2)
    (rx, ry), (tx, ty) = (jderiv.sobel(jnp.asarray(img)),
                          tderiv.sobel(torch.from_numpy(img)))
    _close(rx, tx)
    _close(ry, ty)


def test_pyramid_gradient():
    img = _image(3, 128, 160)
    jp = jpyr.pyramid_average(jnp.asarray(img), JPyramidConfig((1, 2, 4)))
    tp = tpyr.pyramid_average(torch.from_numpy(img), PyramidConfig((1, 2, 4)))
    (jdx, jdy), (tdx, tdy) = jpyr.gradient(jp), tpyr.gradient(tp)
    for a, b in zip(jdx + jdy, tdx + tdy):
        _close(a, b)


def _coords(rng, n, h, w):
    """Float coordinates including negative, near-border and past-border
    values."""
    ys = rng.uniform(-2.5, h + 1.5, n)
    xs = rng.uniform(-2.5, w + 1.5, n)
    ys[:6] = [-0.5, -1.0, 0.0, h - 1, h - 0.5, -0.999]
    xs[:6] = [-0.25, w - 1, -1.5, 0.0, w - 0.75, w + 0.3]
    return ys.astype(np.float32), xs.astype(np.float32)


def test_bilinear():
    img = _image(4, 40, 50)
    ys, xs = _coords(np.random.default_rng(4), 300, 40, 50)
    ref = jinterp.bilinear(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs))
    out = tinterp.bilinear(torch.from_numpy(img), torch.from_numpy(ys),
                           torch.from_numpy(xs))
    _close(ref, out)


@pytest.mark.parametrize("radius", [1, 3])
def test_sample_rect_bilinear(radius):
    img = _image(5, 40, 50)
    cy, cx = _coords(np.random.default_rng(5 + radius), 200, 40, 50)
    ref = jinterp.sample_rect_bilinear(jnp.asarray(img), jnp.asarray(cy),
                                       jnp.asarray(cx), radius)
    out = tinterp.sample_rect_bilinear(torch.from_numpy(img),
                                       torch.from_numpy(cy),
                                       torch.from_numpy(cx), radius)
    _close(ref, out)


def test_sample_rect_bilinear_multi():
    stack = np.stack([_image(6, 40, 50), _image(7, 40, 50) - 128.0,
                      _image(8, 40, 50)])
    cy, cx = _coords(np.random.default_rng(6), 200, 40, 50)
    ref = jinterp.sample_rect_bilinear_multi(
        jnp.asarray(stack), jnp.asarray(cy), jnp.asarray(cx), 3)
    out = tinterp.sample_rect_bilinear_multi(
        torch.from_numpy(stack), torch.from_numpy(cy), torch.from_numpy(cx),
        3)
    _close(ref, out)


# ---- kernels, convolution, blur, census ---------------------------------

from boofcv_tpu.core import kernel as jkernel  # noqa: E402
from boofcv_tpu.ip import blur as jblur  # noqa: E402
from boofcv_tpu.ip import census as jcensus  # noqa: E402
from boofcv_tpu.ip import convolve as jconv  # noqa: E402
from boofcv_tpu_torch.core import kernel as tkernel  # noqa: E402
from boofcv_tpu_torch.ip import blur as tblur  # noqa: E402
from boofcv_tpu_torch.ip import census as tcensus  # noqa: E402
from boofcv_tpu_torch.ip import convolve as tconv  # noqa: E402

BORDERS = ["SKIP", "NORMALIZED", "EXTENDED", "REFLECT", "WRAP", "ZERO"]


def _rel(ref, out, rel=1e-6):
    """Within ``rel`` of the reference's largest entry (1e-6: float32
    sums of a handful of taps in another order)."""
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert ref.shape == out.shape and ref.dtype == out.dtype
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * max(float(np.abs(ref).max()), 1e-30))


def test_gaussian_sigma_radius_maps():
    for r in (1, 2, 5, 9):
        for order in (0, 1, 2):
            assert (tkernel.gaussian_sigma_for_radius(r, order)
                    == jkernel.gaussian_sigma_for_radius(r, order))
    for sigma in (0.5, 1.0, 1.5, 3.3):
        for order in (0, 1):
            assert (tkernel.gaussian_radius_for_sigma(sigma, order)
                    == jkernel.gaussian_radius_for_sigma(sigma, order))


@pytest.mark.parametrize("name", ["gaussian_kernel", "gaussian_deriv_kernel",
                                  "gaussian_kernel_2d"])
@pytest.mark.parametrize("kw", [{"sigma": 1.5}, {"radius": 3},
                                {"sigma": 2.0, "radius": 4}])
def test_gaussian_kernels(name, kw):
    _rel(getattr(jkernel, name)(**kw),
         getattr(tkernel, name)(device="cpu", **kw))
    ref64 = getattr(jkernel, name)(dtype=jnp.float64, **kw)
    out64 = getattr(tkernel, name)(dtype=torch.float64, device="cpu", **kw)
    _rel(ref64, out64, 1e-12)


def test_kernel_needs_sigma_or_radius_and_a_device():
    with pytest.raises(ValueError):
        tkernel.gaussian_kernel(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tkernel.gaussian_kernel(sigma=1.0)      # device=None is the card


def test_mean_and_normalize_kernel():
    _rel(jkernel.mean_kernel(3), tkernel.mean_kernel(3, device="cpu"))
    k = np.array([1.0, 2.0, 5.0, 2.0], np.float32)
    _rel(jkernel.normalize_kernel(jnp.asarray(k)),
         tkernel.normalize_kernel(torch.from_numpy(k)))
    z = np.array([1.0, -1.0], np.float32)           # zero sum: unchanged
    _rel(jkernel.normalize_kernel(jnp.asarray(z)),
         tkernel.normalize_kernel(torch.from_numpy(z)))


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("fn", ["horizontal", "vertical"])
def test_convolve_1d(fn, border):
    img = _image(10, 48, 64)
    k = np.array([0.1, -0.3, 0.5, 0.2, 0.4], np.float32)     # asymmetric
    ref = getattr(jconv, fn)(jnp.asarray(img), jnp.asarray(k),
                             jborder.BorderType[border])
    out = getattr(tconv, fn)(torch.from_numpy(img), torch.from_numpy(k),
                             tborder.BorderType[border])
    _rel(ref, out)


@pytest.mark.parametrize("border", BORDERS)
def test_convolve2d(border):
    img = _image(11, 48, 64)
    k = np.random.default_rng(11).normal(0, 1, (3, 5)).astype(np.float32)
    ref = jconv.convolve2d(jnp.asarray(img), jnp.asarray(k),
                           jborder.BorderType[border])
    out = tconv.convolve2d(torch.from_numpy(img), torch.from_numpy(k),
                           tborder.BorderType[border])
    _rel(ref, out)


@pytest.mark.parametrize("border", ["EXTENDED", "NORMALIZED", "SKIP"])
def test_convolve_separable(border):
    img = _image(12, 48, 64)
    kx = np.array([0.25, 0.5, 0.25], np.float32)
    ky = np.array([0.1, 0.2, 0.4, 0.2, 0.1], np.float32)
    ref = jconv.separable(jnp.asarray(img), jnp.asarray(kx), jnp.asarray(ky),
                          jborder.BorderType[border])
    out = tconv.separable(torch.from_numpy(img), torch.from_numpy(kx),
                          torch.from_numpy(ky), tborder.BorderType[border])
    _rel(ref, out)


@pytest.mark.parametrize("kw", [{"sigma": 1.5}, {"radius": 2}])
def test_blur_gaussian(kw):
    img = _image(13, 48, 64)
    _rel(jblur.gaussian(jnp.asarray(img), **kw),
         tblur.gaussian(torch.from_numpy(img), **kw))
    # an integer image is blurred in float32
    u8 = img.astype(np.uint8)
    _rel(jblur.gaussian(jnp.asarray(u8), **kw),
         tblur.gaussian(torch.from_numpy(u8), **kw))


def test_blur_mean():
    img = _image(14, 48, 64)
    _rel(jblur.mean(jnp.asarray(img), 2),
         tblur.mean(torch.from_numpy(img), 2))


@pytest.mark.parametrize("radius", [1, 2])
def test_blur_median(radius):
    """A selection, not arithmetic: exact."""
    img = _image(15, 48, 64)
    _close(jblur.median(jnp.asarray(img), radius),
           tblur.median(torch.from_numpy(img), radius), 0)


@pytest.mark.parametrize("fn", ["dense3x3", "dense5x5"])
def test_census(fn):
    """Census codes are exact, ties (equal neighbours) included."""
    img = np.round(np.random.default_rng(16).uniform(0, 6, (48, 64))
                   ).astype(np.float32)
    ref = np.asarray(getattr(jcensus, fn)(jnp.asarray(img)))
    out = getattr(tcensus, fn)(torch.from_numpy(img))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_census_hamming_distance():
    """Exact, on words with bit 31 set, all ones and all zeros."""
    rng = np.random.default_rng(17)
    a = rng.integers(-2**31, 2**31, 500, dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, 500, dtype=np.int64).astype(np.int32)
    a[:4] = [0, -1, -2**31, 2**31 - 1]
    b[:4] = [-1, 0, 0, -2**31]
    ref = np.asarray(jcensus.hamming_distance(jnp.asarray(a), jnp.asarray(b)))
    out = tcensus.hamming_distance(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    want = np.array([bin((int(x) ^ int(y)) & 0xFFFFFFFF).count("1")
                     for x, y in zip(a, b)])
    np.testing.assert_array_equal(out.numpy(), want)
