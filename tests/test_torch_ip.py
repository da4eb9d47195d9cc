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
