"""Canny: the port against the JAX package on the same seeded numpy inputs
(64x96 images).  ``discretize_direction4``, ``nonmax_direction4`` and
``hysteresis`` are bit-equal on identical inputs; end to end (blur and
Sobel in float32, summed in another order) at least 99.9 % of the pixels
agree; the chains of one mask are equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy import ndimage as ndi

from boofcv_tpu.feature import canny as jc
from boofcv_tpu_torch.feature import canny as tc

torch.set_num_threads(1)
H, W = 64, 96


def _image(seed, h=H, w=W, sigma=2.0):
    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(rng.normal(0, 1, (h, w)), sigma)
    return (120 + 60 * base / base.std()).astype(np.float32)


def _gradients(seed):
    rng = np.random.default_rng(seed)
    dx = rng.normal(0, 10, (H, W)).astype(np.float32)
    dy = rng.normal(0, 10, (H, W)).astype(np.float32)
    dx[0, :4] = [0.0, 1.0, -1.0, 0.0]                  # the axes and 0
    dy[0, :4] = [0.0, 0.0, 0.0, -1.0]
    return dx, dy


def test_discretize_and_nonmax_bit_equal():
    dx, dy = _gradients(0)
    ref_dir = np.asarray(jc.discretize_direction4(jnp.asarray(dx),
                                                  jnp.asarray(dy)))
    out_dir = tc.discretize_direction4(torch.from_numpy(dx),
                                       torch.from_numpy(dy))
    np.testing.assert_array_equal(out_dir.numpy(), ref_dir)
    inten = np.hypot(dx, dy).astype(np.float32)
    inten[10, 10:14] = inten[10, 10]                  # plateaus: ties
    ref = jc.nonmax_direction4(jnp.asarray(inten), jnp.asarray(ref_dir))
    out = tc.nonmax_direction4(torch.from_numpy(inten),
                               torch.from_numpy(ref_dir))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("low,high", [(2.0, 8.0), (0.5, 30.0)])
def test_hysteresis_bit_equal(low, high):
    """The same NMS image into both: the same mask, and the port's trip
    count reaches the fixpoint (a further trip changes nothing)."""
    gy, gx = (jnp.asarray(g) for g in np.gradient(_image(1)))
    nms = np.asarray(jc.nonmax_direction4(
        jnp.hypot(gx, gy), jc.discretize_direction4(gx, gy)))
    ref = np.asarray(jc.hysteresis(jnp.asarray(nms), low, high))
    assert 0 < ref.sum() < (nms > 0).sum()
    out, trips = tc._hysteresis(torch.from_numpy(nms), low, high)
    assert out.dtype == torch.uint8 and trips >= 1
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(tc.hysteresis(torch.from_numpy(nms), low,
                                                high).numpy(), ref)


@pytest.mark.parametrize("relative", [False, True])
def test_canny_end_to_end(relative):
    img = _image(2)
    low, high = (0.1, 0.3) if relative else (2.0, 8.0)
    ref = np.asarray(jc.canny(jnp.asarray(img), low, high, relative=relative))
    out = tc.canny(img, low, high, relative=relative, device="cpu")
    assert out.shape == ref.shape and out.dtype == torch.uint8
    assert 0.02 < ref.mean() < 0.5
    assert (out.numpy() == ref).mean() >= 0.999


def test_canny_featureless_frame_is_empty():
    img = np.full((H, W), 7.0, np.float32)
    out = tc.canny(torch.from_numpy(img), 0.1, 0.3, relative=True)
    assert int(out.sum()) == 0


def test_edge_contours_and_canny_contours():
    img = _image(3)
    mask = np.asarray(jc.canny(jnp.asarray(img), 2.0, 8.0))
    ref = jc.edge_contours(mask)
    out = tc.edge_contours(torch.from_numpy(mask))
    assert len(out) == len(ref) > 5
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)
    chains = tc.canny_contours(img, 2.0, 8.0, device="cpu")
    pts = np.concatenate(chains)
    assert len(pts) == int(tc.canny(img, 2.0, 8.0, device="cpu").sum())
    assert tc.edge_contours(np.zeros((4, 4))) == []
