"""Corners, nonmax, detection and sparse stereo: the port against the JAX
package on the same integer-valued (camera-like) images."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.feature import disparity as jdisp
from boofcv_tpu.feature import extract as jextract
from boofcv_tpu.feature import intensity as jint
from boofcv_tpu.io import simulate as jsim
from boofcv_tpu_torch.feature import disparity as tdisp
from boofcv_tpu_torch.feature import extract as textract
from boofcv_tpu_torch.feature import intensity as tint

torch.set_num_threads(1)

H, W = 120, 160
K = np.array([[150.0, 0.0, W / 2], [0.0, 150.0, H / 2], [0.0, 0.0, 1.0]])


@pytest.fixture(scope="module")
def stereo_pair():
    """A rendered stereo pair, rounded to integers like a camera's."""
    rng = np.random.default_rng(0)
    poses = [(np.eye(3), np.zeros(3))]
    (left, right), = jsim.render_stereo_sequence(rng, K, 0.3, poses, H, W)
    return (np.round(np.asarray(left)).astype(np.float32),
            np.round(np.asarray(right)).astype(np.float32))


def test_shi_tomasi(stereo_pair):
    """rtol 1e-5 of the response's peak (box sums reach ~1e7, beyond
    float32's exact integers, and the two packages sum in other orders)."""
    left, _ = stereo_pair
    ref = np.asarray(jint.shi_tomasi(jnp.asarray(left), radius=2))
    out = tint.shi_tomasi(torch.from_numpy(left), radius=2).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("radius,border", [(2, 0), (4, 14), (5, 26)])
def test_nonmax_mask(stereo_pair, radius, border):
    """Same intensity in, same mask out (the raster tie ramp copied)."""
    left, _ = stereo_pair
    inten = np.array(jint.shi_tomasi(jnp.asarray(left), radius=2))
    inten[40:44, 50:54] = inten.max() * 1.5              # a plateau
    ref = np.asarray(jextract.nonmax_mask(jnp.asarray(inten), radius, 1.0,
                                          border))
    out = textract.nonmax_mask(torch.from_numpy(inten), radius, 1.0,
                               border).numpy()
    assert np.array_equal(ref, out)
    assert out[40:44, 50:54].sum() == 1                  # raster-first wins


def test_detect_as_sets(stereo_pair):
    """>= 99% of the detections shared; every miss is a near-tie (1e-5
    relative) at the top-k cut or inside a nonmax window."""
    left, _ = stereo_pair
    ij = jint.shi_tomasi(jnp.asarray(left), radius=2)
    inten = np.asarray(ij)
    dj = jextract.detect(ij, 128, radius=4, threshold=1.0, border=14)
    dt = textract.detect(tint.shi_tomasi(torch.from_numpy(left), radius=2),
                         128, radius=4, threshold=1.0, border=14)
    sj = {(int(y), int(x)) for y, x, v in zip(np.asarray(dj.ys),
                                              np.asarray(dj.xs),
                                              np.asarray(dj.valid)) if v}
    st = {(int(y), int(x)) for y, x, v in zip(dt.ys.numpy(), dt.xs.numpy(),
                                              dt.valid.numpy()) if v}
    assert len(st & sj) >= 0.99 * max(len(sj), len(st))
    kth = np.asarray(dj.scores)[np.asarray(dj.valid)].min()
    for y, x in st ^ sj:
        v = inten[y, x]
        at_cut = abs(v - kth) <= 1e-5 * abs(kth)
        win = inten[max(y - 4, 0):y + 5, max(x - 4, 0):x + 5]
        in_window = (np.abs(win - v) <= 1e-5 * abs(v)).sum() > 1
        assert at_cut or in_window, (y, x, v, kth)


@pytest.mark.parametrize("error", ["sad", "sad_xla"])
@pytest.mark.parametrize("max_d,rx", [(48, 3), (32, 2)])
def test_sparse_block_match(stereo_pair, error, max_d, rx):
    """The port's one SAD against both reference SAD paths, with the VO
    spawn's texture threshold: disparity atol 1e-4, ``valid`` equal."""
    left, right = stereo_pair
    rng = np.random.default_rng(max_d)
    ys = rng.integers(0, H, 160).astype(np.int32)
    xs = rng.integers(0, W, 160).astype(np.int32)
    ys[:4] = [0, 1, H - 1, H - 2]                        # rows past the image
    xs[:4] = [0, 3, W - 1, 60]
    kw = dict(min_disparity=0, max_disparity=max_d, radius_x=rx,
              radius_y=rx, texture_threshold=0.1)
    dj, vj = jdisp.sparse_block_match(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(ys),
        jnp.asarray(xs), jdisp.DisparityConfig(error=error, **kw))
    dt, vt = tdisp.sparse_block_match(
        torch.from_numpy(left), torch.from_numpy(right),
        torch.from_numpy(ys), torch.from_numpy(xs),
        tdisp.DisparityConfig(**kw))
    assert np.array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-4, rtol=0)
    assert vt.numpy().sum() > 40
