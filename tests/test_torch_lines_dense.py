"""Hough lines (polar, gradient, foot of norm), grid-RANSAC segments with
their connection and pruning, HOG and dense SIFT: the port against the
JAX package on the same seeded numpy inputs, on the CPU.

Tolerances: Hough accumulators are sums of 0/1 votes, exact in any order,
so the lines found are equal as sets (``torch.topk`` orders tied peaks
otherwise than ``lax.top_k``); the grid-RANSAC edgels are exact (a stable
descending sort keeps ``lax.top_k``'s order on ties) and, with the
reference's own hypothesis pairs injected, the inlier counts and masks
are exact and the refitted ends (float32 sums over 48 edgels in another
order) agree to 1e-3 px; the foot-of-norm distances (XLA fuses
dx*dx + dy*dy into one multiply-add) to 1e-6 relative; the host finishers
are exact; HOG (float64
votes) to 1e-6; dense SIFT to 1e-4 as the SIFT descriptor's own parity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from boofcv_tpu.feature import dense as jdense
from boofcv_tpu.feature import lines as jlines
from boofcv_tpu_torch.feature import dense as tdense
from boofcv_tpu_torch.feature import lines as tlines

torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _found(res, fields=("rho", "theta", "score")):
    v = _np(res.valid)
    cols = [np.round(_np(getattr(res, f)).astype(np.float64), 4)[v]
            for f in fields]
    return sorted(zip(*[c.tolist() for c in cols]))


def _edges():
    img = np.zeros((80, 100), np.uint8)
    img[20, :] = 1
    img[:, 60] = 1
    yy, xx = np.mgrid[0:80, 0:100]
    img[np.abs(yy - 0.5 * xx - 10) < 0.5] = 1
    return img


def test_thetas_are_jnp_linspace():
    for n in (7, 180, 181):
        np.testing.assert_array_equal(
            _np(tlines._thetas(n, "cpu")),
            _np(jnp.linspace(0.0, np.pi, n, endpoint=False)))


def test_hough_binary_equals_jax(monkeypatch):
    img = _edges()
    want = _found(jlines.hough_binary(img, max_lines=4))
    assert _found(tlines.hough_binary(_t(img), max_lines=4)) == want
    monkeypatch.setattr(tlines, "HOUGH_CHUNK", 1000)     # many blocks
    res = tlines.hough_binary(_t(img), max_lines=4)
    assert _found(res) == want
    assert res.theta.dtype == torch.float64


def test_hough_gradient_equals_jax():
    img = np.zeros((60, 80), np.float32)
    img[:, 40:] = 200.0
    img[35:, :] += 90.0
    for kw in ({"max_lines": 3, "edge_threshold": 50.0}, {}):
        assert _found(tlines.hough_gradient(_t(img), **kw)) == _found(
            jlines.hough_gradient(img, **kw))


def test_hough_foot_equals_jax():
    img = np.zeros((96, 96), np.float32)
    img[:, 60:] = 200.0
    yy, xx = np.mgrid[0:96, 0:96]
    img[yy > xx + 30] += 100.0
    got = tlines.hough_foot(_t(img), max_lines=4)
    want = jlines.hough_foot(jnp.asarray(img), max_lines=4)
    assert _found(got, ("fx", "fy", "score")) == _found(
        want, ("fx", "fy", "score"))
    # XLA contracts dx*dx + dy*dy into a fused multiply-add
    rho, theta = tlines.foot_to_polar(got, (96, 96))
    jrho, jtheta = jlines.foot_to_polar(want, (96, 96))
    np.testing.assert_allclose(np.sort(_np(rho)), np.sort(_np(jrho)),
                               rtol=1e-6)


def _reference_pairs(img, region_size=32, hypotheses=64, k=48, seed=0):
    """The reference's hypothesis draw for ``grid_ransac_lines(key=)``."""
    nreg = (img.shape[0] // region_size) * (img.shape[1] // region_size)
    key = jax.random.PRNGKey(seed)
    return np.array(jax.random.randint(key, (nreg, hypotheses, 2), 0, k))


def _rectangle():
    img = np.zeros((96, 128), np.float32)
    img[24:72, 32:96] = 200.0
    return img


def _bars():
    h, w = 128, 192
    img = np.zeros((h, w), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    img[(np.abs(yy - 40) <= 1) & (xx >= 10) & (xx <= 180)] = 200.0
    d = np.abs((yy - 90) - 0.4 * (xx - 20))
    img[(d <= 1.2) & (xx >= 20) & (xx <= 170)] = 200.0
    return img


@pytest.mark.parametrize("scene,kw", [
    (_rectangle, {"edge_threshold": 50.0, "min_inliers": 8}),
    (_bars, {"edge_threshold": 30.0})])
def test_grid_ransac_lines_with_injected_pairs_equal_jax(scene, kw):
    img = scene()
    want = jlines.grid_ransac_lines(jnp.asarray(img), **kw)
    got = tlines.grid_ransac_lines(_t(img), pair_idx=_reference_pairs(img),
                                   **kw)
    np.testing.assert_array_equal(_np(got.valid), _np(want.valid))
    np.testing.assert_array_equal(_np(got.inliers), _np(want.inliers))
    v = _np(want.valid)
    assert v.sum() >= 4
    for f in ("x0", "y0", "x1", "y1"):
        np.testing.assert_allclose(_np(getattr(got, f))[v],
                                   _np(getattr(want, f))[v], atol=1e-3)
    # connecting the fragments: the host finisher gives the reference's
    # segments on the reference's fragments, and the same count on ours
    merged = tlines.connect_segments(want, dist_tol=3.0)
    jmerged = jlines.connect_segments(want, dist_tol=3.0)
    for a, b in zip(merged, jmerged):
        np.testing.assert_array_equal(a, b)
    assert len(tlines.connect_segments(got, dist_tol=3.0).x0) == len(
        jmerged.x0)


def test_stable_descending_sort_is_lax_top_k_on_ties():
    score = np.array([[3.0, 5.0, 5.0, -1.0, 5.0, 3.0, 0.0, 3.0]],
                     np.float32)
    top, idx = lax.top_k(jnp.asarray(score), 5)
    order = torch.sort(_t(score), dim=1, descending=True, stable=True)
    np.testing.assert_array_equal(order.indices[:, :5].numpy(),
                                  np.asarray(idx))
    np.testing.assert_array_equal(order.values[:, :5].numpy(),
                                  np.asarray(top))


def test_grid_ransac_lines_draws_from_a_generator():
    img = _rectangle()
    g = lambda: torch.Generator().manual_seed(3)
    a = tlines.grid_ransac_lines(_t(img), edge_threshold=50.0, generator=g())
    b = tlines.grid_ransac_lines(_t(img), edge_threshold=50.0, generator=g())
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a.valid.sum()) >= 4
    empty = tlines.grid_ransac_lines(_t(np.full((64, 64), 100.0,
                                                np.float32)))
    assert not bool(empty.valid.any())


def test_prune_merge_similar_equals_jax():
    rho = np.array([50.0, 52.0, -30.0, -49.0, 0.0])
    theta = np.array([0.03, 0.05, 1.8, np.pi - 0.01, 0.0])
    score = np.array([100.0, 60.0, 80.0, 40.0, 0.0], np.float32)
    valid = np.array([True, True, True, True, False])
    for merge in (True, False):
        got = tlines.prune_merge_similar(
            tlines.HoughLines(_t(rho), _t(theta), _t(score), _t(valid)),
            merge=merge)
        want = jlines.prune_merge_similar(jlines.HoughLines(
            jnp.asarray(rho), jnp.asarray(theta), jnp.asarray(score),
            jnp.asarray(valid)), merge=merge)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(tlines.line_pixels(10.5, 0.0, (20, 30)),
                                  jlines.line_pixels(10.5, 0.0, (20, 30)))


# ------------------------------------------------------------------ dense

@pytest.mark.parametrize("signed", [False, True])
def test_hog_matches_jax(signed):
    img = np.round(np.random.default_rng(2).uniform(0, 255, (48, 64)))
    img = img.astype(np.float32)
    img[:, 32:] += 60.0
    got = tdense.hog(_t(img), signed=signed)
    want = _np(jdense.hog(img, signed=signed))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(_np(got), want, atol=1e-6)


def test_hog_edge_response_and_border_wrap():
    img = np.zeros((64, 64), np.float32)
    img[:, 32:] = 200
    blocks = _np(tdense.hog(_t(img)))
    assert blocks.shape == (7, 7, 36)
    assert blocks[3, 3].reshape(4, 9).sum(0).argmax() in (0, 8)
    # the gradient wraps round the border (the reference's jnp.roll): the
    # left column sees the right one
    assert blocks[3, 0].sum() > 0


def test_dense_sift_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (64, 80)).astype(np.float32)
    ys, xs, desc = tdense.dense_sift(_t(img), cell=8, step=16)
    jys, jxs, jdesc = jdense.dense_sift(img, cell=8, step=16)
    np.testing.assert_array_equal(_np(ys), _np(jys))
    np.testing.assert_array_equal(_np(xs), _np(jxs))
    assert desc.shape == (len(_np(jys)), 128)
    np.testing.assert_allclose(_np(desc), _np(jdesc), atol=1e-4)


def test_line_segments_example_passes_on_the_cpu():
    from boofcv_tpu_torch.examples import line_segments_ransac
    assert line_segments_ransac.main(["--device", "cpu"]) == 0
