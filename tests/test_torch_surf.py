"""SURF on the integral image (integral image, Fast Hessian, orientation,
SURF-64, BRIEF, NCC template, the gradient-patch orientations): the port
against the JAX package on the same numpy inputs, on the CPU.

Images are integer-valued and small enough that every prefix sum of the
integral image stays below 2^24 (96 x 128 x 255 = 3.1e6), so the integral
image and every box sum are exact in float32 and compared bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.feature import describe as jdesc
from boofcv_tpu.feature import fasthessian as jfh
from boofcv_tpu.feature import orientation as jori
from boofcv_tpu.ip import integral as jii
from boofcv_tpu_torch.feature import describe as tdesc
from boofcv_tpu_torch.feature import fasthessian as tfh
from boofcv_tpu_torch.feature import orientation as tori
from boofcv_tpu_torch.ip import integral as tii

torch.set_num_threads(1)
H, W = 96, 128


def _image(seed, h=H, w=W):
    """Integer-valued blobs and texture: Hessian peaks at several scales."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 90 + 25 * rng.normal(0, 1, (h, w))
    for _ in range(25):
        cy, cx = rng.uniform(8, h - 8), rng.uniform(8, w - 8)
        s = rng.uniform(1.5, 6.0)
        img += rng.choice([-1, 1]) * 90 * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return np.round(np.clip(img, 0, 255)).astype(np.float32)


def _ii(seed):
    img = _image(seed)
    ref = jii.transform(jnp.asarray(img))
    return img, ref, torch.from_numpy(np.array(ref))


def _angle_diff(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b)) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def test_integral_transform_exact():
    img = _image(0)
    ref = np.asarray(jii.transform(jnp.asarray(img)))
    out = tii.transform(torch.from_numpy(img))
    assert float(ref.max()) < 2 ** 24 and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    u8 = img.astype(np.uint8)           # an integer image sums in float32
    np.testing.assert_array_equal(tii.transform(torch.from_numpy(u8)).numpy(),
                                  ref)


def test_block_sum_exact():
    """Rectangles that reach above, left of, below and right of the image
    (zeros above and left, clamped below and right)."""
    _, jref, tref = _ii(1)
    rng = np.random.default_rng(1)
    x0 = rng.integers(-6, W + 3, 400).astype(np.int32)
    y0 = rng.integers(-6, H + 3, 400).astype(np.int32)
    x1 = x0 + rng.integers(0, 30, 400).astype(np.int32)
    y1 = y0 + rng.integers(0, 30, 400).astype(np.int32)
    ref = jii.block_sum(jref, *(jnp.asarray(a) for a in (x0, y0, x1, y1)))
    out = tii.block_sum(tref, *(torch.from_numpy(a) for a in (x0, y0, x1,
                                                               y1)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # scalar corners
    assert float(tii.block_sum(tref, 2, 3, 10, 12)) == float(
        jii.block_sum(jref, 2, 3, 10, 12))


@pytest.mark.parametrize("box", [(-4, -2, 4, 2), (1, 1, 9, 9), (-13, -13, -1,
                                                               -1),
                                 (0, -50, 3, 50), (-130, -100, 130, 100)])
def test_block_sum_grid_exact(box):
    _, jref, tref = _ii(2)
    ref = jii.block_sum_grid(jref, *box)
    out = tii.block_sum_grid(tref, *box)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ["deriv_xx", "deriv_yy", "deriv_xy"])
@pytest.mark.parametrize("size", [9, 15, 27])
def test_box_derivatives_exact(name, size):
    """The whole-image form against the reference's, and the per-point form
    at every pixel against the whole-image form (integer sums: exact)."""
    _, jref, tref = _ii(3)
    ref = np.asarray(getattr(jii, name + "_grid")(jref, size))
    grid = getattr(tii, name + "_grid")(tref, size)
    np.testing.assert_array_equal(grid.numpy(), ref)
    ys, xs = np.mgrid[0:H, 0:W]
    pts = getattr(tii, name)(tref, torch.from_numpy(ys), torch.from_numpy(xs),
                             size)
    np.testing.assert_array_equal(pts.numpy(), ref)
    jpts = getattr(jii, name)(jref, jnp.asarray(ys[::7, ::5]),
                              jnp.asarray(xs[::7, ::5]), size)
    np.testing.assert_array_equal(pts.numpy()[::7, ::5], np.asarray(jpts))


@pytest.mark.parametrize("name", ["haar_x", "haar_y"])
def test_haar_exact(name):
    _, jref, tref = _ii(4)
    rng = np.random.default_rng(4)
    cy = rng.integers(-3, H + 3, 300).astype(np.int32)
    cx = rng.integers(-3, W + 3, 300).astype(np.int32)
    r = rng.integers(1, 9, 300).astype(np.int32)
    ref = getattr(jii, name)(jref, *(jnp.asarray(a) for a in (cy, cx, r)))
    out = getattr(tii, name)(tref, *(torch.from_numpy(a) for a in (cy, cx,
                                                                   r)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("size", [9, 21, 39])
def test_hessian_response(size):
    """Within 1e-5 of the largest finite entry; the -inf rim at the same
    pixels."""
    _, jref, tref = _ii(5)
    ref = np.asarray(jfh.hessian_response(jref, size))
    out = tfh.hessian_response(tref, size).numpy()
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(out), fin) and fin.any()
    assert np.all(out[~fin] == -np.inf)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=0,
                               atol=1e-5 * float(np.abs(ref[fin]).max()))


def _as_set(det):
    v = np.asarray(det.valid)
    rows = np.stack([np.asarray(a)[v] for a in (det.ys, det.xs, det.scales,
                                                det.scores)], 1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("kw", [dict(max_features=60),
                                dict(max_features=400),
                                dict(max_features=80, sizes=(15, 27, 39, 51),
                                     threshold=1.0)])
def test_detect_as_sets(kw):
    """Detections as sets (``topk`` orders ties its own way): the same
    count, and position, scale and score of each to 1e-4 relative.  With
    400 slots most are empty: -inf scores, valid False, zeros."""
    _, jref, tref = _ii(6)
    ref = jfh.detect(jref, **kw)
    out = tfh.detect(tref, **kw)
    for a in out:
        assert a.shape == (kw["max_features"],)
    a, b = _as_set(ref), _as_set(tfh.ScaleDetections(*(t.numpy()
                                                       for t in out)))
    assert a.shape == b.shape and a.shape[0] >= 10
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    inv = ~out.valid.numpy()
    for t in (out.ys, out.xs, out.scales, out.scores):
        assert np.all(t.numpy()[inv] == 0.0)
    if kw["max_features"] == 400:
        assert inv.any()


def test_detect_multi_octave_as_sets():
    _, jref, tref = _ii(7)
    ref = jfh.detect_multi_octave(jref, 50, 2)
    out = tfh.detect_multi_octave(tref, 50, 2)
    assert out.ys.shape == (100,)
    a, b = _as_set(ref), _as_set(tfh.ScaleDetections(*(t.numpy()
                                                       for t in out)))
    assert a.shape == b.shape and a.shape[0] >= 20
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def _keypoints(seed, n=150):
    """Subpixel keypoints with their scales, some at the border, taken
    where the image has gradient."""
    rng = np.random.default_rng(seed)
    ys = rng.uniform(0, H - 1, n).astype(np.float32)
    xs = rng.uniform(0, W - 1, n).astype(np.float32)
    scales = rng.uniform(1.2, 4.0, n).astype(np.float32)
    return ys, xs, scales


def test_orientation_average_haar():
    """Angles to 1e-5 modulo 2 pi, where the summed response is not near
    zero (there the angle is ill-conditioned)."""
    _, jref, tref = _ii(8)
    ys, xs, sc = _keypoints(8)
    ref = np.asarray(jdesc.orientation_average_haar(
        jref, *(jnp.asarray(a) for a in (ys, xs, sc))))
    out = tdesc.orientation_average_haar(
        tref, *(torch.from_numpy(a) for a in (ys, xs, sc)))
    assert out.shape == (150,) and out.dtype == torch.float32
    assert float(_angle_diff(ref, out.numpy()).max()) <= 1e-5


@pytest.mark.parametrize("upright", [True, False])
def test_surf_descriptor(upright):
    """1e-5 on unit-norm descriptors (the cell sums add in another
    order)."""
    _, jref, tref = _ii(9)
    ys, xs, sc = _keypoints(9)
    ang = None if upright else np.random.default_rng(9).uniform(
        -np.pi, np.pi, 150).astype(np.float32)
    ref = np.asarray(jdesc.surf(
        jref, *(jnp.asarray(a) for a in (ys, xs, sc)),
        None if upright else jnp.asarray(ang)))
    out = tdesc.surf(tref, *(torch.from_numpy(a) for a in (ys, xs, sc)),
                     None if upright else torch.from_numpy(ang))
    assert out.shape == (150, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=1), 1.0,
                               atol=1e-5)


def test_surf_pipeline_on_detections():
    """transform -> detect_multi_octave -> orientation -> surf, each
    package on its own detections, matched up as sets."""
    img = _image(10)
    jref = jii.transform(jnp.asarray(img))
    tref = tii.transform(torch.from_numpy(img))
    jdet = jfh.detect_multi_octave(jref, 40, 2)
    tdet = tfh.detect_multi_octave(tref, 40, 2)
    jang = jdesc.orientation_average_haar(jref, jdet.ys, jdet.xs, jdet.scales)
    tang = tdesc.orientation_average_haar(tref, tdet.ys, tdet.xs, tdet.scales)
    jd_ = np.asarray(jdesc.surf(jref, jdet.ys, jdet.xs, jdet.scales, jang))
    td_ = tdesc.surf(tref, tdet.ys, tdet.xs, tdet.scales, tang).numpy()
    key = lambda det: np.stack([np.asarray(det.ys), np.asarray(det.xs),
                                np.asarray(det.scales)], 1)
    jv, tv = np.asarray(jdet.valid), tdet.valid.numpy()
    jk, tk = key(jdet)[jv], key(tdet)[tv]
    assert jk.shape == tk.shape and len(jk) >= 20
    # pair each of the port's features with the reference's nearest one
    nearest = np.argmin(((tk[:, None] - jk[None]) ** 2).sum(-1), axis=1)
    assert len(set(nearest.tolist())) == len(tk)
    np.testing.assert_allclose(tk, jk[nearest], atol=1e-3)
    np.testing.assert_allclose(td_[tv], jd_[jv][nearest], atol=1e-4)


def test_brief_definition_and_words():
    """Packed BRIEF words are exact, bit 31 included: a ramp image makes
    every comparison with ax < bx true, so words of all ones appear."""
    jdef = jdesc.brief_definition(num_bits=64, radius=6, seed=3)
    tdef = tdesc.brief_definition(num_bits=64, radius=6, seed=3, device="cpu")
    for a, b in zip(jdef, tdef):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tdesc.brief_definition()            # device=None is the card
    img = _image(11)
    rng = np.random.default_rng(11)
    ys = rng.uniform(-2, H + 1, 200).astype(np.float32)
    xs = rng.uniform(-2, W + 1, 200).astype(np.float32)
    ref = np.asarray(jdesc.brief(jnp.asarray(img), jnp.asarray(ys),
                                 jnp.asarray(xs), jdef))
    out = tdesc.brief(torch.from_numpy(img), torch.from_numpy(ys),
                      torch.from_numpy(xs), tdef)
    assert out.dtype == torch.int32 and out.shape == (200, 2)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref < 0).any()                      # bit 31 is in play

    ramp = np.tile(np.arange(W, dtype=np.float32), (H, 1))
    one = np.zeros(32, np.float32)
    left, right = one - 2.0, one + 2.0
    allones = tdesc.BriefDefinition(*(torch.from_numpy(a) for a in (
        one, left, one, right)))
    jallones = jdesc.BriefDefinition(*(jnp.asarray(a) for a in (
        one, left, one, right)))
    c = np.array([40.0], np.float32)
    for (td_, jd_), want in (((allones, jallones), -1),
                             ((allones._replace(ax=allones.bx, bx=allones.ax),
                               jallones._replace(ax=jallones.bx,
                                                 bx=jallones.ax)), 0)):
        got = tdesc.brief(torch.from_numpy(ramp), torch.from_numpy(c),
                          torch.from_numpy(c), td_)
        assert int(got[0, 0]) == want
        assert int(np.asarray(jdesc.brief(jnp.asarray(ramp), jnp.asarray(c),
                                          jnp.asarray(c), jd_))[0, 0]) == want


def test_ncc_template():
    img = _image(12)
    rng = np.random.default_rng(12)
    ys = rng.uniform(6, H - 7, 100).astype(np.float32)
    xs = rng.uniform(6, W - 7, 100).astype(np.float32)
    ref = np.asarray(jdesc.ncc_template(jnp.asarray(img), jnp.asarray(ys),
                                        jnp.asarray(xs), 4))
    out = tdesc.ncc_template(torch.from_numpy(img), torch.from_numpy(ys),
                             torch.from_numpy(xs), 4)
    assert out.shape == (100, 81)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,kw", [
    ("average", {}), ("average", {"weighted": False}),
    ("histogram", {}), ("histogram", {"num_bins": 12}),
    ("sliding_window", {})])
def test_gradient_patch_orientations(name, kw):
    """Angles to 1e-5 modulo 2 pi for the two averaging estimators (their
    float32 sums add in another order); the histogram's winning bin
    exactly."""
    img = _image(13)
    rng = np.random.default_rng(13)
    ys = rng.uniform(8, H - 9, 120).astype(np.float32)
    xs = rng.uniform(8, W - 9, 120).astype(np.float32)
    ref = np.asarray(getattr(jori, name)(jnp.asarray(img), jnp.asarray(ys),
                                         jnp.asarray(xs), **kw))
    out = getattr(tori, name)(torch.from_numpy(img), torch.from_numpy(ys),
                              torch.from_numpy(xs), **kw)
    assert out.shape == (120,) and out.dtype == torch.float32
    tol = 1e-6 if name == "histogram" else 1e-5
    assert float(_angle_diff(ref, out.numpy()).max()) <= tol
