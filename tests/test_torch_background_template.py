"""Background models (static and moving camera) and template matching:
the port against the JAX package on the same seeded numpy inputs, on the
CPU.

Tolerances: the static models, the moving models' updates and segments
(float64 projections through the same homography, float32 bilinear
samples) and SAD are exact; SSD and NCC (``F.conv2d`` against XLA's
convolution, float32 sums in another order) agree to 1e-5 relative of
the score map's range; the peaks they find are equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.feature import background as jbg
from boofcv_tpu.feature import template as jtpl
from boofcv_tpu_torch.feature import background as tbg
from boofcv_tpu_torch.feature import template as ttpl

torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _frames(seed, n, h=30, w=40, noise=2.0):
    rng = np.random.default_rng(seed)
    bg = rng.uniform(0, 255, (h, w)).astype(np.float32)
    frames = [bg + rng.normal(0, noise, bg.shape).astype(np.float32)
              for _ in range(n)]
    last = bg.copy()
    last[5:15, 10:20] += 100
    return frames, last


# ------------------------------------------------------------ static models

def test_basic_and_gaussian_models_equal_jax():
    frames, last = _frames(4, 10)
    tm, jm = tbg.basic_init(_t(frames[0])), jbg.basic_init(
        jnp.asarray(frames[0]))
    tg, jg = tbg.gaussian_init(_t(frames[0])), jbg.gaussian_init(
        jnp.asarray(frames[0]))
    for f in frames[1:]:
        tm = tbg.basic_update(tm, _t(f))
        jm = jbg.basic_update(jm, jnp.asarray(f))
        tg = tbg.gaussian_update(tg, _t(f))
        jg = jbg.gaussian_update(jg, jnp.asarray(f))
    np.testing.assert_array_equal(_np(tm), _np(jm))
    np.testing.assert_array_equal(_np(tg.mean), _np(jg.mean))
    np.testing.assert_array_equal(_np(tg.var), _np(jg.var))
    seg_b = tbg.basic_segment(tm, _t(last))
    seg_g = tbg.gaussian_segment(tg, _t(last))
    np.testing.assert_array_equal(_np(seg_b), _np(jbg.basic_segment(
        jm, jnp.asarray(last))))
    np.testing.assert_array_equal(_np(seg_g), _np(jbg.gaussian_segment(
        jg, jnp.asarray(last))))
    assert seg_b.dtype == torch.uint8 and float(seg_b[5:15, 10:20].float()
                                                 .mean()) > 0.95


def test_gmm_model_equals_jax():
    frames, last = _frames(5, 25)
    # a second mode in a patch, so components get replaced and compete
    for f in frames[10:14]:
        f[20:26, 2:9] = 30.0
    tm = tbg.gmm_init(_t(frames[0]))
    jm = jbg.gmm_init(jnp.asarray(frames[0]))
    for f in frames[1:]:
        tm = tbg.gmm_update(tm, _t(f))
        jm = jbg.gmm_update(jm, jnp.asarray(f))
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(_np(a), _np(b))
    seg = tbg.gmm_segment(tm, _t(last))
    np.testing.assert_array_equal(_np(seg), _np(jbg.gmm_segment(
        jm, jnp.asarray(last))))
    assert float(seg[5:15, 10:20].float().mean()) > 0.9


def test_gmm_ties_take_the_first_component():
    img = np.full((2, 3), 10.0, np.float32)
    m = tbg.GmmModel(_t(np.full((3, 2, 3), 10.0, np.float32)),
                     _t(np.full((3, 2, 3), 4.0, np.float32)),
                     _t(np.full((3, 2, 3), 1 / 3, np.float32)))
    jm = jbg.GmmModel(*[jnp.asarray(_np(a)) for a in m])
    got = tbg.gmm_update(m, _t(img))
    want = jbg.gmm_update(jm, jnp.asarray(img))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))
    # every component matched equally: only the first one learned
    assert float(got.weights[0, 0, 0]) > float(got.weights[1, 0, 0])


# ------------------------------------------------------------ moving models

def _translation(dx, dy):
    return np.array([[1.0, 0.0, dx], [0.0, 1.0, dy], [0.0, 0.0, 1.0]])


def _pan(world, k):
    dx = 5 + (k % 4)
    return world[3:51, dx:dx + 64], _translation(-(dx - 5) + 0.25, 0.5)


@pytest.mark.parametrize("h_dtype", [np.float64, np.float32])
def test_moving_models_equal_jax(h_dtype):
    rng = np.random.default_rng(8)
    world = rng.uniform(0, 255, size=(80, 120)).astype(np.float32)
    tb, jb = tbg.moving_init((48, 64), device="cpu"), jbg.moving_init(
        (48, 64))
    tg = tbg.moving_gaussian_init((48, 64), device="cpu")
    jg = jbg.moving_gaussian_init((48, 64))
    tm = tbg.moving_gmm_init((48, 64), device="cpu")
    jm = jbg.moving_gmm_init((48, 64))
    for k in range(8):
        frame, H = _pan(world, k)
        H = H.astype(h_dtype)
        tb = tbg.moving_basic_update(tb, _t(frame), _t(H))
        jb = jbg.moving_basic_update(jb, jnp.asarray(frame), jnp.asarray(H))
        tg = tbg.moving_gaussian_update(tg, _t(frame), _t(H))
        jg = jbg.moving_gaussian_update(jg, jnp.asarray(frame),
                                        jnp.asarray(H))
        tm = tbg.moving_gmm_update(tm, _t(frame), _t(H))
        jm = jbg.moving_gmm_update(jm, jnp.asarray(frame), jnp.asarray(H))
    np.testing.assert_array_equal(_np(tb), _np(jb))
    for a, b in zip(list(tg) + list(tm), list(jg) + list(jm)):
        np.testing.assert_array_equal(_np(a), _np(b))
    frame, H = _pan(world, 2)
    frame = frame.copy()
    frame[20:28, 30:38] = 255.0
    H = H.astype(h_dtype)
    for tf, jf, tmod, jmod in (
            (tbg.moving_basic_segment, jbg.moving_basic_segment, tb, jb),
            (tbg.moving_gaussian_segment, jbg.moving_gaussian_segment, tg,
             jg),
            (tbg.moving_gmm_segment, jbg.moving_gmm_segment, tm, jm)):
        seg = tf(tmod, _t(frame), _t(H))
        np.testing.assert_array_equal(_np(seg), _np(jf(
            jmod, jnp.asarray(frame), jnp.asarray(H))))
        assert int(seg[24, 34]) == 1
    far = world[3:51, 56:120]
    seg = tbg.moving_basic_segment(tb, _t(far), _t(_translation(-51.0, 0.0)))
    assert (_np(seg)[:, -10:] == tbg.UNKNOWN).mean() > 0.9


def test_moving_models_take_numpy_frames_on_the_models_device():
    model = tbg.moving_init((6, 7), device="cpu")
    frame = np.arange(42, dtype=np.float32).reshape(6, 7)
    out = tbg.moving_basic_update(model, frame, _translation(0.0, 0.0))
    assert out.device.type == "cpu"
    np.testing.assert_array_equal(_np(out), frame)


# --------------------------------------------------------- template matching

def _scene(seed=3, h=60, w=80, th=9, tw=11, ty=23, tx=41):
    img = np.round(np.random.default_rng(seed).uniform(0, 255, (h, w)))
    img = img.astype(np.float32)
    return img, img[ty:ty + th, tx:tx + tw].copy(), (ty, tx)


@pytest.mark.parametrize("name", ["match_ssd", "match_sad", "match_ncc"])
def test_template_scores_match_jax_and_find_the_template(name):
    img, tmpl, where = _scene()
    got = getattr(ttpl, name)(_t(img), _t(tmpl))
    want = _np(getattr(jtpl, name)(jnp.asarray(img), jnp.asarray(tmpl)))
    assert got.shape == want.shape
    if name == "match_sad":
        np.testing.assert_array_equal(_np(got), want)
    else:
        span = float(want.max() - want.min())
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5 * span)
    det = ttpl.find_matches(got, max_matches=1, radius=3)
    jdet = jtpl.find_matches(jnp.asarray(want), max_matches=1, radius=3)
    assert (int(det.ys[0]), int(det.xs[0])) == where == (
        int(jdet.ys[0]), int(jdet.xs[0]))


def test_find_matches_sets_equal_jax():
    img, tmpl, _ = _scene(4)
    score = ttpl.match_ncc(_t(img), _t(tmpl))
    det = ttpl.find_matches(score, max_matches=6, radius=2)
    jdet = jtpl.find_matches(jnp.asarray(_np(score)), max_matches=6,
                             radius=2)
    got = {(int(y), int(x)) for y, x, v in zip(det.ys, det.xs, det.valid)
           if v}
    want = {(int(y), int(x)) for y, x, v in zip(_np(jdet.ys), _np(jdet.xs),
                                                _np(jdet.valid)) if v}
    assert got == want


def test_correlate_conv_equals_shifted_adds_on_integers():
    img, tmpl, _ = _scene(5, th=5, tw=7)
    a = ttpl._valid_correlate(_t(img), _t(tmpl))
    b = ttpl._valid_correlate_shifted(_t(img), _t(tmpl))
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["background_moving_camera",
                                  "template_matching"])
def test_example_passes_on_the_cpu(name):
    import importlib
    mod = importlib.import_module(f"boofcv_tpu_torch.examples.{name}")
    assert mod.main(["--device", "cpu"]) == 0
