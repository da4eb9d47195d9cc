"""SIFT: the port against the JAX package on the same seeded numpy images
(64x96).  Keypoints are compared as sets (``torch.topk`` orders ties
unlike ``lax.top_k``) within 1e-3 px; descriptors within 1e-4 where the
orientation bin agrees (the port sums the histograms as one-hot products in
another order than the reference's scatter-add, so a near-tie may pick the
other bin).  The 2x upsampling of ``first_octave=-1`` is held against
``jax.image.resize`` at the borders too."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from scipy import ndimage as ndi

from boofcv_tpu.feature import extract as jex
from boofcv_tpu.feature import sift as js
from boofcv_tpu_torch.feature import extract as tex
from boofcv_tpu_torch.feature import sift as ts

torch.set_num_threads(1)
H, W = 64, 96


def _image(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(rng.normal(0, 1, (h, w)), 1.5)
    return np.round(120 + 50 * base / base.std()).astype(np.float32)


def _valid_set(kp, fields=("ys", "xs", "sigmas", "scores")):
    v = np.asarray(kp.valid).astype(bool)
    return np.stack([np.asarray(getattr(kp, f), np.float64)[v]
                     for f in fields], 1)


def _match(ref, out, tol):
    """Index into ``out`` of each row of ``ref`` (every row within ``tol``
    on positions, 1e-5 relative on sigma and score)."""
    assert len(ref) == len(out) > 0
    d = np.abs(ref[:, None, :2] - out[None, :, :2]).max(-1)
    j = d.argmin(1)
    assert d[np.arange(len(ref)), j].max() <= tol
    np.testing.assert_allclose(out[j, 2:], ref[:, 2:], rtol=1e-5)
    return j


def test_subpixel_quadratic():
    inten = np.random.default_rng(0).normal(0, 1, (20, 30)).astype(np.float32)
    det = jex.detect(jnp.asarray(inten), 12, radius=1, border=0)
    ref = jex.subpixel_quadratic(jnp.asarray(inten), det)
    tdet = tex.Detections(*(torch.from_numpy(np.asarray(a)) for a in det))
    out = tex.subpixel_quadratic(torch.from_numpy(inten), tdet)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


def test_gaussian_stack_and_upsample():
    img = _image(1)
    sj, sig_j = js.gaussian_scale_stack(jnp.asarray(img))
    st, sig_t = ts.gaussian_scale_stack(torch.from_numpy(img))
    np.testing.assert_array_equal(sig_t, sig_j)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-3)
    up_j = jax.image.resize(jnp.asarray(img), (2 * H, 2 * W), "linear")
    up_t = F.interpolate(torch.from_numpy(img)[None, None], size=(2 * H, 2 * W),
                         mode="bilinear", align_corners=False)[0, 0]
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up_j), atol=1e-4)
    for edge in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_allclose(up_t.numpy()[edge], np.asarray(up_j)[edge],
                                   atol=1e-4)


def test_detect_from_the_same_stack():
    """One stack (the reference's) into both detectors: the same keypoints
    as a set, to 1e-3 px."""
    stack, sigmas = js.gaussian_scale_stack(jnp.asarray(_image(2)))
    ref = js._detect_from_stack(stack, sigmas, 60, 1.0, 10.0, 8)
    out = ts._detect_from_stack(torch.from_numpy(np.asarray(stack)), sigmas,
                                60, 1.0, 10.0, 8)
    assert out.sigmas.dtype == torch.float64
    _match(_valid_set(ref), _valid_set(out), 1e-3)


@pytest.mark.parametrize("first_octave", [0, -1])
def test_detect_octaves(first_octave):
    img = _image(3)
    kw = dict(max_features=80, num_octaves=2, first_octave=first_octave)
    ref = js.detect(jnp.asarray(img), **kw)
    out = ts.detect(img, device="cpu", **kw)
    _match(_valid_set(ref), _valid_set(out), 1e-3)


def test_orientation_and_describe_on_the_same_keypoints():
    base = _image(4)
    stack, sigmas = js.gaussian_scale_stack(jnp.asarray(base))
    kp = js._detect_from_stack(stack, sigmas, 60, 1.0, 10.0, 8)
    args_j = (stack[0], kp.ys, kp.xs, kp.sigmas)
    args_t = tuple(torch.from_numpy(np.asarray(a)) for a in args_j)
    ang_j = np.asarray(js.orientation_histogram(*args_j))
    ang_t = ts.orientation_histogram(*args_t).numpy()
    agree = ang_j == ang_t
    assert agree.mean() >= 0.95
    dj = np.asarray(js.describe(*args_j, jnp.asarray(ang_j)))
    dt = ts.describe(*args_t, torch.from_numpy(ang_j)).numpy()
    np.testing.assert_allclose(dt, dj, atol=1e-4)
    v = np.asarray(kp.valid)
    np.testing.assert_allclose(np.linalg.norm(dt[v], axis=1), 1.0, atol=1e-5)


def test_detect_describe():
    img = _image(5)
    kpj, dj = js.detect_describe(jnp.asarray(img), max_features=60,
                                 num_octaves=2)
    kpt, dt = ts.detect_describe(torch.from_numpy(img), max_features=60,
                                 num_octaves=2)
    assert dt.shape == (120, 128)
    ref, out = _valid_set(kpj), _valid_set(kpt)
    j = _match(ref, out, 1e-3)
    vj = np.flatnonzero(np.asarray(kpj.valid))
    vt = np.flatnonzero(kpt.valid.numpy())
    a, b = np.asarray(dj)[vj], dt.numpy()[vt][j]
    same_bin = np.abs(a - b).max(1) <= 1e-4
    assert same_bin.mean() >= 0.9
    # the unit norm after the 0.2 clip holds for every valid slot
    np.testing.assert_allclose(np.linalg.norm(b, axis=1), 1.0, atol=1e-5)


def test_too_small_image_gives_dead_slots():
    kp, d = ts.detect_describe(torch.zeros(10, 12), max_features=7)
    assert kp.ys.shape == (7,) and not bool(kp.valid.any())
    assert d.shape == (7, 128)
