"""The port's 2-D motion front ends against the JAX package's on the JAX tests'
scenes, on the CPU: ``extract.detect_tracks``, mono-plane VO
(``tests/test_mono_plane_vo.py``) and the video stitcher
(``tests/test_lines_stitch.py``).

RANSAC is made the same in both (the port's ``robust.sample_indices`` draws
the reference's index sets from the reference's key chain).  Tolerances:
detections equal as sets (integer pixels); the bars of the JAX tests; the
port's trajectory within 1e-4 of the reference's and its mosaic transform
within 1e-3 (both estimate from float32 KLT positions that agree to 1e-3
px, through a float64 homography)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boofcv_tpu.feature import extract as jextract
from boofcv_tpu.geo import robust as jrobust
from boofcv_tpu.io import simulate as jsim
from boofcv_tpu.sfm import mono_plane_vo as jmono
from boofcv_tpu.sfm import stitch2d as jstitch
from boofcv_tpu_torch.feature import extract as textract
from boofcv_tpu_torch.geo import robust as trobust
from boofcv_tpu_torch.sfm import mono_plane_vo as tmono
from boofcv_tpu_torch.sfm import stitch2d as tstitch

torch.set_num_threads(1)

H, W = 120, 160
K = np.array([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1.0]])


def use_jax_draws(monkeypatch, key):
    """The port's RANSAC draws what the reference draws: each call splits
    ``key`` as the reference's front ends do and takes its index sets, on the
    port's own valid mask."""
    chain = {"key": key}

    def sample(generator, k, s, n, valid_mask=None):
        chain["key"], sub = jax.random.split(chain["key"])
        vm = None if valid_mask is None else jnp.asarray(valid_mask.numpy())
        return torch.from_numpy(np.asarray(
            jrobust.sample_indices(sub, k, s, n, vm))).long()

    monkeypatch.setattr(trobust, "sample_indices", sample)


@pytest.mark.parametrize("max_features", [50, 300])
def test_detect_tracks_matches_jax(max_features):
    img = np.array(jsim.noise_texture(np.random.default_rng(4), size=256)
                   [:H, :W])
    jy, jx, jv = jextract.detect_tracks(jnp.asarray(img), max_features)
    ty, tx, tv = textract.detect_tracks(torch.from_numpy(img), max_features)
    assert ty.dtype == torch.float32 and tv.dtype == torch.bool
    as_set = lambda y, x, v: {(float(a), float(b)) for a, b in
                              zip(np.asarray(y)[np.asarray(v)],
                                  np.asarray(x)[np.asarray(v)])}
    ref = as_set(jy, jx, jv)
    assert len(ref) > min(40, max_features - 1)
    assert as_set(ty, tx, tv) == ref


@pytest.fixture(scope="module")
def plane_scene():
    """tests/test_mono_plane_vo.py's scene: translation parallel to a
    textured plane 4 m ahead."""
    tex = jsim.noise_texture(np.random.default_rng(0))
    poses = [(np.eye(3), -np.array([0.06 * i, 0.02 * i, 0.0]))
             for i in range(5)]
    frames = [np.array(jsim.render_plane(
        tex, K, jnp.asarray(R), jnp.asarray(t), H, W,
        plane_origin=(0.0, 0.0, 4.0), plane_x=(1.0, 0.0, 0.0),
        plane_y=(0.0, 1.0, 0.0), texture_scale=45.0)) for R, t in poses]
    return poses, frames


def _run(vo, frames, poses):
    errs = []
    for frame, (R, t) in zip(frames, poses):
        assert vo.process(frame)
        errs.append(float(np.linalg.norm(vo.camera_to_world()[1] + R.T @ t)))
    return errs


def test_mono_plane_vo_matches_jax(plane_scene, monkeypatch):
    """The reference test's bar (last centre within 0.05 of the truth), and
    every frame's error within 1e-4 of the reference's on its draws."""
    poses, frames = plane_scene
    kw = dict(plane_normal=(0.0, 0.0, 1.0), plane_distance=4.0,
              num_tracks=200)
    ref = _run(jmono.MonoPlaneVisualOdometry(K, **kw), frames, poses)
    use_jax_draws(monkeypatch, jax.random.PRNGKey(0))
    errs = _run(tmono.MonoPlaneVisualOdometry(K, device="cpu", **kw), frames,
                poses)
    assert errs[-1] < 0.05, errs
    np.testing.assert_allclose(errs, ref, atol=1e-4)


def test_mono_plane_vo_picks_the_known_normal(plane_scene):
    """A normal given with negative z (the decomposition turns every
    candidate to n[2] >= 0): the |n . n0| selection and the sign
    re-alignment recover the same motion as the positive normal."""
    poses, frames = plane_scene
    runs = []
    for n in ((0.0, 0.0, 1.0), (0.0, 0.0, -1.0)):
        vo = tmono.MonoPlaneVisualOdometry(K, plane_normal=n,
                                           plane_distance=4.0,
                                           num_tracks=200, device="cpu")
        for frame in frames[:3]:
            assert vo.process(frame)
        runs.append(vo.camera_to_world()[1])
    np.testing.assert_allclose(runs[0], -runs[1] * np.array([1, 1, -1]),
                               atol=0.02)


@pytest.fixture(scope="module")
def stitch_scene():
    big = np.array(jsim.noise_texture(np.random.default_rng(0),
                                      size=260)[:140, :260])
    frames = [big[10:110, 10 + 12 * i:10 + 12 * i + 120].copy()
              for i in range(5)]
    return big, frames


def test_stitcher_translating_camera(stitch_scene, monkeypatch):
    """The reference test's bars (48 px of translation within 1 px, unit
    diagonal within 0.02, mosaic median error < 4), and the mosaic
    transform within 1e-3 of the reference's on its draws."""
    big, frames = stitch_scene
    ref = jstitch.Stitcher(140, 260, offset=(10.0, 10.0), num_tracks=200)
    for f in frames:
        assert ref.process(f)
    use_jax_draws(monkeypatch, jax.random.PRNGKey(0))
    st = tstitch.Stitcher(140, 260, offset=(10.0, 10.0), num_tracks=200,
                          device="cpu")
    for f in frames:
        assert st.process(f)
    Hm = st.H_mosaic_from_frame
    assert abs(Hm[0, 2] - (10 + 48)) < 1.0, Hm
    assert abs(Hm[1, 2] - 10) < 1.0, Hm
    assert abs(Hm[0, 0] - 1) < 0.02 and abs(Hm[1, 1] - 1) < 0.02
    m = st.image()
    assert np.median(np.abs(m[30:90, 30:150] - big[30:90, 30:150])) < 4.0
    np.testing.assert_allclose(Hm, ref.H_mosaic_from_frame, atol=1e-3)
    np.testing.assert_allclose(m, ref.image(), atol=0.05)


@pytest.mark.parametrize("entry", ["mono_plane", "stitcher"])
def test_default_device_is_the_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {"mono_plane": lambda: tmono.MonoPlaneVisualOdometry(
                K, (0.0, 0.0, 1.0), 4.0),
            "stitcher": lambda: tstitch.Stitcher(20, 20)}
    with pytest.raises(RuntimeError, match="CUDA"):
        make[entry]()
