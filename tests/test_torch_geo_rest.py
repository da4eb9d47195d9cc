"""The rest of the port's geometry against the JAX package on the same numpy
inputs: triangulation (midpoint, N-view DLT, reprojection error), camera
models, rectification and the homography decomposition.

Tolerances: float64 geometry within 1e-9 (absolute, or relative where the
values are large); the N-view DLT within 1e-9 after the eigenvector's sign
cancels in the division by w; ``homography_decompose`` equal (both are the
same numpy code); float32 maps within 1e-4 px."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.geo import cameras as jcam
from boofcv_tpu.geo import rectify as jrect
from boofcv_tpu.geo import selfcalib as jself
from boofcv_tpu.geo import se3 as jse3
from boofcv_tpu.geo import triangulate as jtri
from boofcv_tpu_torch.geo import cameras as tcam
from boofcv_tpu_torch.geo import rectify as trect
from boofcv_tpu_torch.geo import selfcalib as tself
from boofcv_tpu_torch.geo import triangulate as ttri

T = torch.from_numpy
A = np.asarray


def _views(rng, n=40, v=4):
    """V world->camera poses looking at N points in front of them, with
    normalized observations (slightly noisy)."""
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 9, n)], 1)
    Rs, ts, obs = [], [], []
    for i in range(v):
        R = A(jse3.exp_so3(jnp.asarray([0.02 * i, -0.03 * i, 0.01 * i])))
        t = np.array([0.3 * i, 0.05 * i, 0.02 * i])
        Xc = X @ R.T + t
        obs.append(Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 1e-3, (n, 2)))
        Rs.append(R)
        ts.append(t)
    return X, np.stack(Rs), np.stack(ts), np.stack(obs)


def test_triangulate_midpoint_matches_jax():
    X, Rs, ts, obs = _views(np.random.default_rng(0))
    ref = A(jtri.triangulate_two_view_midpoint(
        jnp.asarray(obs[0]), jnp.asarray(obs[3]), jnp.asarray(Rs[3]),
        jnp.asarray(ts[3])))
    out = ttri.triangulate_two_view_midpoint(T(obs[0]), T(obs[3]),
                                             T(Rs[3]), T(ts[3])).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-9, rtol=0)
    # near the truth (1e-3 noise on a 0.9 baseline)
    rel = np.linalg.norm(out - X, axis=1) / np.linalg.norm(X, axis=1)
    assert np.median(rel) < 0.02, np.median(rel)


@pytest.mark.parametrize("weighted", [False, True])
def test_triangulate_nview_matches_jax(weighted):
    rng = np.random.default_rng(1)
    X, Rs, ts, obs = _views(rng)
    w = (rng.uniform(0, 1, obs.shape[:2]) > 0.2).astype(np.float64)
    w[:2] = 1.0                                   # two views at least
    kw = {"weights": w} if weighted else {}
    ref = A(jtri.triangulate_nview_linear(
        jnp.asarray(obs), jnp.asarray(Rs), jnp.asarray(ts),
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    out = ttri.triangulate_nview_linear(
        T(obs), T(Rs), T(ts), **{k: T(v) for k, v in kw.items()}).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-9, rtol=1e-9)
    err_ref = A(jtri.reprojection_error(jnp.asarray(ref), jnp.asarray(obs),
                                        jnp.asarray(Rs), jnp.asarray(ts)))
    err = ttri.reprojection_error(T(out), T(obs), T(Rs), T(ts)).numpy()
    np.testing.assert_allclose(err, err_ref, atol=1e-12, rtol=1e-9)
    assert err.shape == obs.shape[:2] and err.max() < 1e-4


BROWN = dict(fx=410.0, fy=405.0, cx=321.5, cy=239.0, skew=0.7,
             radial=(-0.21, 0.05, -0.004), t1=0.0012, t2=-0.0008)


def _pixels(rng, n=200):
    return rng.uniform(0, 640, n), rng.uniform(0, 480, n)


def test_brown_camera_matches_jax():
    rng = np.random.default_rng(2)
    jc = jcam.CameraPinholeBrown(**BROWN)
    tc = tcam.CameraPinholeBrown(**BROWN)
    px, py = _pixels(rng)
    X = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1, 1, 200),
                  rng.uniform(2, 6, 200)], 1)
    pairs = [
        (jcam.pixel_to_norm(jc, jnp.asarray(px), jnp.asarray(py)),
         tcam.pixel_to_norm(tc, T(px), T(py))),
        (jcam.pixel_to_norm_undistorted(jc, jnp.asarray(px), jnp.asarray(py)),
         tcam.pixel_to_norm_undistorted(tc, T(px), T(py))),
        (jcam.project(jc, jnp.asarray(X)), tcam.project(tc, T(X))),
        (jcam.distort_norm(jc, jnp.asarray(px / 640), jnp.asarray(py / 480)),
         tcam.distort_norm(tc, T(px / 640), T(py / 480))),
    ]
    for ref, out in pairs:
        for r, o in zip(ref, out):
            np.testing.assert_allclose(o.numpy(), A(r), atol=1e-9, rtol=1e-12)
    # undistort inverts distort near the centre (20 fixed iterations)
    nx, ny = tcam.undistort_norm(tc, *tcam.distort_norm(
        tc, T(px / 2000), T(py / 2000)))
    np.testing.assert_allclose(nx.numpy(), px / 2000, atol=1e-9)
    np.testing.assert_allclose(ny.numpy(), py / 2000, atol=1e-9)
    np.testing.assert_allclose(tc.K(device="cpu").numpy(), A(jc.K()),
                               atol=0, rtol=0)


def test_omni_camera_matches_jax():
    rng = np.random.default_rng(3)
    kw = dict(BROWN, mirror_offset=0.9)
    jc, tc = jcam.CameraUniversalOmni(**kw), tcam.CameraUniversalOmni(**kw)
    X = np.stack([rng.uniform(-3, 3, 100), rng.uniform(-3, 3, 100),
                  rng.uniform(-0.5, 4, 100)], 1)
    for r, o in zip(jcam.omni_project(jc, jnp.asarray(X)),
                    tcam.omni_project(tc, T(X))):
        np.testing.assert_allclose(o.numpy(), A(r), atol=1e-9, rtol=1e-12)
    px, py = _pixels(rng, 100)
    np.testing.assert_allclose(
        tcam.omni_pixel_to_unit(tc, T(px), T(py)).numpy(),
        A(jcam.omni_pixel_to_unit(jc, jnp.asarray(px), jnp.asarray(py))),
        atol=1e-9, rtol=0)


def test_stereo_parameters_match_jax():
    cam = dict(fx=300.0, fy=300.0, cx=160.0, cy=120.0)
    R = ((1.0, 0.0, 0.0), (0.0, 0.9998, -0.02), (0.0, 0.02, 0.9998))
    t = (-0.12, 0.003, 0.001)
    js = jcam.StereoParameters(jcam.CameraPinholeBrown(**cam),
                               jcam.CameraPinholeBrown(**cam), R, t)
    ts = tcam.StereoParameters(tcam.CameraPinholeBrown(**cam),
                               tcam.CameraPinholeBrown(**cam), R, t)
    assert ts.baseline == js.baseline
    assert np.array_equal(ts.R(device="cpu").numpy(), A(js.R()))
    assert np.array_equal(ts.t(device="cpu").numpy(), A(js.t()))


def _rect_scene(seed):
    """The scene of the reference's rectification tests (320x240)."""
    rng = np.random.default_rng(seed)
    W, H = 320, 240
    K = np.array([[260.0, 0, W / 2], [0, 260.0, H / 2], [0, 0, 1.0]])
    n = 150
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 9, n)], 1)
    R = A(jse3.exp_so3(jnp.asarray([0.0, -0.06, 0.01])))
    t = np.array([0.6, 0.03, 0.05])

    def proj(P, R_, t_):
        pc = P @ R_.T + t_
        return ((pc / pc[:, 2:]) @ K.T)[:, :2], pc[:, 2]

    p1, z1 = proj(pts, np.eye(3), np.zeros(3))
    p2, z2 = proj(pts, R, t)
    inb = (((p1 > 8) & (p1 < [W - 8, H - 8])).all(1)
           & ((p2 > 8) & (p2 < [W - 8, H - 8])).all(1) & (z1 > 0) & (z2 > 0))
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    F = np.linalg.inv(K).T @ (tx @ R) @ np.linalg.inv(K)
    return K, R, t, p1[inb], p2[inb], F, W, H


def test_rectify_calibrated_matches_jax():
    K, R, t, *_ = _rect_scene(0)
    K2 = K + np.array([[3.0, 0, -2], [0, 1.0, 1.5], [0, 0, 0]])
    ref = jrect.rectify_calibrated(K, K2, R, t)
    out = trect.rectify_calibrated(K, K2, R, t, device="cpu")
    for a, b in zip(out[:4], ref[:4]):
        np.testing.assert_allclose(a.numpy(), A(b), atol=1e-9, rtol=1e-12)
    assert out.baseline == ref.baseline


def test_rectify_uncalibrated_and_adjust_match_jax():
    """Same homographies (the epipoles' SVD signs cancel: every use is
    projective), the same adjusted pair, and rows aligned."""
    K, R, t, p1, p2, F, W, H = _rect_scene(1)
    ref = jrect.rectify_uncalibrated(F, p1, p2, W, H)
    out = trect.rectify_uncalibrated(F, p1, p2, W, H)
    for a, b in zip(out, ref):
        b = A(b)
        np.testing.assert_allclose(a, b, atol=1e-9 * np.abs(b).max(), rtol=0)
    adj_ref = jrect.adjust_rectification(*ref, W, H)
    adj = trect.adjust_rectification(*out, W, H)
    for a, b in zip(adj, adj_ref):
        np.testing.assert_allclose(a, A(b), atol=1e-9 * np.abs(b).max(),
                                   rtol=0)
    with pytest.raises(ValueError, match="epipole"):
        # an epipole inside the image: forward motion
        tx = np.array([[0, -1.0, 0], [1.0, 0, 0], [0, 0, 0]])
        Fz = np.linalg.inv(K).T @ tx @ np.linalg.inv(K)
        trect.rectify_uncalibrated(Fz, p1, p2, W, H)


def test_rectify_maps_and_depth_match_jax():
    K, R, t, *_ = _rect_scene(0)
    pair = jrect.rectify_calibrated(K, K, R, t)
    my, mx = jrect.rectify_maps(pair.rect1, 60, 80)
    ty_, tx_ = trect.rectify_maps(np.array(pair.rect1), 60, 80, device="cpu")
    assert ty_.dtype == torch.float32 and ty_.shape == (60, 80)
    np.testing.assert_allclose(ty_.numpy(), A(my), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tx_.numpy(), A(mx), atol=1e-4, rtol=0)
    disp = np.random.default_rng(4).uniform(-5, 60, (30, 40))
    ref = A(jrect.disparity_to_depth(jnp.asarray(disp), jnp.asarray(K), 0.3))
    out = trect.disparity_to_depth(T(disp), T(K), 0.3).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-9, rtol=1e-12)
    assert (out[disp <= 0] == 0).all()


def test_homography_decompose_equals_jax():
    rng = np.random.default_rng(5)
    K = np.array([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1.0]])
    R = A(jse3.exp_so3(jnp.asarray([0.05, -0.1, 0.02])))
    t = np.array([0.3, -0.1, 0.05])
    n = np.array([0.1, -0.2, 1.0])
    n /= np.linalg.norm(n)
    Hn = R + np.outer(t, n) / 4.0
    Hp = K @ Hn @ np.linalg.inv(K) * rng.uniform(0.5, 2.0)
    for args in ((Hn,), (Hp, K, K), (np.eye(3),)):
        ref = jself.homography_decompose(*args)
        out = tself.homography_decompose(*args)
        assert len(out) == len(ref)
        for so, sr in zip(out, ref):
            for a, b in zip(so, sr):
                assert np.array_equal(a, b)
    best = max(tself.homography_decompose(Hp, K, K),
               key=lambda s: abs(s[2] @ n))
    np.testing.assert_allclose(best[0], R, atol=1e-9)
    np.testing.assert_allclose(best[1], t / 4.0, atol=1e-9)
