"""Geometry: the port against the JAX package on the same numpy inputs.
float64 results agree to 1e-9; float32 results to 1e-4 (the f32 P3P) or
to the f32 refine's own resolution, as stated per test."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.geo import pnp as jpnp
from boofcv_tpu.geo import rectify as jrect
from boofcv_tpu.geo import robust as jrobust
from boofcv_tpu.geo import se3 as jse3
from boofcv_tpu.geo import smalllinalg as jla
from boofcv_tpu_torch.geo import pnp as tpnp
from boofcv_tpu_torch.geo import rectify as trect
from boofcv_tpu_torch.geo import robust as trobust
from boofcv_tpu_torch.geo import se3 as tse3
from boofcv_tpu_torch.geo import smalllinalg as tla

torch.set_num_threads(1)

def T(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rotvecs(rng, n):
    w = rng.normal(0, 1, (n, 3))
    w[:4] = [[0, 0, 0], [1e-9, -2e-9, 0], [np.pi - 1e-5, 0, 0],
             [0, 0.3, -0.2]]
    return w


def test_so3_exp_log_invert():
    w = _rotvecs(np.random.default_rng(0), 64)
    R_ref = np.asarray(jse3.exp_so3(jnp.asarray(w)))
    R = tse3.exp_so3(T(w))
    np.testing.assert_allclose(_np(R), R_ref, atol=1e-9)
    np.testing.assert_allclose(_np(tse3.log_so3(R)),
                               np.asarray(jse3.log_so3(jnp.asarray(R_ref))),
                               atol=1e-9)
    t = np.random.default_rng(1).normal(0, 1, (64, 3))
    Ri, ti = tse3.invert(R, T(t))
    Rj, tj = jse3.invert(jnp.asarray(R_ref), jnp.asarray(t))
    np.testing.assert_allclose(_np(Ri), np.asarray(Rj), atol=1e-9)
    np.testing.assert_allclose(_np(ti), np.asarray(tj), atol=1e-9)


def test_exp_se3_compose():
    xi = np.random.default_rng(2).normal(0, 0.5, (32, 6))
    xi[0] = 0.0
    (Rj, tj), (Rt, tt) = jse3.exp_se3(jnp.asarray(xi)), tse3.exp_se3(T(xi))
    np.testing.assert_allclose(_np(Rt), np.asarray(Rj), atol=1e-9)
    np.testing.assert_allclose(_np(tt), np.asarray(tj), atol=1e-9)
    Rc, tc = tse3.compose(Rt, tt, Rt.flip(0), tt.flip(0))
    Rcj, tcj = jse3.compose(Rj, tj, Rj[::-1], tj[::-1])
    np.testing.assert_allclose(_np(Rc), np.asarray(Rcj), atol=1e-9)
    np.testing.assert_allclose(_np(tc), np.asarray(tcj), atol=1e-9)


def _quartic_coeffs(rng, n):
    """Quartics with real roots at least 0.3 apart (a near-double root is
    ill-conditioned in float32: both packages then miss it by ~1e-4 in
    different directions), a quarter of them shifted to complex pairs."""
    roots = np.stack([np.sort(rng.choice(np.arange(-3.0, 3.01, 0.3), 4,
                                         replace=False))
                      + rng.uniform(0, 0.05, 4) for _ in range(n)])
    c = np.stack([np.poly(r) for r in roots])       # [n, 5] high -> low
    c[: n // 4, 4] += 5.0
    return c


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-9),
                                        (np.float32, 1e-4)])
def test_quartic_and_cubic_roots(dtype, atol):
    c = _quartic_coeffs(np.random.default_rng(3), 128).astype(dtype)
    rj, mj = jla.quartic_roots(*[jnp.asarray(c[:, i]) for i in range(5)])
    rt, mt = tla.quartic_roots(*[T(c[:, i].copy()) for i in range(5)])
    # the reference promotes the quartic's back half to float64 even for
    # float32 coefficients (jnp.arange(3.0) under x64); so does the port
    assert _np(rt).dtype == np.asarray(rj).dtype
    assert np.array_equal(_np(mt), np.asarray(mj))
    m = np.asarray(mj)
    np.testing.assert_allclose(_np(rt)[m], np.asarray(rj)[m], atol=atol)
    cc = c[:, 1:].copy()
    rj, mj = jla.cubic_roots(*[jnp.asarray(cc[:, i]) for i in range(4)])
    rt, mt = tla.cubic_roots(*[T(cc[:, i].copy()) for i in range(4)])
    assert np.array_equal(_np(mt), np.asarray(mj))
    m = np.asarray(mj)
    np.testing.assert_allclose(_np(rt)[m], np.asarray(rj)[m], atol=atol)


def _scene(rng, n, noise=0.0, outliers=0.0):
    world = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(4, 9, n)], 1)
    R = np.asarray(jse3.exp_so3(jnp.asarray(rng.normal(0, 0.1, 3))))
    t = rng.normal(0, 0.2, 3)
    Xc = world @ R.T + t
    obs = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, noise, (n, 2))
    bad = rng.uniform(size=n) < outliers
    obs[bad] += rng.uniform(-0.2, 0.2, (bad.sum(), 2))
    return world, obs, R, t


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-9),
                                        (np.float32, 1e-4)])
def test_p3p_grunert(dtype, atol):
    rng = np.random.default_rng(4)
    K = 64
    world = np.zeros((K, 3, 3))
    obs = np.zeros((K, 3, 2))
    for k in range(K):
        w, o, _, _ = _scene(rng, 3)
        world[k], obs[k] = w, o
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    Rj, tj, okj = jpnp.p3p_grunert(jnp.asarray(world), jnp.asarray(obs),
                                   dtype=jdt)
    Rt, tt, okt = tpnp.p3p_grunert(T(world), T(obs), dtype=tdt)
    both = np.asarray(okj) & _np(okt)
    assert both.sum() >= K                            # >= 1 solution each
    assert np.array_equal(np.asarray(okj), _np(okt))
    # compare well-conditioned solutions: those where the reference's own
    # float32 solution is within 1e-5 of its float64 one.  A root near a
    # double root is ill-conditioned (float32 rounding moves it by up to
    # 1e-2 in either package, float64 by ~1e-9), so there the packages
    # are each as far from the float64 root as from each other
    R64, _, _ = jpnp.p3p_grunert(jnp.asarray(world), jnp.asarray(obs))
    R32, _, _ = jpnp.p3p_grunert(jnp.asarray(world), jnp.asarray(obs),
                                 dtype=jnp.float32)
    err_ref = np.abs(np.asarray(R32) - np.asarray(R64)).max((-1, -2))
    sel = both & (err_ref < 1e-5)
    assert sel.sum() > 0.3 * both.sum()
    if dtype == np.float32:
        err_port = np.abs(_np(Rt) - np.asarray(R64)).max((-1, -2))
        assert np.median(err_port[both]) <= 2 * np.median(err_ref[both])
    np.testing.assert_allclose(_np(Rt)[sel], np.asarray(Rj)[sel], atol=atol)
    # t = mean(cam) - R mean(world) carries R's error times the points'
    # distance (up to 9 units): the same tolerance scaled by that distance
    scale = np.abs(world).max()
    np.testing.assert_allclose(_np(tt)[sel], np.asarray(tj)[sel],
                               atol=atol * scale)


def test_reprojection_error_sq():
    world, obs, R, t = _scene(np.random.default_rng(5), 100, noise=1e-3)
    world[0, 2] = -1.0                                # behind the camera
    ref = np.asarray(jpnp.reprojection_error_sq(
        jnp.asarray(R), jnp.asarray(t), jnp.asarray(world), jnp.asarray(obs)))
    out = _np(tpnp.reprojection_error_sq(T(R), T(t), T(world), T(obs)))
    assert np.isinf(ref[0]) == np.isinf(out[0])
    np.testing.assert_allclose(out, ref, atol=1e-9, rtol=0)


@pytest.mark.parametrize("polish,atol", [(2, 1e-9), (0, 1e-5)])
def test_gauss_newton_pose(polish, atol):
    """polish=2 ends in float64 steps (1e-9); polish=0 is the VO path's
    float32 loop + float64 re-orthogonalisation (f32 resolution, 1e-5)."""
    rng = np.random.default_rng(6)
    world, obs, R, t = _scene(rng, 120, noise=5e-4)
    R0 = R @ np.asarray(jse3.exp_so3(jnp.asarray([0.02, -0.01, 0.015])))
    t0 = t + np.array([0.03, -0.02, 0.05])
    wgt = (rng.uniform(size=120) > 0.1).astype(np.float64)
    Rj, tj = jpnp.gauss_newton_pose(jnp.asarray(R0), jnp.asarray(t0),
                                    jnp.asarray(world), jnp.asarray(obs),
                                    jnp.asarray(wgt), iterations=10,
                                    polish_iterations=polish)
    Rt, tt = tpnp.gauss_newton_pose(T(R0), T(t0), T(world), T(obs), T(wgt),
                                    iterations=10, polish_iterations=polish)
    assert Rt.dtype == torch.float64
    np.testing.assert_allclose(_np(Rt), np.asarray(Rj), atol=atol)
    np.testing.assert_allclose(_np(tt), np.asarray(tj), atol=atol)


@pytest.mark.parametrize("seed", [7, 8])
def test_ransac_pnp_with_injected_samples(seed):
    """Same [K, 3] index sets in both (the JAX draw, injected): equal
    inlier mask and count, pose within 1e-6."""
    rng = np.random.default_rng(seed)
    world, obs, R, t = _scene(rng, 200, noise=3e-4, outliers=0.25)
    valid = rng.uniform(size=200) > 0.05
    K = 128
    thr = (1.5 / 480.0) ** 2
    key = jax.random.PRNGKey(seed)
    idx = np.asarray(jrobust.sample_indices(key, K, 3, 200,
                                            jnp.asarray(valid)))
    rj, (Rj, tj) = jrobust.ransac_pnp(
        key, jnp.asarray(world), jnp.asarray(obs), num_hypotheses=K,
        inlier_threshold=thr, valid_mask=jnp.asarray(valid),
        refine_iterations=10)
    rt, (Rt, tt) = trobust.ransac_pnp(
        None, T(world), T(obs), num_hypotheses=K, inlier_threshold=thr,
        valid_mask=T(valid), refine_iterations=10, idx=T(idx).long())
    assert np.array_equal(_np(rt.inliers), np.asarray(rj.inliers))
    assert int(rt.num_inliers) == int(rj.num_inliers)
    np.testing.assert_allclose(_np(Rt), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(_np(tt), np.asarray(tj), atol=1e-6)
    # and the pose is the true one to within the noise
    assert np.abs(_np(Rt) - R).max() < 2e-3


def test_sample_indices_distinct_and_valid():
    g = torch.Generator().manual_seed(0)
    valid = torch.rand(50, generator=g) > 0.3
    idx = trobust.sample_indices(g, 200, 3, 50, valid)
    assert idx.shape == (200, 3)
    assert bool(valid[idx].all())
    s = idx.sort(dim=1).values
    assert bool((s[:, 1:] != s[:, :-1]).all())


def test_pixel_to_3d_rectified():
    rng = np.random.default_rng(9)
    K = np.array([[480.0, 0, 320], [0, 480.0, 240], [0, 0, 1]])
    xs, ys = rng.uniform(0, 640, 50), rng.uniform(0, 480, 50)
    d = rng.uniform(-1, 90, 50)
    ref = jrect.pixel_to_3d_rectified(jnp.asarray(xs), jnp.asarray(ys),
                                      jnp.asarray(d), jnp.asarray(K), 0.4)
    out = trect.pixel_to_3d_rectified(T(xs), T(ys), T(d), T(K), 0.4)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-9, rtol=0)
