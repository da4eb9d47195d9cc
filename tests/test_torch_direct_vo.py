"""The port's direct (photometric) RGB-D VO against the JAX package's on
``tests/test_depth_direct_vo.py``'s scene (120x160), on the CPU.

Tolerances: the [H, W, 6] forward-mode Jacobian within 1e-5 relative of
``jax.jvp``'s through the reference's own building blocks; one estimate
(3 levels x 10 Gauss-Newton iterations) within 1e-6 on R, t and the rmse;
the trajectory within the JAX test's bar (mean centre error < 0.03) and
within 1e-5 of the reference's run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from boofcv_tpu.geo import se3 as jse3
from boofcv_tpu.io import simulate as jsim
from boofcv_tpu.ip.interpolate import bilinear as jbilinear
from boofcv_tpu.sfm import direct_vo as jdirect
from boofcv_tpu_torch.sfm import direct_vo as tdirect

torch.set_num_threads(1)

H, W = 120, 160
K = np.array([[150.0, 0.0, W / 2], [0.0, 150.0, H / 2], [0.0, 0.0, 1.0]])


def render_rgbd(rng, poses):
    """Gray + exact depth of the reference test's plane world (the plane
    6 m ahead, tilted as ``render_plane``'s default)."""
    tex = jsim.noise_texture(rng)
    grays = [np.array(jsim.render_plane(tex, K, R, t, H, W,
                                        plane_origin=(0.0, 0.0, 6.0)))
             for R, t in poses]
    return list(zip(grays, chip_smoke.plane_depths(poses, K, H, W,
                                                   origin=(0.0, 0.0, 6.0))))


@pytest.fixture(scope="module")
def scene():
    poses = []
    for i in range(5):
        R = np.asarray(jse3.exp_so3(jnp.asarray([0.0, 0.003 * i, 0.0])))
        poses.append((R, -R @ np.array([0.01 * i, 0.0, 0.04 * i])))
    return poses, render_rgbd(np.random.default_rng(1), poses)


def _jax_jacobian(img_k, img_c, depth, Kl, R, t, min_depth=1e-3):
    """``direct_vo.make_direct_step``'s residual and its jvp along the six
    basis directions, as the reference writes them
    (boofcv_tpu/sfm/direct_vo.py:71-99)."""
    fx, fy, cx, cy = Kl[0, 0], Kl[1, 1], Kl[0, 2], Kl[1, 2]
    h, w = img_k.shape
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float64),
                          jnp.arange(w, dtype=jnp.float64), indexing="ij")
    z = jnp.asarray(depth, jnp.float64)
    valid0 = z > min_depth
    X = jnp.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z], -1)

    def residual(xi):
        dR, dt = jse3.exp_se3(xi)
        Rc, tc = jse3.compose(dR, dt, jnp.asarray(R), jnp.asarray(t))
        Xc = X @ Rc.T + tc
        zc = jnp.maximum(Xc[..., 2], 1e-6)
        u = Xc[..., 0] / zc * fx + cx
        v = Xc[..., 1] / zc * fy + cy
        inb = ((u >= 1) & (u <= w - 2) & (v >= 1) & (v <= h - 2) & valid0
               & (Xc[..., 2] > min_depth))
        warped = jbilinear(jnp.asarray(img_c), v.astype(jnp.float32),
                           u.astype(jnp.float32))
        r = (warped - jnp.asarray(img_k)).astype(jnp.float64)
        return r * inb.astype(jnp.float64)

    xi0 = jnp.zeros((6,), jnp.float64)
    J = jnp.stack([jax.jvp(residual, (xi0,),
                           (jnp.zeros(6, jnp.float64).at[i].set(1.0),))[1]
                   for i in range(6)], -1)
    return np.asarray(residual(xi0)), np.asarray(J)


@pytest.mark.parametrize("level", [0, 2])
def test_jacobian_matches_jax_jvp(scene, level):
    """Off the identity (a small pose error), at a fine and a coarse
    level."""
    _, frames = scene
    s = 2 ** level
    img_k = frames[0][0][::s, ::s].copy()
    img_c = frames[2][0][::s, ::s].copy()
    depth = frames[0][1][::s, ::s].copy()
    Kl = tdirect._level_K(K, s)
    R = np.array(jse3.exp_so3(jnp.asarray([0.002, -0.004, 0.001])))
    t = np.array([0.01, -0.005, -0.06])
    r_ref, J_ref = _jax_jacobian(img_k, img_c, depth, Kl, R, t)
    residual = tdirect._level_residual(torch.from_numpy(img_k),
                                       torch.from_numpy(img_c),
                                       torch.from_numpy(depth), Kl, 1e-3)
    r, _, J = tdirect._residual_jacobian(residual, torch.from_numpy(R),
                                        torch.from_numpy(t))
    assert J.shape == (img_k.shape[0], img_k.shape[1], 6)
    assert J.dtype == torch.float64
    np.testing.assert_allclose(r.numpy(), r_ref, atol=1e-4, rtol=0)
    scale = np.abs(J_ref).max(axis=(0, 1))
    assert (scale > 0).all()
    np.testing.assert_allclose(J.numpy() / scale, J_ref / scale, atol=1e-5,
                               rtol=0)


def test_estimate_matches_jax(scene):
    _, frames = scene
    (kg, kd), (cg, _) = frames[0], frames[3]
    ref = jdirect.make_direct_step(K)(
        jnp.asarray(kg), jnp.asarray(kd), jnp.asarray(cg),
        jnp.eye(3, dtype=jnp.float64), jnp.zeros(3, jnp.float64))
    out = tdirect.make_direct_step(K)(
        torch.from_numpy(kg), torch.from_numpy(kd), torch.from_numpy(cg),
        torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


def test_direct_vo_recovers_trajectory(scene):
    """The reference test's bar, and within 1e-5 of the reference's run."""
    poses, frames = scene
    ref_vo = jdirect.DirectDepthVisualOdometry(K)
    vo = tdirect.DirectDepthVisualOdometry(K, device="cpu")
    errs, ref_errs = [], []
    for (gray, depth), (R, t) in zip(frames, poses):
        assert vo.process(gray, depth) and ref_vo.process(gray, depth)
        c_gt = -R.T @ t
        errs.append(np.linalg.norm(vo.camera_to_world()[1] - c_gt))
        ref_errs.append(np.linalg.norm(ref_vo.camera_to_world()[1] - c_gt))
    assert np.mean(errs) < 0.03, errs
    np.testing.assert_allclose(errs, ref_errs, atol=1e-5)
    assert np.isfinite(vo.last_rmse)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdirect.DirectDepthVisualOdometry(K)
