"""Zhang99 calibration: the port against the JAX package on the same seeded
synthetic target views (4-6 views of an 8x6 grid, 0.3 px noise).  K and the
radial distortion agree within 1e-6 relative; the closed-form pieces (a
copy of the reference's numpy) exactly or to float64 rounding."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.calib import zhang99 as jz
from boofcv_tpu.geo import se3 as jse3
from boofcv_tpu_torch.calib import zhang99 as tz

torch.set_num_threads(1)
CPU = "cpu"


def _scene(n_views=5, nx=8, ny=6, noise=0.3, seed=0, omni_xi=0.0):
    """A planar grid seen by a Brown (or universal-omni) camera."""
    rng = np.random.default_rng(seed)
    world = np.stack(np.meshgrid(np.arange(nx) * 0.03, np.arange(ny) * 0.03),
                     -1).reshape(-1, 2)
    K = np.array([[520.0, 0, 320.0], [0, 515.0, 240.0], [0, 0, 1.0]])
    k1, k2 = -0.25, 0.08
    obs = []
    for _ in range(n_views):
        w = rng.uniform(-0.5, 0.5, 3)
        w[2] = rng.uniform(-0.3, 0.3)
        R = np.asarray(jse3.exp_so3(jnp.asarray(w)))
        t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.08, 0.08),
                      rng.uniform(0.5, 0.9)])
        Xc = np.c_[world, np.zeros(len(world))] @ R.T + t
        if omni_xi:
            s = Xc / np.linalg.norm(Xc, axis=1, keepdims=True)
            xn = s[:, :2] / (s[:, 2:] + omni_xi)
        else:
            xn = Xc[:, :2] / Xc[:, 2:]
        r2 = (xn ** 2).sum(1)
        xd = xn * (1 + k1 * r2 + k2 * r2 * r2)[:, None]
        px = xd @ K[:2, :2].T + K[:2, 2]
        obs.append(px + rng.normal(0, noise, px.shape))
    return world, np.stack(obs)


def _same_calibration(ref, out, rtol=1e-6):
    np.testing.assert_allclose(out.K, ref.K, rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(out.radial, ref.radial, rtol=rtol, atol=1e-9)
    np.testing.assert_allclose(out.rotations, ref.rotations, atol=1e-6)
    np.testing.assert_allclose(out.translations, ref.translations, atol=1e-6)
    np.testing.assert_allclose(out.reprojection_rmse, ref.reprojection_rmse,
                               rtol=1e-6)


def test_closed_form_pieces():
    world, obs = _scene(seed=1)
    Hj = np.asarray(jz.homographies_per_view(world, obs))
    Ht = tz.homographies_per_view(world, obs, device=CPU).numpy()
    np.testing.assert_allclose(Ht, Hj, rtol=1e-9, atol=1e-9 * np.abs(Hj).max())
    K = jz.k_from_homographies(Hj)
    np.testing.assert_array_equal(tz.k_from_homographies(Hj), K)
    for H in Hj:
        for a, b in zip(jz.extrinsics_from_homography(H, K),
                        tz.extrinsics_from_homography(H, K)):
            np.testing.assert_array_equal(a, b)
    Rs, ts = zip(*(jz.extrinsics_from_homography(H, K) for H in Hj))
    assert (jz.linear_radial_estimate(world, obs, K, Rs, ts)
            == tz.linear_radial_estimate(world, obs, K, Rs, ts))


def test_project_and_jacobians():
    rng = np.random.default_rng(2)
    intr = np.array([510.0, 500.0, 0.5, 322.0, 238.0, -0.2, 0.05])
    xi = rng.normal(0, 0.2, (4, 6))
    xi[:, 5] += 1.0
    Rs, ts = jse3.exp_se3(jnp.asarray(xi))
    w3 = np.c_[rng.uniform(0, 0.2, (12, 2)), np.zeros(12)]
    ref = jz._brown_project_and_jac(jnp.asarray(intr), Rs, ts, jnp.asarray(w3))
    out = tz._brown_project_and_jac(torch.from_numpy(intr),
                                    torch.from_numpy(np.array(Rs)),
                                    torch.from_numpy(np.array(ts)),
                                    torch.from_numpy(w3))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-9)
    params = np.concatenate([intr, xi.reshape(-1)])
    np.testing.assert_allclose(
        tz._project_all(torch.from_numpy(params), torch.from_numpy(w3[:, :2]),
                        4).numpy(),
        np.asarray(jz._project_all(jnp.asarray(params),
                                   jnp.asarray(w3[:, :2]), 4)),
        rtol=1e-12, atol=1e-9)
    params = np.concatenate([intr, [0.7], xi.reshape(-1)])
    np.testing.assert_allclose(
        tz._project_all_omni(torch.from_numpy(params),
                             torch.from_numpy(w3[:, :2]), 4).numpy(),
        np.asarray(jz._project_all_omni(jnp.asarray(params),
                                        jnp.asarray(w3[:, :2]), 4)),
        rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("masked", [False, True])
def test_calibrate_mono_planar(masked):
    world, obs = _scene(n_views=6, seed=3)
    mask = None
    if masked:
        mask = np.random.default_rng(4).uniform(size=obs.shape[:2]) > 0.15
    ref = jz.calibrate_mono_planar(world, obs, iterations=20, obs_mask=mask)
    out = tz.calibrate_mono_planar(world, obs, iterations=20, obs_mask=mask,
                                   device=CPU)
    _same_calibration(ref, out)
    assert abs(out.K[0, 0] - 520.0) < 10.0 and out.reprojection_rmse < 0.5


def test_calibrate_stereo_planar():
    world, obs_l = _scene(seed=5)
    obs_r = obs_l + np.array([-30.0, 0.5])       # a camera moved sideways
    ref = jz.calibrate_stereo_planar(world, obs_l, obs_r, iterations=15)
    out = tz.calibrate_stereo_planar(world, obs_l, obs_r, iterations=15,
                                     device=CPU)
    _same_calibration(ref[0], out[0])
    _same_calibration(ref[1], out[1])
    np.testing.assert_allclose(out[2], ref[2], atol=1e-6)
    np.testing.assert_allclose(out[3], ref[3], atol=1e-6)


def test_calibrate_mono_omni():
    """Forward-mode Jacobians in both packages (jax.jacfwd,
    torch.func.jacfwd); K, distortion and the mirror offset within 1e-6
    relative from one mirror seed.  (With two seeds whose final costs tie
    to 1e-8 the two packages may keep different seeds: the omni objective
    is flat along focal length against mirror offset.)"""
    world, obs = _scene(n_views=4, seed=6, omni_xi=0.6, noise=0.1)
    ref = jz.calibrate_mono_omni(world, obs, iterations=15,
                                 mirror_inits=(0.5,))
    out = tz.calibrate_mono_omni(world, obs, iterations=15,
                                 mirror_inits=(0.5,), device=CPU)
    _same_calibration(ref, out)
    np.testing.assert_allclose(out.mirror_offset, ref.mirror_offset,
                               rtol=1e-6)


def test_default_device_is_the_card():
    world, obs = _scene(seed=7)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError):
        tz.calibrate_mono_planar(world, obs, iterations=2)
