"""The functions the port's modules lacked: derivative stencils, the
convolve-and-decimate and sparse convolutions, bicubic sampling, the
blur-and-decimate pyramid and the Gaussian scale space, FAST and the other
corner and blob intensities, four PnP solvers and the checker texture; the
port against the JAX package on the same seeded numpy inputs, on the CPU.

Tolerances: stencils of small integers on integer-valued images are exact
in float32 whatever the summation order (every partial sum is an integer
below 2^24), and so are FAST's compares and its integer scores; on
non-integer images the float32 stencils (shifted adds against XLA's
convolution) agree to 1e-5 relative to the image's scale, the products and
quotients built on them (Harris, Kitchen-Rosenfeld, Hessian determinant)
to 1e-4 relative; the Gaussian pyramid and scale space (float32 separable
sums of 7-19 taps in another order) to 2e-6 relative, 16 float32 ulps;
bicubic's float64 weights (XLA may fuse a multiply and an add) to 1e-12
relative, its float32 ones to 2e-6; the PnP
solvers compare poses, not intermediate vectors (eigen- and singular-vector
signs are not unique): refined poses to 1e-8, unrefined linear ones to
1e-6, all also against the truth with the reference test's bars.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.core.border import BorderType as JBorder
from boofcv_tpu.core.pyramid import PyramidConfig as JPyramidConfig
from boofcv_tpu.core.pyramid import pyramid_shapes as jpyramid_shapes
from boofcv_tpu.feature import intensity as jint
from boofcv_tpu.geo import pnp as jpnp
from boofcv_tpu.geo import se3 as jse3
from boofcv_tpu.io import simulate as jsim
from boofcv_tpu.ip import convolve as jconv
from boofcv_tpu.ip import derivative as jderiv
from boofcv_tpu.ip import interpolate as jinterp
from boofcv_tpu.ip import pyramid_ops as jpyr
from boofcv_tpu_torch.core.border import BorderType
from boofcv_tpu_torch.core.pyramid import PyramidConfig, pyramid_shapes
from boofcv_tpu_torch.feature import intensity as tint
from boofcv_tpu_torch.geo import pnp as tpnp
from boofcv_tpu_torch.io import simulate as tsim
from boofcv_tpu_torch.ip import convolve as tconv
from boofcv_tpu_torch.ip import derivative as tderiv
from boofcv_tpu_torch.ip import interpolate as tinterp
from boofcv_tpu_torch.ip import pyramid_ops as tpyr

torch.set_num_threads(1)


def _images(h=37, w=53, seed=0):
    """(integer-valued, non-integer) float32 [h, w] images, 0-255."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 256, (h, w)).astype(np.float32)
    floats = rng.uniform(0, 255, (h, w)).astype(np.float32)
    return ints, floats


def _close(got, want, exact: bool, rtol=1e-5, scale=255.0):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale * 8)


BORDERS = ("EXTENDED", "REFLECT", "ZERO", "SKIP", "NORMALIZED")
STENCILS = ("prewitt", "three", "two0", "two1", "laplacian", "hessian_three")


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("name", STENCILS)
def test_derivative_stencils(name, border):
    for exact, img in zip((True, False), _images()):
        want = getattr(jderiv, name)(jnp.asarray(img), JBorder[border])
        got = getattr(tderiv, name)(torch.from_numpy(img),
                                    BorderType[border])
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            # NORMALIZED divides by the kernel's in-image sum (and a
            # difference kernel sums to 0): integers no longer
            _close(g.numpy(), w, exact and border != "NORMALIZED")


def test_hessian_from_gradient_and_magnitude_angle():
    for exact, img in zip((True, False), _images(41, 30, seed=1)):
        jdx, jdy = jderiv.sobel(jnp.asarray(img))
        tdx, tdy = tderiv.sobel(torch.from_numpy(img))
        want = jderiv.hessian_from_gradient(jdx, jdy)
        got = tderiv.hessian_from_gradient(tdx, tdy)
        for g, w in zip(got, want):
            _close(g.numpy(), w, exact, scale=255.0 * 64)
        mag, ang = tderiv.gradient_magnitude_angle(tdx, tdy)
        jmag, jang = jderiv.gradient_magnitude_angle(jdx, jdy)
        np.testing.assert_allclose(mag.numpy(), jmag, rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(ang.numpy(), jang, rtol=0, atol=1e-5)


@pytest.mark.parametrize("skip", (2, 3))
@pytest.mark.parametrize("axis", (0, 1))
def test_convolve_down(axis, skip):
    ints, floats = _images(23, 31, seed=2)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for exact, img in ((True, ints * 4), (False, floats)):
        want = jconv.convolve_down(jnp.asarray(img), jnp.asarray(k), skip,
                                   axis)
        got = tconv.convolve_down(torch.from_numpy(img), torch.from_numpy(k),
                                  skip, axis)
        _close(got.numpy(), want, exact)


def test_sparse_sample_at_borders():
    _, img = _images(20, 26, seed=3)
    k1 = np.array([0.25, 0.5, 0.25])
    k2 = np.outer(k1, np.array([-1.0, 0.0, 1.0, 2.0, 0.5]))   # 3x5
    ys = np.array([0, 5, 19, 10, 0, 19, -3, 25])
    xs = np.array([0, 7, 25, 0, 25, 12, 4, 30])
    for dtype in (np.float32, np.float64):
        kk = k2.astype(dtype)
        want = jconv.sparse_sample(jnp.asarray(img), jnp.asarray(kk),
                                   jnp.asarray(ys), jnp.asarray(xs))
        got = tconv.sparse_sample(torch.from_numpy(img), torch.from_numpy(kk),
                                  torch.from_numpy(ys), torch.from_numpy(xs))
        assert got.dtype == torch.from_numpy(kk).dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    # the full EXTENDED convolution at those pixels, inside the image
    full = tconv.convolve2d(torch.from_numpy(img),
                            torch.from_numpy(k2.astype(np.float32)),
                            BorderType.EXTENDED)
    inside = (ys >= 0) & (ys < 20) & (xs >= 0) & (xs < 26)
    got = tconv.sparse_sample(torch.from_numpy(img),
                              torch.from_numpy(k2.astype(np.float32)),
                              torch.from_numpy(ys), torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy()[inside],
                               full.numpy()[ys[inside], xs[inside]],
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
def test_bicubic_dtype_and_borders(dtype):
    _, img = _images(19, 27, seed=4)
    rng = np.random.default_rng(5)
    ys = rng.uniform(-2.5, 21.0, (7, 9)).astype(dtype)
    xs = rng.uniform(-2.5, 29.0, (7, 9)).astype(dtype)
    want = np.asarray(jinterp.bicubic(jnp.asarray(img), jnp.asarray(ys),
                                      jnp.asarray(xs)))
    got = tinterp.bicubic(torch.from_numpy(img), torch.from_numpy(ys),
                          torch.from_numpy(xs)).numpy()
    # float64 coordinates give a float64 result from the float32 image
    assert want.dtype == dtype and got.dtype == dtype
    rtol = 1e-12 if dtype == np.float64 else 2e-6
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * 255)
    # at integer coordinates inside, bicubic returns the pixel
    yi, xi = np.mgrid[1:18, 1:26].astype(dtype)
    at = tinterp.bicubic(torch.from_numpy(img), torch.from_numpy(yi),
                         torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(at, img[1:18, 1:26], rtol=1e-6)


@pytest.mark.parametrize("scales,sigma,shape", [
    ((1, 2, 4), -1.0, (61, 83)), ((1, 4), 1.5, (50, 77)),
    ((1, 2, 8), 0.8, (97, 64))])
def test_pyramid_discrete(scales, sigma, shape):
    _, img = _images(*shape, seed=6)
    want = jpyr.pyramid_discrete(jnp.asarray(img),
                                 JPyramidConfig(scales=scales, sigma=sigma))
    got = tpyr.pyramid_discrete(torch.from_numpy(img),
                                PyramidConfig(scales=scales, sigma=sigma))
    assert len(got) == len(want)
    for g, w, hw in zip(got, want, pyramid_shapes(PyramidConfig(scales),
                                                  *shape)):
        assert tuple(g.shape) == hw == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-6, atol=1e-5)
    assert pyramid_shapes(PyramidConfig(scales), *shape) == \
        jpyramid_shapes(JPyramidConfig(scales), *shape)


def test_pyramid_steps_must_be_powers_of_two():
    img = torch.zeros(32, 48)
    for fn in (tpyr.pyramid_discrete, tpyr.pyramid_average):
        with pytest.raises(ValueError, match="powers of 2"):
            fn(img, PyramidConfig(scales=(1, 3)))
        with pytest.raises(ValueError, match="powers of 2"):
            fn(img, PyramidConfig(scales=(1, 2, 6)))


def test_gaussian_scale_space_and_gradient_methods():
    _, img = _images(45, 38, seed=7)
    sig = (0.8, 1.6, 3.2)
    want = jpyr.gaussian_scale_space(jnp.asarray(img), sig)
    got = tpyr.gaussian_scale_space(torch.from_numpy(img), sig)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-6, atol=1e-5)
    pyr = tpyr.pyramid_average(torch.from_numpy(img), PyramidConfig((1, 2)))
    jpyr_ = jpyr.pyramid_average(jnp.asarray(img), JPyramidConfig((1, 2)))
    for method in ("sobel", "three", "prewitt"):
        (tdx, tdy) = tpyr.gradient(pyr, method=method)
        (jdx, jdy) = jpyr.gradient(jpyr_, method=method)
        for a, b in zip(tdx + tdy, jdx + jdy):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-2)
    with pytest.raises(KeyError):
        tpyr.gradient(pyr, method="scharr")


def _corner_scene(h=47, w=61, seed=8):
    """Integer-valued bright and dark squares on a noisy background."""
    rng = np.random.default_rng(seed)
    img = rng.integers(60, 68, (h, w)).astype(np.float32)
    img[8:20, 10:25] = 200
    img[28:40, 30:45] = 10
    img[0:6, 50:61] = 180               # a square cut by the border
    return img


@pytest.mark.parametrize("tol,run", [(20.0, 9), (15.0, 12), (30.0, 9)])
def test_fast(tol, run):
    img = _corner_scene()
    wi, wc = jint.fast(jnp.asarray(img), tol, run)
    gi, gc = tint.fast(torch.from_numpy(img), tol, run)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    if run == 9:
        assert gc.numpy()[8:20, 10:25].sum() >= 4     # the square's corners


@pytest.mark.parametrize("weighted", (False, True))
def test_structure_tensor_detectors(weighted):
    for exact, img in ((True, _corner_scene()),
                       (False, _images(47, 61, seed=9)[1])):
        for name, kw in (("harris", {"kappa": 0.05}), ("shi_tomasi", {})):
            want = np.asarray(getattr(jint, name)(
                jnp.asarray(img), radius=2, weighted=weighted, **kw))
            got = getattr(tint, name)(torch.from_numpy(img), radius=2,
                                      weighted=weighted, **kw).numpy()
            scale = np.abs(want).max()
            tol = 1e-5 if (exact and not weighted) else 1e-4
            np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_blob_and_median_intensities():
    for img in (_corner_scene(), _images(47, 61, seed=10)[1]):
        for name in ("kitros", "hessian_det", "hessian_trace",
                     "median_intensity"):
            want = np.asarray(getattr(jint, name)(jnp.asarray(img)))
            got = getattr(tint, name)(torch.from_numpy(img)).numpy()
            scale = max(np.abs(want).max(), 1.0)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    img = _corner_scene()
    np.testing.assert_array_equal(
        tint.median_intensity(torch.from_numpy(img), radius=1).numpy(),
        np.asarray(jint.median_intensity(jnp.asarray(img), radius=1)))


def _make_scene(rng, n, noise=0.0):
    """tests/test_geo.py's make_scene: points and the second camera."""
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    rng.uniform(2, 5, n)], axis=1)
    w = rng.normal(0, 0.05, 3)
    R = np.asarray(jse3.exp_so3(jnp.asarray(w)))
    t = np.array([0.3, -0.1, 0.05])
    p1 = pts[:, :2] / pts[:, 2:3]
    pc2 = pts @ R.T + t
    p2 = pc2[:, :2] / pc2[:, 2:3]
    if noise:
        p1 = p1 + rng.normal(0, noise, p1.shape)
        p2 = p2 + rng.normal(0, noise, p2.shape)
    return pts, R, t, p1, p2


def _same_pose(got, want, tol):
    (Rg, tg), (Rw, tw) = got, want
    np.testing.assert_allclose(Rg.numpy(), np.asarray(Rw), rtol=0, atol=tol)
    np.testing.assert_allclose(tg.numpy(), np.asarray(tw), rtol=0, atol=tol)


def test_absolute_orientation_batched():
    rng = np.random.default_rng(12)
    world = rng.normal(0, 1, (4, 20, 3))
    w = rng.normal(0, 0.5, (4, 3))
    R = np.asarray(jse3.exp_so3(jnp.asarray(w)))
    t = rng.normal(0, 1, (4, 3))
    cam = np.einsum("bij,bnj->bni", R, world) + t[:, None] \
        + rng.normal(0, 1e-3, (4, 20, 3))
    want = jpnp.absolute_orientation(jnp.asarray(world), jnp.asarray(cam))
    got = tpnp.absolute_orientation(torch.from_numpy(world),
                                    torch.from_numpy(cam))
    _same_pose(got, want, 1e-10)
    assert np.abs(got[0].numpy() - R).max() < 1e-3
    # float32 as the RANSAC hypotheses use it
    got32 = tpnp.absolute_orientation(torch.from_numpy(world),
                                      torch.from_numpy(cam), torch.float32)
    assert got32[0].dtype == torch.float32
    assert np.abs(got32[0].numpy() - R).max() < 1e-3


def test_pnp_dlt():
    """tests/test_geo.py:146's scene (seed 9, 30 points, noise 1e-4)."""
    rng = np.random.default_rng(9)
    pts, R, t, _, p2 = _make_scene(rng, 30, noise=1e-4)
    want = jpnp.pnp_dlt(jnp.asarray(pts), jnp.asarray(p2))
    got = tpnp.pnp_dlt(torch.from_numpy(pts), torch.from_numpy(p2))
    _same_pose(got, want, 1e-6)
    assert np.abs(got[0].numpy() - R).max() < 5e-3
    # batched, with the second problem's points mirrored through the camera
    # plane would flip the sign: stack two copies instead
    gotb = tpnp.pnp_dlt(torch.from_numpy(np.stack([pts, pts])),
                        torch.from_numpy(np.stack([p2, p2])))
    np.testing.assert_allclose(gotb[0][1].numpy(), got[0].numpy(),
                               rtol=0, atol=1e-9)


def test_pnp_planar():
    """tests/test_geo.py:263's scene."""
    rng = np.random.default_rng(5)
    world_xy = rng.uniform(-1, 1, (24, 2))
    Rgt = np.asarray(jse3.exp_so3(jnp.asarray([0.2, -0.3, 0.1])))
    tgt = np.array([0.1, -0.2, 3.0])
    w3 = np.concatenate([world_xy, np.zeros((24, 1))], 1)
    Xc = w3 @ Rgt.T + tgt
    obs = Xc[:, :2] / Xc[:, 2:]
    want = jpnp.pnp_planar(jnp.asarray(world_xy), jnp.asarray(obs))
    got = tpnp.pnp_planar(torch.from_numpy(world_xy), torch.from_numpy(obs))
    _same_pose(got, want, 1e-8)
    assert np.abs(got[0].numpy() - Rgt).max() < 1e-8
    assert np.abs(got[1].numpy() - tgt).max() < 1e-8


@pytest.mark.parametrize("refine", (10, 0))
def test_epnp(refine):
    """tests/test_geo.py:277's scene, with and without the GN polish."""
    rng = np.random.default_rng(6)
    world = np.concatenate([rng.uniform(-2, 2, (40, 2)),
                            rng.uniform(3, 9, (40, 1))], 1)
    Rgt = np.asarray(jse3.exp_so3(jnp.asarray([0.3, -0.2, 0.15])))
    tgt = np.array([0.2, -0.4, 1.0])
    Xc = world @ Rgt.T + tgt
    obs = Xc[:, :2] / Xc[:, 2:]
    want = jpnp.epnp(jnp.asarray(world), jnp.asarray(obs),
                     refine_iterations=refine)
    got = tpnp.epnp(torch.from_numpy(world), torch.from_numpy(obs),
                    refine_iterations=refine)
    _same_pose(got, want, 1e-8 if refine else 1e-6)
    bar = 1e-8 if refine else 1e-2
    assert np.abs(got[0].numpy() - Rgt).max() < bar
    if refine:
        assert np.abs(got[1].numpy() - tgt).max() < 1e-8


def test_epnp_noisy_pose_matches_reference():
    rng = np.random.default_rng(13)
    world = np.concatenate([rng.uniform(-2, 2, (64, 2)),
                            rng.uniform(3, 9, (64, 1))], 1)
    Rgt = np.asarray(jse3.exp_so3(jnp.asarray([-0.1, 0.25, 0.05])))
    tgt = np.array([-0.3, 0.1, 0.5])
    Xc = world @ Rgt.T + tgt
    obs = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 1e-3, (64, 2))
    want = jpnp.epnp(jnp.asarray(world), jnp.asarray(obs))
    got = tpnp.epnp(torch.from_numpy(world), torch.from_numpy(obs))
    _same_pose(got, want, 1e-8)
    assert np.abs(got[0].numpy() - Rgt).max() < 1e-2


def test_checker_texture_equal():
    want = jsim.checker_texture(np.random.default_rng(14), size=96,
                                square=12, noise=8.0)
    got = tsim.checker_texture(np.random.default_rng(14), size=96,
                               square=12, noise=8.0)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
