"""Image warps, spherical (360) transforms and point clouds of the port
against the JAX package on the same seeded numpy inputs, and the
equirectangular example.

Tolerances: affine and projective float32 warp grids within 1e-4 px and
the warped images within 1e-3 grey levels (values 0-255); nearest sampling
exact.  The spherical maps go through float32 sin, cos, atan2 and asin,
which differ by an ulp or two between XLA and PyTorch: their grids agree
to 1e-4 relative, and images warped by them (smooth textures, gradients
below 10 grey levels a pixel) to 1e-2.  Float64 point maps within 1e-9
px; neighbour indices as
sets per query (``lax.top_k`` and ``torch.topk`` may order ties
differently), their distances within 1e-4; masks and voxel samples
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boofcv_tpu.geo import cameras as jcam
from boofcv_tpu.geo import cloud as jcloud
from boofcv_tpu.geo import spherical as jsph
from boofcv_tpu.ip import distort as jdist
from boofcv_tpu.ip import interpolate as jinterp
from boofcv_tpu_torch.geo import cameras as tcam
from boofcv_tpu_torch.geo import cloud as tcloud
from boofcv_tpu_torch.geo import spherical as tsph
from boofcv_tpu_torch.ip import distort as tdist
from boofcv_tpu_torch.ip import interpolate as tinterp

torch.set_num_threads(1)
A = np.asarray
T = torch.from_numpy


def _close(ref, out, atol):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)


def _image(rng, h=48, w=64, channels=None):
    shape = (h, w) if channels is None else (h, w, channels)
    return rng.uniform(0, 255, shape).astype(np.float32)


# ---------------- interpolate.nearest and ip/distort --------------------

def test_nearest_matches_jax():
    rng = np.random.default_rng(0)
    img = _image(rng)
    ys = rng.uniform(-3, 51, (7, 9)).astype(np.float32)
    xs = rng.uniform(-3, 67, (7, 9)).astype(np.float32)
    ys[0, :4] = [0.5, 1.5, 2.5, -0.5]            # halves round to even
    ref = A(jinterp.nearest(jnp.asarray(img), jnp.asarray(ys),
                            jnp.asarray(xs)))
    out = tinterp.nearest(T(img), T(ys), T(xs))
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("channels", [None, 3])
def test_warp_matches_jax(method, channels):
    rng = np.random.default_rng(1)
    img = _image(rng, channels=channels)
    tf = lambda xs, ys: (0.9 * xs + 0.1 * ys - 3.0, -0.05 * xs + 1.1 * ys + 2.0)
    jmy, jmx = jdist.make_warp_grid(tf, 40, 70)
    tmy, tmx = tdist.make_warp_grid(tf, 40, 70, device="cpu")
    _close(jmy, tmy, 1e-4)
    _close(jmx, tmx, 1e-4)
    ref = jdist.warp(jnp.asarray(img), jmy, jmx, method, fill_value=-1.0)
    out = tdist.warp(T(img), tmy, tmx, method, fill_value=-1.0)
    _close(ref, out, 1e-3)
    with pytest.raises(ValueError):
        tdist.warp(T(img), tmy, tmx, "bicubic")


def test_warp_affine_homography_scale_rotate_match_jax():
    rng = np.random.default_rng(2)
    img = _image(rng)
    jimg, timg = jnp.asarray(img), T(img)
    _close(jdist.warp_affine(jimg, 0.95, 0.1, -0.08, 1.02, 3.5, -2.0,
                             out_shape=(50, 60)),
           tdist.warp_affine(timg, 0.95, 0.1, -0.08, 1.02, 3.5, -2.0,
                             out_shape=(50, 60)), 1e-3)
    Hm = np.array([[1.02, 0.03, -4.0], [-0.02, 0.98, 3.0], [1e-4, -2e-4, 1.0]])
    _close(jdist.warp_homography(jimg, Hm, method="nearest"),
           tdist.warp_homography(timg, Hm, method="nearest"), 1e-3)
    _close(jdist.warp_homography(jimg, Hm), tdist.warp_homography(timg, Hm),
           1e-3)
    for shape in ((96, 128), (20, 30)):
        _close(jdist.scale(jimg, shape), tdist.scale(timg, shape), 1e-3)
    _close(jdist.rotate(jimg, 0.3), tdist.rotate(timg, 0.3), 1e-3)
    _close(jdist.rotate(jimg, -1.1, out_shape=(64, 64), method="nearest"),
           tdist.rotate(timg, -1.1, out_shape=(64, 64), method="nearest"),
           1e-3)


# ---------------- spherical ---------------------------------------------

def _smooth_equi(h, w, seed=0):
    """``tests/test_spherical.py``'s test canvas."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 50 + 30 * np.sin(2 * np.pi * xx / w * 3) * np.cos(np.pi * yy / h)
    for _ in range(4):
        cy, cx = rng.uniform(h * 0.2, h * 0.8), rng.uniform(0, w)
        img += 60 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 200.0)
    return img.astype(np.float32)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _cams(kind):
    """The same camera in both packages."""
    kw = {"pinhole": dict(fx=150, fy=150, cx=79.5, cy=59.5, width=160,
                          height=120),
          "brown": dict(fx=150, fy=148, cx=80.5, cy=59.0, skew=0.3,
                        width=160, height=120, radial=(-0.2, 0.04),
                        t1=0.001, t2=-0.0005),
          "omni": dict(fx=130, fy=130, cx=149.5, cy=149.5, width=300,
                       height=300, mirror_offset=1.0)}[kind]
    cls = {"pinhole": "CameraPinhole", "brown": "CameraPinholeBrown",
           "omni": "CameraUniversalOmni"}[kind]
    return getattr(jcam, cls)(**kw), getattr(tcam, cls)(**kw)


def test_equi_unit_maps_match_jax():
    rng = np.random.default_rng(1)
    w, h = 256, 128
    x = rng.uniform(0, w, 500).astype(np.float32)
    y = rng.uniform(1, h - 2, 500).astype(np.float32)
    ref = A(jsph.equi_to_unit(jnp.asarray(x), jnp.asarray(y), w, h))
    out = tsph.equi_to_unit(T(x), T(y), w, h)
    _close(ref, out, 1e-6)
    for a, b in zip(jsph.unit_to_equi(jnp.asarray(ref), w, h),
                    tsph.unit_to_equi(T(ref), w, h)):
        _close(a, b, 1e-4)
    v = tsph.equi_to_unit(torch.tensor(128.0), torch.tensor(63.5), 256, 128)
    np.testing.assert_allclose(v.numpy(), [0, 0, 1], atol=1e-6)


def test_equi_rotate_matches_jax():
    img = _smooth_equi(96, 192)
    R = _rot_y(0.7) @ np.array([[1, 0, 0], [0, np.cos(0.3), -np.sin(0.3)],
                                [0, np.sin(0.3), np.cos(0.3)]])
    ref = A(jsph.equi_rotate(jnp.asarray(img), R))
    out = tsph.equi_rotate(T(img), R)
    _close(ref, out, 1e-2)
    back = tsph.equi_rotate(out, R.T).numpy()
    assert np.median(np.abs(img - back)[20:-20]) < 2.0


@pytest.mark.parametrize("kind", ["pinhole", "brown", "omni"])
def test_camera_to_equi_grid_matches_jax(kind):
    jc, tc = _cams(kind)
    R = _rot_y(0.4)
    for a, b in zip(jsph.camera_to_equi_grid(jc, R, (64, 128)),
                    tsph.camera_to_equi_grid(tc, R, (64, 128),
                                             device="cpu")):
        a, b = A(a), b.numpy()
        if a.dtype == bool:
            assert np.array_equal(a, b)
        else:
            # compare where the map lands near the image (far-off rays of
            # a nearly grazing direction amplify float32 rounding)
            near = np.abs(a) < 1e4
            np.testing.assert_allclose(b[near], a[near], rtol=1e-4,
                                       atol=1e-3)


def test_camera_to_equi_and_back_match_jax():
    jc, tc = _cams("pinhole")
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:120, 0:160].astype(np.float32)
    view = (60 + 40 * np.sin(xx / 11.0) * np.cos(yy / 7.0)
            + rng.normal(0, 0.1, (120, 160))).astype(np.float32)
    R = _rot_y(0.5)
    ref = A(jsph.camera_to_equi(jnp.asarray(view), jc, R, (256, 512)))
    out = tsph.camera_to_equi(T(view), tc, R, (256, 512))
    _close(ref, out, 1e-2)
    back_ref = A(jsph.equi_to_pinhole(jnp.asarray(ref), jc, R, (120, 160)))
    back = tsph.equi_to_pinhole(out, tc, R, (120, 160))
    _close(back_ref, back, 1e-2)
    assert np.median(np.abs(view - back.numpy())[20:-20, 20:-20]) < 2.5


@pytest.mark.parametrize("channels", [None, 3])
def test_multi_camera_to_equi_matches_jax(channels):
    jc, tc = _cams("pinhole")
    yy, xx = np.mgrid[0:120, 0:160].astype(np.float32)
    imgs = [60 + 40 * np.sin(xx / (9.0 + 4 * i)) * np.cos(yy / 7.0)
            for i in range(2)]
    if channels:
        imgs = [np.stack([im, 0.5 * im, 255 - im], -1) for im in imgs]
    Rs = [_rot_y(0.0), _rot_y(0.9)]
    ref = A(jsph.multi_camera_to_equi([jnp.asarray(i) for i in imgs],
                                      [jc, jc], Rs, (128, 256)))
    out = tsph.multi_camera_to_equi([T(i) for i in imgs], [tc, tc], Rs,
                                    (128, 256))
    _close(ref, out, 1e-2)
    # constant views blend to the constant (``tests/test_spherical.py``'s
    # wide camera)
    wide = tcam.CameraPinhole(fx=80, fy=80, cx=79.5, cy=59.5, width=160,
                              height=120)
    flat = [torch.full((120, 160), 100.0)] * 2
    c = tsph.multi_camera_to_equi(flat, [wide, wide], [_rot_y(0.0),
                                                       _rot_y(1.0)],
                                  (128, 256)).numpy()
    assert (c > 0).mean() > 0.15 and np.allclose(c[c > 50], 100.0, atol=1.0)


@pytest.mark.parametrize("rotated", [False, True])
def test_narrow_wide_maps_match_jax(rotated):
    kw_n = dict(fx=300, fy=300, cx=159.5, cy=119.5, width=320, height=240)
    kw_w = dict(fx=130, fy=130, cx=199.5, cy=199.5, width=400, height=400,
                mirror_offset=0.8)
    R = _rot_y(0.2) if rotated else None
    jn, tn = jcam.CameraPinhole(**kw_n), tcam.CameraPinhole(**kw_n)
    jw, tw = jcam.CameraUniversalOmni(**kw_w), tcam.CameraUniversalOmni(**kw_w)
    rng = np.random.default_rng(3)
    xs = rng.uniform(40, 280, 64)
    ys = rng.uniform(40, 200, 64)
    ref = jsph.narrow_to_wide(jn, jw, R)(jnp.asarray(xs), jnp.asarray(ys))
    out = tsph.narrow_to_wide(tn, tw, R)(T(xs), T(ys))
    for a, b in zip(ref, out):
        _close(a, b, 1e-9)
    back_ref = jsph.wide_to_narrow(jw, jn, R)(*ref)
    back = tsph.wide_to_narrow(tw, tn, R)(*out)
    for a, b in zip(back_ref, back):
        _close(a, b, 1e-9)
    np.testing.assert_allclose(back[0].numpy(), xs, atol=1e-2)
    np.testing.assert_allclose(back[1].numpy(), ys, atol=1e-2)


# ---------------- point clouds ------------------------------------------

def _cloud(rng, n=300):
    pts = rng.normal(0, 1, (n, 3))
    pts[:10] += rng.uniform(8, 12, (10, 3))          # far outliers
    return pts


@pytest.mark.parametrize("masked", [False, True])
def test_statistics_and_prune_match_jax(masked):
    rng = np.random.default_rng(0)
    pts = _cloud(rng)
    valid = rng.uniform(0, 1, len(pts)) > 0.2 if masked else None
    ref = jcloud.statistics(pts, None if valid is None else
                            jnp.asarray(valid))
    out = tcloud.statistics(pts, None if valid is None else T(valid),
                            device="cpu")
    for k in ("mean", "stdev", "min", "max"):
        _close(ref[k], out[k], 1e-12)
    assert int(out["count"]) == int(ref["count"])
    origin = np.array([0.5, 0.0, -0.2])
    r = jcloud.prune_far_points(pts, 2.0, origin,
                                None if valid is None else jnp.asarray(valid))
    o = tcloud.prune_far_points(pts, 2.0, origin,
                                None if valid is None else T(valid),
                                device="cpu")
    assert np.array_equal(A(r), o.numpy())
    assert np.array_equal(A(jcloud.prune_far_points(pts, 1.5)),
                          tcloud.prune_far_points(pts, 1.5,
                                                  device="cpu").numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_filter_radius_outliers_matches_jax(masked):
    rng = np.random.default_rng(1)
    pts = _cloud(rng)
    valid = rng.uniform(0, 1, len(pts)) > 0.1 if masked else None
    ref = A(jcloud.filter_radius_outliers(
        pts, 8, 2.0, None if valid is None else jnp.asarray(valid)))
    out = tcloud.filter_radius_outliers(pts, 8, 2.0,
                                        None if valid is None else T(valid),
                                        device="cpu").numpy()
    assert np.array_equal(ref, out)
    assert not out[:10].any() and out[10:].mean() > 0.9


@pytest.mark.parametrize("k", [1, 5])
def test_nearest_neighbors_match_jax_as_sets(k):
    rng = np.random.default_rng(2)
    pts = _cloud(rng, 400)
    # a grid holds exact ties in distance
    grid = np.stack(np.meshgrid(*(np.arange(4.0),) * 3), -1).reshape(-1, 3)
    pts = np.concatenate([pts, grid])
    queries = np.concatenate([rng.normal(0, 1, (50, 3)),
                              grid[:10] + 0.5])
    valid = rng.uniform(0, 1, len(pts)) > 0.1
    for vm in (None, valid):
        ri, rd = jcloud.nearest_neighbors(
            queries, pts, k, None if vm is None else jnp.asarray(vm))
        oi, od = tcloud.nearest_neighbors(
            queries, pts, k, None if vm is None else T(vm), device="cpu")
        ri, oi = A(ri), oi.numpy()
        _close(np.sort(A(rd), axis=1), np.sort(od.numpy(), axis=1), 1e-4)
        # index sets per query, but for a tie at the k-th distance
        kth = np.sort(A(rd), axis=1)[:, -1:]
        inner = A(rd) < kth - 1e-4
        for q in range(len(queries)):
            assert set(ri[q][inner[q]]) <= set(oi[q].tolist())
        if vm is not None:
            assert vm[oi].all()


def test_downsample_voxel_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2, 2, (500, 3))
    ref = jcloud.downsample_voxel(pts, 0.5)
    assert np.array_equal(tcloud.downsample_voxel(T(pts), 0.5), ref)
    assert np.array_equal(tcloud.downsample_voxel(pts, 0.5), ref)


# ---------------- entry point -------------------------------------------

def test_equirectangular_example_runs_on_the_cpu(capsys):
    from boofcv_tpu_torch.examples import equirectangular_views
    assert equirectangular_views.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "OK"


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcloud.statistics(np.zeros((4, 3)))
    with pytest.raises(RuntimeError, match="CUDA"):
        tdist.make_warp_grid(lambda x, y: (x, y), 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsph.camera_to_equi_grid(_cams("pinhole")[1], np.eye(3), (8, 16))
