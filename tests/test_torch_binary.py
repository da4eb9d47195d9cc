"""Pixel math, local statistics, thresholds, binary morphology, blob
labeling, the native contour tracer, shape fitting and ``refine_pnp``: the
port against the JAX package on the same seeded numpy inputs.

Tolerances: integer and binary outputs (histograms, thresholds' {0, 1}
images, morphology, labels, contours, Otsu's and the entropy threshold's
bin) are exact; elementwise float arithmetic that IEEE rounds (+ - * /
sqrt) is exact; transcendental functions and float reductions, whose
rounding or order differs between XLA and PyTorch, agree to 1e-6 relative
(float32) or 1e-12 (float64); local statistics through the separable
convolution to 2e-4 absolute on 0-255 images (float32 shifted adds against
XLA's convolution); shapes and ``refine_pnp`` (float64) to 1e-9.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu import native as jnative
from boofcv_tpu.feature import shapes as jshapes
from boofcv_tpu.geo import pnp as jpnp
from boofcv_tpu.geo import se3 as jse3
from boofcv_tpu.ip import binary as jb
from boofcv_tpu.ip import pixel_math as jpm
from boofcv_tpu.ip import stats as jstats
from boofcv_tpu.ip import threshold as jth
from boofcv_tpu_torch import native as tnative
from boofcv_tpu_torch.feature import shapes as tshapes
from boofcv_tpu_torch.geo import pnp as tpnp
from boofcv_tpu_torch.ip import binary as tb
from boofcv_tpu_torch.ip import pixel_math as tpm
from boofcv_tpu_torch.ip import stats as tstats
from boofcv_tpu_torch.ip import threshold as tth

torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gray(seed=0, h=48, w=64, integer=True):
    img = np.random.default_rng(seed).uniform(0, 255, (h, w))
    return (np.round(img) if integer else img).astype(np.float32)


def _binary(seed, h=40, w=57, density=0.4):
    return (np.random.default_rng(seed).random((h, w)) < density).astype(
        np.uint8)


def _donut():
    img = np.zeros((40, 40), np.uint8)
    yy, xx = np.mgrid[0:40, 0:40]
    r = np.hypot(yy - 20, xx - 20)
    img[(r < 15) & (r > 6)] = 1
    return img


def _two_holes():
    img = np.zeros((30, 60), np.uint8)
    img[2:28, 2:40] = 1
    img[8:13, 8:13] = 0       # hole A
    img[15:24, 20:33] = 0     # hole B
    img[5:25, 45:55] = 1      # second blob, solid
    return img


def _closed_random(seed):
    img = (np.random.default_rng(seed).random((48, 64)) < 0.55).astype(
        np.uint8)
    return np.array(jb.closing(jnp.asarray(img), eight=True))


# ---------------------------------------------------------------- pixel math

_A = _gray(1)
_B = _gray(2) + 1.0          # no zero divisors
_HWC = np.random.default_rng(3).uniform(0, 255, (12, 16, 3)).astype(
    np.float32)

# (name, args, exact): exact for IEEE-rounded elementwise arithmetic and
# integer-valued sums; 1e-6 relative for transcendental functions and
# float reductions in another order
PIXEL_CASES = [
    ("abs", (_A - 128,), True), ("negative", (_A,), True),
    ("invert", (_A,), True), ("divide", (_A, 3.0), True),
    ("multiply", (_A, 0.3), True), ("plus", (_A, 7.5), True),
    ("minus", (_A, 7.5), True), ("minus", (_A, 7.5, True), True),
    ("log", (_A,), False), ("log_sign", (_A - 128,), False),
    ("pow2", (_A,), True), ("sqrt", (_A,), True), ("add", (_A, _B), True),
    ("subtract", (_A, _B), True), ("multiply_images", (_A, _B), True),
    ("divide_images", (_A, _B), True), ("bound_image", (_A, 30, 200), True),
    ("diff_abs", (_A, _B), True), ("average_band", (_HWC,), False),
    ("stdev_band", (_HWC,), False), ("minimum_band", (_HWC,), True),
    ("maximum_band", (_HWC,), True), ("min", (_A,), True),
    ("max", (_A,), True), ("max_abs", (_A - 128,), True),
    ("sum", (_A,), True), ("mean", (_A,), True),
    ("variance", (_A,), False), ("variance", (_A, 100.0), False),
    ("mean_diff_sq", (_A, _B), False), ("mean_diff_abs", (_A, _B), True),
    ("fill", (_A, 3.25), True), ("flip_vertical", (_A,), True),
    ("flip_horizontal", (_A,), True), ("rotate_cw", (_A,), True),
    ("rotate_ccw", (_A,), True), ("transpose", (_A,), True),
    ("extract_band", (_HWC, 1), True),
    ("insert_band", (_HWC, 2, _HWC[..., 0]), True),
    ("normalize_max_abs", (_A - 128,), True),
    ("normalize_zero_mean_unit_var", (_A,), False),
    ("normalize_zero_mean_max_one", (_A,), False),
]


@pytest.mark.parametrize("name,args,exact", PIXEL_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(PIXEL_CASES)])
def test_pixel_math_matches_jax(name, args, exact):
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    targs = [torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a
             for a in args]
    want = np.asarray(getattr(jpm, name)(*jargs))
    got = _np(getattr(tpm, name)(*targs))
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lo,hi,bins", [(0.0, 255.0, 256), (0.0, 255.0, 10),
                                        (-50.0, 300.0, 37)])
def test_histogram_exact(lo, hi, bins):
    img = _gray(4, integer=False) * 1.3 - 40
    want = np.asarray(jpm.histogram(jnp.asarray(img), lo, hi, bins))
    got = tpm.histogram(torch.from_numpy(img), lo, hi, bins).numpy()
    np.testing.assert_array_equal(got, want)


def test_random_fills_by_their_statistics():
    """The fills draw from a generator where the reference takes a key:
    their values cannot agree, their distributions must."""
    import jax
    g = torch.Generator().manual_seed(0)
    n = (400, 500)
    u = tpm.fill_uniform(g, n, -3.0, 5.0).numpy()
    uj = np.asarray(jpm.fill_uniform(jax.random.PRNGKey(0), n, -3.0, 5.0))
    assert u.dtype == uj.dtype and u.min() >= -3.0 and u.max() < 5.0
    assert abs(u.mean() - 1.0) < 0.02 and abs(u.mean() - uj.mean()) < 0.03
    assert abs(u.std() - 8.0 / np.sqrt(12)) < 0.02
    ui = tpm.fill_uniform(g, n, 2, 9, dtype=torch.int32).numpy()
    assert ui.dtype == np.int32 and set(np.unique(ui)) == set(range(2, 9))
    gs = tpm.fill_gaussian(g, n, 100.0, 15.0, 0.0, 255.0).numpy()
    gj = np.asarray(jpm.fill_gaussian(jax.random.PRNGKey(1), n, 100.0, 15.0,
                                      0.0, 255.0))
    assert gs.dtype == gj.dtype
    assert abs(gs.mean() - 100.0) < 0.2 and abs(gs.std() - 15.0) < 0.2
    clipped = tpm.fill_gaussian(g, n, 0.0, 10.0, 0.0, 255.0).numpy()
    assert clipped.min() == 0.0 and abs((clipped == 0).mean() - 0.5) < 0.01
    img = np.full(n, 128.0, np.float32)
    noisy = tpm.add_gaussian_noise(g, torch.from_numpy(img), 6.0, 0.0,
                                   255.0).numpy()
    noisy_j = np.asarray(jpm.add_gaussian_noise(
        jax.random.PRNGKey(2), jnp.asarray(img), 6.0, 0.0, 255.0))
    assert noisy.dtype == noisy_j.dtype
    assert abs((noisy - img).std() - 6.0) < 0.05
    assert abs((noisy - img).mean()) < 0.05


# ------------------------------------------------------------ local stats

@pytest.mark.parametrize("radius,gaussian", [(1, False), (3, False),
                                             (4, True)])
def test_local_stats_match_jax(radius, gaussian):
    img = _gray(5)
    mj, sj = jstats.local_mean_std(jnp.asarray(img), radius, gaussian)
    mt, st = tstats.local_mean_std(torch.from_numpy(img), radius, gaussian)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=2e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-3)
    nj = jstats.local_normalize(jnp.asarray(img), radius, gaussian=gaussian)
    nt = tstats.local_normalize(torch.from_numpy(img), radius,
                                gaussian=gaussian)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-3,
                               atol=2e-3)


def test_global_normalizations_match_jax():
    img = _gray(6)
    for name, args in (("normalize_minmax", ()),
                       ("normalize_minmax", (-1.0, 2.0)),
                       ("normalize_zero_mean_unit_var", ())):
        want = np.asarray(getattr(jstats, name)(jnp.asarray(img), *args))
        got = getattr(tstats, name)(torch.from_numpy(img), *args).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------- thresholds

def _bimodal(seed=7):
    rng = np.random.default_rng(seed)
    img = np.where(rng.random((40, 50)) < 0.3, 60.0, 190.0)
    return (img + rng.normal(0, 12, img.shape)).astype(np.float32)


@pytest.mark.parametrize("img", [_gray(8), _gray(9, integer=False),
                                 _bimodal(), np.round(_bimodal(10)),
                                 np.where(_binary(11) > 0, 40.0, 200.0)
                                 .astype(np.float32)],
                         ids=["uniform", "uniform-float", "bimodal",
                              "bimodal-int", "two-level-plateau"])
def test_otsu_and_entropy_exact(img):
    for name, args in (("compute_otsu", ()), ("compute_entropy", ()),
                       ("compute_otsu", (float(img.min()),
                                         float(img.max()))),
                       ("compute_otsu", (0.0, 255.0, 64))):
        want = float(getattr(jth, name)(jnp.asarray(img), *args))
        got = getattr(tth, name)(torch.from_numpy(img), *args)
        assert got.dtype == torch.float64 and float(got) == want, name


def test_threshold_value_and_tensor_compare_as_jax():
    img = _bimodal(12)
    t = jth.compute_otsu(jnp.asarray(img))
    tt = tth.compute_otsu(torch.from_numpy(img))
    for down in (True, False):
        # a float64 array promotes the comparison; a Python float does not
        np.testing.assert_array_equal(
            tth.threshold(torch.from_numpy(img), tt, down).numpy(),
            np.asarray(jth.threshold(jnp.asarray(img), t, down)))
        np.testing.assert_array_equal(
            tth.threshold(torch.from_numpy(img), float(tt), down).numpy(),
            np.asarray(jth.threshold(jnp.asarray(img), float(t), down)))
    # the promotion matters where the float64 threshold rounds onto a pixel
    pix = np.float32(0.1)
    img = np.array([[pix]], np.float32)
    want = np.asarray(jth.threshold(jnp.asarray(img), jnp.float64(0.1)))
    got = tth.threshold(torch.from_numpy(img),
                        torch.tensor(0.1, dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0, 0] == 0


@pytest.mark.parametrize("name,kw", [
    ("local_mean", dict(radius=3)), ("local_mean", dict(radius=5,
                                                        scale=1.0)),
    ("local_gaussian", dict(radius=3)), ("sauvola", dict(radius=4)),
    ("nick", dict(radius=4)), ("block_min_max", dict(block_size=7)),
    ("block_min_max", dict(block_size=16, min_spread=40.0))])
@pytest.mark.parametrize("down", [True, False])
def test_local_thresholds_exact(name, kw, down):
    for img in (_gray(13), _bimodal(14)):
        want = np.asarray(getattr(jth, name)(jnp.asarray(img), down=down,
                                             **kw))
        got = getattr(tth, name)(torch.from_numpy(img), down=down,
                                 **kw).numpy()
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- morphology

MORPH = ["erode4", "erode8", "dilate4", "dilate8", "edge4", "edge8",
         "remove_point_noise"]


@pytest.mark.parametrize("name", MORPH)
def test_morphology_exact(name):
    for seed, density in ((20, 0.3), (21, 0.5), (22, 0.7)):
        img = _binary(seed, density=density)
        want = np.asarray(getattr(jb, name)(jnp.asarray(img)))
        got = getattr(tb, name)(torch.from_numpy(img)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if name.startswith("edge"):
        img = _binary(23, density=0.6)
        np.testing.assert_array_equal(
            getattr(tb, name)(torch.from_numpy(img), False).numpy(),
            np.asarray(getattr(jb, name)(jnp.asarray(img), False)))


@pytest.mark.parametrize("op", ["opening", "closing"])
@pytest.mark.parametrize("eight,times", [(False, 1), (True, 1), (True, 2)])
def test_opening_closing_exact(op, eight, times):
    img = _binary(24, density=0.55)
    want = np.asarray(getattr(jb, op)(jnp.asarray(img), eight, times))
    got = getattr(tb, op)(torch.from_numpy(img), eight, times).numpy()
    np.testing.assert_array_equal(got, want)


def _thin_scenes():
    bar = np.zeros((32, 64), np.uint8)
    bar[12:19, 8:56] = 1
    line = np.zeros((20, 40), np.uint8)
    line[10, 5:35] = 1
    cross = np.zeros((50, 50), np.uint8)
    cross[22:29, 5:45] = 1
    cross[5:45, 22:29] = 1
    return {"bar": bar, "line": line, "cross": cross, "donut": _donut(),
            "blobs": _closed_random(25)}


@pytest.mark.parametrize("scene", ["bar", "line", "cross", "donut", "blobs"])
def test_thin_exact(scene):
    img = _thin_scenes()[scene]
    for max_iters in (-1, 1, 2, 3, 7):
        want = np.asarray(jb.thin(jnp.asarray(img), max_iters))
        got = tb.thin(torch.from_numpy(img), max_iters).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("eight", [True, False])
def test_label_blobs_exact_and_capped(eight):
    for seed in (30, 31):
        img = _binary(seed, density=0.45)
        for max_iters in (0, 1, 2, 5, 16, 17, 40):
            want = np.asarray(jb.label_blobs(jnp.asarray(img), eight,
                                             max_iters))
            got = tb.label_blobs(torch.from_numpy(img), eight,
                                 max_iters).numpy()
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)


def test_label_blobs_long_snake_reaches_the_fixpoint(monkeypatch):
    """A snake whose labels need hundreds of sweeps: every CHECK_EVERY
    (including 1, the reference's loop) gives the reference's labels."""
    img = np.zeros((40, 41), np.uint8)
    img[1:-1:4, 1:-1] = 1
    for k, r in enumerate(range(1, 37, 4)):
        col = 39 if k % 2 == 0 else 1
        img[r:r + 5, col] = 1
    want = np.asarray(jb.label_blobs(jnp.asarray(img)))
    for every in (1, 7, 16, 64):
        monkeypatch.setattr(tb, "CHECK_EVERY", every)
        np.testing.assert_array_equal(
            tb.label_blobs(torch.from_numpy(img)).numpy(), want)
    assert len(np.unique(want)) == 2


def test_relabel_compact_and_host_ccl():
    for seed in (32, 33):
        img = _binary(seed, density=0.4)
        lab_j = np.asarray(jb.label_blobs(jnp.asarray(img)))
        want = jb.relabel_compact(lab_j)
        np.testing.assert_array_equal(tb.relabel_compact(lab_j), want)
        np.testing.assert_array_equal(
            tb.relabel_compact(tb.label_blobs(torch.from_numpy(img))), want)
        for eight in (True, False):
            lab, n = tb.label_blobs_host(img, eight)
            want8 = jb.relabel_compact(jb.label_blobs(jnp.asarray(img),
                                                      eight))
            np.testing.assert_array_equal(lab, want8)
            assert n == int(want8.max())
    empty = np.zeros((5, 6), np.int32)
    np.testing.assert_array_equal(tb.relabel_compact(empty), empty)


# ------------------------------------------------------------------ native

def test_native_source_is_the_references():
    """Below its header the port's ccl.cpp is the reference's source."""
    def body(path):
        text = open(path).read()
        return text[text.index("#include"):]
    assert body(tnative.SOURCE) == body(jnative._SRC)


def test_native_build_raises_on_failure(tmp_path, monkeypatch):
    bad = tmp_path / "ccl.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative._build()


@pytest.mark.parametrize("eight", [True, False])
def test_native_ccl_matches_label_propagation(eight):
    for trial in range(3):
        img = _binary(40 + trial, density=0.3 + 0.1 * trial)
        lab, n = tnative.ccl(img, eight=eight)
        want = jb.relabel_compact(jb.label_blobs(jnp.asarray(img), eight))
        np.testing.assert_array_equal(lab, want)
        np.testing.assert_array_equal(
            lab, tb.relabel_compact(tb.label_blobs(torch.from_numpy(img),
                                                   eight)))
        assert n == int(want.max())


def _same_contours(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["label"] == w["label"]
        assert (g["external"] is None) == (w["external"] is None)
        if g["external"] is not None:
            np.testing.assert_array_equal(g["external"], w["external"])
        assert len(g["internal"]) == len(w["internal"])
        for a, b in zip(g["internal"], w["internal"]):
            np.testing.assert_array_equal(a, b)


CONTOUR_SCENES = {"donut": _donut, "two_holes": _two_holes,
                  "closed_random": lambda: _closed_random(50),
                  "sparse": lambda: _binary(51, 31, 44, 0.15),
                  "dense": lambda: _binary(52, 31, 44, 0.6)}


@pytest.mark.parametrize("scene", list(CONTOUR_SCENES))
def test_native_contours_match_python_tracer_and_jax(scene):
    img = CONTOUR_SCENES[scene]()
    got = tb.contours_with_holes(img)
    _same_contours(got, tb.contours_with_holes_reference(img))
    _same_contours(got, jb.contours_with_holes(img))
    ext = tb.contour_external(img)
    want = jb.contour_external(img)
    assert len(ext) == len(want)
    for a, b in zip(ext, want):
        np.testing.assert_array_equal(a, b)
    for label in (1, len(got), len(got) + 1, 0):
        jl, tl = jb.contour_external(img, label), tb.contour_external(img,
                                                                      label)
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            np.testing.assert_array_equal(a, b)


def test_native_contour_scenes_shape():
    """The JAX tests' structure checks, on the port: one hole in the
    donut, two holes in the first blob of the second scene."""
    res = tb.contours_with_holes(_donut())
    assert len(res) == 1 and len(res[0]["internal"]) == 1
    res = tb.contours_with_holes(_two_holes())
    assert sorted(len(b["internal"]) for b in res) == [0, 2]
    img = np.zeros((10, 12), np.uint8)
    img[2:7, 3:9] = 1
    (c,) = tb.contour_external(img)
    assert c[0].tolist() == [3, 2]


def test_native_external_contours_binding():
    img = _two_holes()
    got = tnative.external_contours(img)
    want = jnative.external_contours(img)
    assert len(got) == len(want) == 4      # the raw scan walks each hole
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ shapes

def _rect_contour():
    img = np.zeros((40, 60), np.uint8)
    img[8:30, 10:50] = 1
    return tb.contour_external(img)[0]


def _triangle_contour():
    img = np.zeros((60, 60), np.uint8)
    for y in range(10, 50):
        half = (y - 10)
        img[y, 30 - half // 2: 30 + half // 2 + 1] = 1
    return tb.contour_external(img)[0]


@pytest.mark.parametrize("scene,sides,tol", [
    ("rect", 4, 2.0), ("rect", None, 1.0), ("triangle", 3, 2.0),
    ("triangle", None, 2.0), ("donut", 6, 2.0)])
def test_shapes_polygon_fits_match_jax(scene, sides, tol):
    cont = {"rect": _rect_contour, "triangle": _triangle_contour,
            "donut": lambda: tb.contour_external(_donut())[0]}[scene]()
    np.testing.assert_array_equal(tshapes.fit_polyline(cont, tol),
                                  jshapes.fit_polyline(cont, tol))
    np.testing.assert_array_equal(
        tshapes.fit_polyline(cont, tol, closed=False),
        jshapes.fit_polyline(cont, tol, closed=False))
    got = tshapes.fit_polygon(cont, sides, tol)
    want = jshapes.fit_polygon(cont, sides, tol)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert tshapes.polygon_is_convex(got) == jshapes.polygon_is_convex(want)


@pytest.mark.parametrize("a,b,phi,noise", [(12.0, 7.0, 0.4, 0.0),
                                           (20.0, 19.0, 2.0, 0.05),
                                           (9.0, 3.0, -0.7, 0.1)])
def test_fit_ellipse_matches_jax(a, b, phi, noise):
    t = np.linspace(0, 2 * np.pi, 100, endpoint=False)
    x = 31 + a * np.cos(t) * np.cos(phi) - b * np.sin(t) * np.sin(phi)
    y = 27 + a * np.cos(t) * np.sin(phi) + b * np.sin(t) * np.cos(phi)
    pts = np.stack([x, y], 1) + np.random.default_rng(60).normal(
        0, noise, (100, 2))
    got, want = tshapes.fit_ellipse(pts), jshapes.fit_ellipse(pts)
    for k in ("a", "b", "phi"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["center"], want["center"], atol=1e-9)
    line = np.stack([np.arange(10.0), 2 * np.arange(10.0)], 1)
    assert (tshapes.fit_ellipse(line + 1e-3) is None) == \
        (jshapes.fit_ellipse(line + 1e-3) is None)


def test_polygon_is_convex_matches_jax():
    for poly in ([[0, 0], [4, 0], [4, 3], [0, 3]],
                 [[0, 0], [4, 0], [1, 1], [0, 3]],
                 [[0, 0], [2, 0], [4, 0], [4, 3]]):
        assert tshapes.polygon_is_convex(np.array(poly, float)) == \
            jshapes.polygon_is_convex(np.array(poly, float))


# -------------------------------------------------------------- refine_pnp

@pytest.mark.parametrize("noise,iterations", [(0.0, 10), (1e-3, 15),
                                              (5e-3, 10)])
def test_refine_pnp_matches_jax(noise, iterations):
    rng = np.random.default_rng(70)
    world = np.c_[rng.uniform(-1, 1, (30, 2)), rng.uniform(-0.2, 0.2, 30)]
    R = np.asarray(jse3.exp_so3(jnp.asarray([0.1, -0.2, 0.05])))
    t = np.array([0.1, -0.05, 4.0])
    cam = world @ R.T + t
    obs = cam[:, :2] / cam[:, 2:] + rng.normal(0, noise, (30, 2))
    R0 = np.asarray(jse3.exp_so3(jnp.asarray([0.12, -0.17, 0.08])))
    t0 = t + np.array([0.05, 0.02, -0.2])
    Rj, tj = jpnp.refine_pnp(jnp.asarray(R0), jnp.asarray(t0),
                             jnp.asarray(world), jnp.asarray(obs),
                             iterations=iterations)
    T = lambda a: torch.from_numpy(np.array(a, np.float64))
    Rt, tt = tpnp.refine_pnp(T(R0), T(t0), T(world), T(obs),
                             iterations=iterations)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-9)


# ------------------------------------------------------------- import scan

def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port, the new recognition path included, loads
    in a fresh interpreter without JAX or the JAX package; ``chip_smoke.py``
    imports neither (its import statements, read with ``ast``)."""
    import ast
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import pkgutil, sys, importlib, boofcv_tpu_torch\n"
        "for m in pkgutil.walk_packages(boofcv_tpu_torch.__path__, "
        "'boofcv_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "need = {'boofcv_tpu_torch.native', 'boofcv_tpu_torch.ip.binary', "
        "'boofcv_tpu_torch.recognition.calib_targets', "
        "'boofcv_tpu_torch.recognition.qr.detector', "
        "'boofcv_tpu_torch.examples.pose_of_calibration_target'}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'boofcv_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    tree = ast.parse(open(os.path.join(root, "chip_smoke.py")).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "boofcv_tpu")]
