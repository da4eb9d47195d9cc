"""Chessboard, square-grid and circle-grid calibration targets: the port
against the JAX package on the scenes of ``tests/test_chessboard_auto.py``,
``tests/test_shapes_chessboard.py`` and ``tests/test_calib_targets.py``,
and the slice whole: rendered target views -> detection ->
``calibrate_mono_planar`` in both packages.

Tolerances: lattices (shapes, masks, which corner lands in which cell) are
exact.  Chessboard corners agree to 1e-3 px: the x-corner response is a
float32 blur and ring stencil whose rounding differs between XLA's
convolution and the port's shifted adds (measured 1.5e-5 px), and
``torch.topk`` orders ties otherwise, so detections compare as sets.
Square and circle corners (float64 fits of identical contours) to 1e-6
px; the calibrated K to 1e-6 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.calib import zhang99 as jz
from boofcv_tpu.geo import epipolar as jepi
from boofcv_tpu.geo import se3 as jse3
from boofcv_tpu.recognition import calib_targets as jct
from boofcv_tpu.recognition import chessboard as jcb
from boofcv_tpu_torch.calib import zhang99 as tz
from boofcv_tpu_torch.recognition import calib_targets as tct
from boofcv_tpu_torch.recognition import chessboard as tcb
from test_calib_targets import (_apply_h, _oblique_h, _render_square_grid_h,
                                _tilt_homography, _warp_target,
                                render_circles, render_square_grid)
from test_chessboard_auto import render_board
from test_shapes_chessboard import make_chessboard_image

torch.set_num_threads(1)
CPU = "cpu"


def _same(got, want, atol):
    """Equal structure (None, tuples, dicts, arrays); float values within
    ``atol``, integer and bool values exact."""
    if want is None or got is None:
        assert got is None and want is None
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, atol)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k], atol)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)


# --------------------------------------------------------------- chessboard

def _frontal():
    return render_board(np.array([[30.0, 0, 60], [0, 30.0, 40],
                                  [0, 0, 1.0]]))


def _oblique45():
    sx, sy = 6, 5
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1.0]])
    R = np.asarray(jse3.exp_so3(jnp.asarray([0.9, 0.05, 0.02])))
    t = np.array([-2.4, -1.0, 6.5])
    board = np.array([[0, 0], [sx, 0], [sx, sy], [0, sy]], float)
    pc = np.c_[board, np.zeros(4)] @ R.T + t
    pr = (pc / pc[:, 2:]) @ K.T
    Hm = np.asarray(jepi.homography_dlt(jnp.asarray(board[None]),
                                        jnp.asarray(pr[None, :, :2])))[0]
    return render_board(Hm, sx, sy)


def _occluded():
    img, gt = render_board(np.array([[28.0, 3.0, 70], [2.0, 29.0, 50],
                                     [1e-4, 0, 1.0]]))
    cx, cy = gt[1, 1]
    yy, xx = np.mgrid[0:img.shape[0], 0:img.shape[1]]
    img = np.where((yy - cy) ** 2 + (xx - cx) ** 2 < 18 ** 2, 128.0, img)
    keep = np.hypot(gt[..., 0] - cx, gt[..., 1] - cy) > 20
    return img.astype(np.float32), gt[keep]


def _small():
    img, gt = make_chessboard_image(4, 5)
    return img, gt - 0.5


# (image, [..., 2] inner corners (x, y) in pixel-centre coordinates)
BOARDS = {"frontal": _frontal, "oblique45": _oblique45,
          "occluded": _occluded, "small": _small}


@pytest.mark.parametrize("board", list(BOARDS))
def test_xcorner_intensity_and_corners_match_jax(board):
    img, gt = BOARDS[board]()
    gt = gt.reshape(-1, 2)
    want = np.asarray(jcb.xcorner_intensity(img))
    got = tcb.xcorner_intensity(img, device=CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())
    # room for every peak above the threshold.  The board's corners agree
    # to 1e-3 px; which of the weak or aliased peaks survive (ties on a
    # plateau, the 0.1 threshold) turns on the last bit of the response
    ys, xs, valid = tcb.detect_corners(img, 300, device=CPU)
    jys, jxs, jvalid = jcb.detect_corners(img, 300)
    assert valid.sum() < 300

    def at_corners(ys, xs, valid):
        p = np.stack([xs[valid], ys[valid]], 1)
        d = np.linalg.norm(p[None] - gt[:, None], axis=-1)     # [G, P]
        assert d.min(1).max() < 1.5                # every corner found
        return p[d.argmin(1)]
    np.testing.assert_allclose(at_corners(ys, xs, valid),
                               at_corners(jys, jxs, jvalid), rtol=0,
                               atol=1e-3)
    # the ring validation on the same corners
    np.testing.assert_array_equal(
        tcb.validate_xcorners(img, jys[jvalid], jxs[jvalid], device=CPU),
        jcb.validate_xcorners(img, jys[jvalid], jxs[jvalid]))


@pytest.mark.parametrize("board", ["frontal", "oblique45", "occluded"])
def test_chessboard_auto_matches_jax(board):
    img, _ = BOARDS[board]()
    got = tcb.detect_chessboard_auto(img, device=CPU)
    want = jcb.detect_chessboard_auto(img)
    assert want is not None
    _same(got, want, 1e-3)


@pytest.mark.parametrize("board,rows,cols", [("small", 4, 5),
                                             ("frontal", 4, 5),
                                             ("small", 5, 5)])
def test_chessboard_known_size_matches_jax(board, rows, cols):
    img, _ = BOARDS[board]()
    got = tcb.detect_chessboard(img, rows, cols, device=CPU)
    _same(got, jcb.detect_chessboard(img, rows, cols), 1e-3)
    ys, xs, valid = jcb.detect_corners(img, rows * cols)
    _same(tcb.assemble_grid(ys, xs, valid, rows, cols, device=CPU),
          jcb.assemble_grid(ys, xs, valid, rows, cols), 1e-9)


def test_hull_and_edge_validator_match_jax():
    img, _ = _oblique45()
    ys, xs, valid = jcb.detect_corners(img, 300)
    pts = np.stack([xs[valid], ys[valid]], 1).astype(np.float64)
    np.testing.assert_array_equal(tcb._convex_hull(pts),
                                  jcb._convex_hull(pts))
    i, j = np.triu_indices(len(pts), 1)
    np.testing.assert_array_equal(
        tcb._edge_is_lattice(img, pts[i], pts[j], device=CPU),
        jcb._edge_is_lattice(img, pts[i], pts[j]))


def test_chessboard_views_to_zhang99():
    """``tests/test_chessboard_auto.py``'s end-to-end bar on the port: five
    views (one ~48 degrees, one with ~10 % of the corners occluded), the
    connectivity assembly, masked Zhang99; the lattices equal the JAX
    package's and K agrees with its calibration."""
    sx, sy, sq = 7, 5, 0.04
    W, H, f = 320, 240, 300.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    views = [((0.3, 0.05, 0.02), (-0.13, -0.09, 0.42)),
             ((0.82, 0.1, 0.05), (-0.11, -0.11, 0.46)),
             ((-0.35, 0.3, -0.04), (-0.15, -0.07, 0.40)),
             ((0.1, -0.75, 0.1), (-0.10, -0.10, 0.44)),
             ((0.45, 0.45, 0.2), (-0.14, -0.08, 0.43))]
    world = np.stack(np.meshgrid(np.arange(1, sx), np.arange(1, sy)),
                     -1).reshape(-1, 2).astype(float) * sq
    n = world.shape[0]
    obs = np.zeros((len(views), n, 2))
    mask = np.zeros((len(views), n), bool)
    for vi, (w, t) in enumerate(views):
        R = np.asarray(jse3.exp_so3(jnp.asarray(w)))
        Hm = K @ np.stack([R[:, 0] * sq, R[:, 1] * sq, np.asarray(t)], 1)
        img, gt = render_board(Hm, sx, sy, height=H, width=W)
        if vi == 1:
            cx_, cy_ = gt[1, 2]
            yy, xx = np.mgrid[0:H, 0:W]
            img = np.where((yy - cy_) ** 2 + (xx - cx_) ** 2 < 15 ** 2,
                           128.0, img).astype(np.float32)
        out = tcb.detect_chessboard_auto(img, device=CPU)
        _same(out, jcb.detect_chessboard_auto(img), 1e-3)
        grid, gmask = out
        if grid.shape[:2] == (sx - 1, sy - 1):
            grid = np.transpose(grid[:, ::-1], (1, 0, 2))
            gmask = gmask[:, ::-1].T
        flat, fm, gtf = grid.reshape(-1, 2), gmask.ravel(), gt.reshape(-1, 2)
        for k in np.nonzero(fm)[0]:
            d = np.linalg.norm(gtf - flat[k], axis=1)
            j = int(np.argmin(d))
            if d[j] < 2.0:
                obs[vi, j] = flat[k]
                mask[vi, j] = True
        assert mask[vi].sum() >= (0.85 if vi == 1 else 0.95) * n
    res = tz.calibrate_mono_planar(world, obs, obs_mask=mask, device=CPU)
    ref = jz.calibrate_mono_planar(world, obs, obs_mask=mask)
    np.testing.assert_allclose(res.K, ref.K, rtol=1e-6, atol=1e-9)
    assert res.reprojection_rmse < 0.5
    assert abs(res.K[0, 0] - f) / f < 0.02 and abs(res.K[1, 1] - f) / f < 0.02


# ---------------------------------------------------- square / circle grids

def _square_grid():
    return render_square_grid(3, 4, 16, 10, 24)


def _circles():
    return render_circles([(40 + r * 36, 50 + c * 36) for r in range(3)
                           for c in range(4)], 9, 180, 220)


def _hex_centers(rows, cols, pitch, y0=40, x0=40):
    return [(y0 + r * pitch * 0.55, x0 + c * pitch * 0.5)
            for r in range(rows) for c in range(cols) if (r + c) % 2 == 0]


def _circles_oblique():
    centers = [(30 + r * 30, 30 + c * 30) for r in range(5)
               for c in range(6)]
    img = render_circles(centers, 8, 190, 220)
    for rr, cc in [(1, 2), (3, 4)]:
        cy, cx = 30 + rr * 30, 30 + cc * 30
        img[cy - 10:cy + 11, cx - 10:cx + 11] = 220.0
    return _warp_target(img, _tilt_homography(190, 220, shrink=0.5))


def _hex_oblique():
    img = render_circles(_hex_centers(5, 7, 36, 30, 30), 8, 170, 190)
    for rr, cc in [(1, 1), (2, 4)]:
        cy, cx = 30 + rr * 36 * 0.55, 30 + cc * 36 * 0.5
        img[int(cy) - 10:int(cy) + 11, int(cx) - 10:int(cx) + 11] = 220.0
    return _warp_target(img, _tilt_homography(170, 190, shrink=0.52))


def _circles_fixed_oblique():
    centers = [(30 + r * 32, 30 + c * 32) for r in range(4)
               for c in range(5)]
    img = render_circles(centers, 8, 160, 200)
    return _warp_target(img, _tilt_homography(160, 200, shrink=0.55))


def _square_oblique_occluded():
    return _render_square_grid_h(_oblique_h(47.0), (240, 320), 4, 5,
                                 skip=(1, 2))[0]


def _square_distractor():
    img = _render_square_grid_h(_oblique_h(30.0, grid_wh=(5.5, 4.0)),
                                (240, 320), 3, 4)[0]
    img[5:35, 270:315] = 25.0
    return img


# (scene, JAX/port function name, args after the image)
GRID_CASES = [
    ("square", _square_grid, "detect_square_grid", (3, 4)),
    ("square_wrong_count", lambda: render_square_grid(2, 2),
     "detect_square_grid", (3, 4)),
    ("square_auto", _square_grid, "detect_square_grid_auto", ()),
    ("square_oblique_occluded", _square_oblique_occluded,
     "detect_square_grid_auto", ()),
    ("square_distractor", _square_distractor, "detect_square_grid",
     (3, 4)),
    ("circles", _circles, "detect_circle_regular_grid", (3, 4)),
    ("circles_auto", _circles, "detect_circle_regular_grid_auto", ()),
    ("circles_oblique", _circles_oblique,
     "detect_circle_regular_grid_auto", ()),
    ("circles_fixed_oblique", _circles_fixed_oblique,
     "detect_circle_regular_grid", (4, 5)),
    ("circles_rolled", lambda: np.rot90(_circles_fixed_oblique()).copy(),
     "detect_circle_regular_grid", (4, 5)),
    ("hex", lambda: render_circles(_hex_centers(4, 5, 40), 8, 180, 200),
     "detect_circle_hexagonal_grid", (4, 5)),
    ("hex_auto", lambda: render_circles(_hex_centers(4, 5, 40), 8, 180,
                                        200),
     "detect_circle_hexagonal_grid_auto", ()),
    ("hex_oblique", _hex_oblique, "detect_circle_hexagonal_grid_auto", ()),
]


@pytest.mark.parametrize("scene,fn,args",
                         [(c[1], c[2], c[3]) for c in GRID_CASES],
                         ids=[c[0] for c in GRID_CASES])
def test_grid_targets_match_jax(scene, fn, args):
    img = scene()
    want = getattr(jct, fn)(img, *args)
    got = getattr(tct, fn)(img, *args, device=CPU)
    _same(got, want, 1e-6)


def test_wrong_count_and_found_counts():
    """The JAX tests' outcome bars on the port: a 2x2 target is no 3x4;
    the occluded lattices miss exactly the occluded cells."""
    assert tct.detect_square_grid(render_square_grid(2, 2), 3, 4,
                                  device=CPU) is None
    grid, mask = tct.detect_circle_regular_grid_auto(_circles_oblique(),
                                                     device=CPU)
    assert mask.sum() == 5 * 6 - 2
    hexa = tct.detect_circle_hexagonal_grid_auto(_hex_oblique(), device=CPU)
    assert len(hexa["points"]) == len(_hex_centers(5, 7, 36)) - 2
    grid, mask = tct.detect_square_grid_auto(_square_oblique_occluded(),
                                             device=CPU)
    assert mask.sum() == 4 * (4 * 5 - 1)


def test_assemble_ellipse_grid_matches_jax():
    rng = np.random.default_rng(3)
    H = _tilt_homography(190, 220, shrink=0.6)
    pts = _apply_h(H, np.array([(30 + c * 30.0, 30 + r * 30.0)
                                for r in range(5) for c in range(6)]))
    pts = pts + rng.normal(0, 0.2, pts.shape)
    sizes = rng.uniform(7.5, 8.5, len(pts))
    for k in (4, 6, 8):
        _same(tct.assemble_ellipse_grid(pts, sizes, k, device=CPU),
              jct.assemble_ellipse_grid(pts, sizes, k), 1e-9)
    _same(tct.assemble_ellipse_grid(pts[:3], device=CPU),
          jct.assemble_ellipse_grid(pts[:3]), 1e-9)


def test_square_grid_views_to_zhang99_both_packages():
    """The slice whole: six rendered square-grid views -> detect_square_grid
    -> calibrate_mono_planar, in each package; the detections agree to
    1e-6 px and K to 1e-6 relative."""
    rows, cols, sq, gap = 3, 4, 1.0, 0.5
    pitch = sq + gap
    f_true, Hh, Ww = 300.0, 240, 320
    K_true = np.array([[f_true, 0, Ww / 2], [0, f_true, Hh / 2],
                       [0, 0, 1.0]])
    world = np.asarray([[c * pitch + b * sq, r * pitch + a * sq]
                        for r in range(rows) for a in range(2)
                        for c in range(cols) for b in range(2)])
    obs_t, obs_j = [], []
    for v in range(6):
        th = np.radians(18.0 + 5.0 * v)
        ax = np.radians(8.0 * (v % 3 - 1))
        Rx = np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                       [0, np.sin(th), np.cos(th)]])
        Rz = np.array([[np.cos(ax), -np.sin(ax), 0],
                       [np.sin(ax), np.cos(ax), 0], [0, 0, 1]])
        R = Rz @ Rx
        gw, gh = cols * pitch - gap, rows * pitch - gap
        t = np.array([0.0, 0.0, 9.0 + 0.5 * v]) \
            - R @ np.array([gw / 2, gh / 2, 0.0])
        Hm = K_true @ np.c_[R[:, 0], R[:, 1], t]
        img, _ = _render_square_grid_h(Hm, (Hh, Ww), rows, cols, sq=sq,
                                       gap=gap)
        pt = tct.detect_square_grid(img, rows, cols, device=CPU)
        pj = jct.detect_square_grid(img, rows, cols)
        _same(pt, pj, 1e-6)
        obs_t.append(pt)
        obs_j.append(pj)
    res = tz.calibrate_mono_planar(world, np.stack(obs_t), iterations=30,
                                   device=CPU)
    ref = jz.calibrate_mono_planar(world, np.stack(obs_j), iterations=30)
    np.testing.assert_allclose(res.K, ref.K, rtol=1e-6, atol=1e-9)
    assert abs(res.K[0, 0] - f_true) / f_true < 0.03
    assert res.reprojection_rmse < 1.0


@pytest.mark.parametrize("name", ["detect_calibration_points",
                                  "pose_of_calibration_target"])
def test_examples_run_on_cpu(name):
    import importlib
    mod = importlib.import_module(f"boofcv_tpu_torch.examples.{name}")
    assert mod.main(["--device", "cpu"]) == 0
