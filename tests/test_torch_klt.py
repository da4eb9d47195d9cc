"""Pyramidal KLT, windowed method: the port against the JAX package on a
noise texture shifted by an integer offset (features move by -shift), and
a per-track scalar model of the ``klt_track`` CUDA kernel's control flow
against the port's plain version."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.core.pyramid import PyramidConfig as JPyramidConfig
from boofcv_tpu.feature import klt as jklt
from boofcv_tpu.io import simulate as jsim
from boofcv_tpu.ip import pyramid_ops as jpyr
from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.feature import klt as tklt
from boofcv_tpu_torch.ip import pyramid_ops as tpyr
from boofcv_tpu_torch.kernels import klt_track

torch.set_num_threads(1)

SCALES = (1, 2, 4)
H, W = 128, 160


def _frames(shift):
    tex = jsim.noise_texture(np.random.default_rng(3), size=256)
    sy, sx = shift
    f0 = tex[40:40 + H, 50:50 + W]
    f1 = tex[40 + sy:40 + sy + H, 50 + sx:50 + sx + W]
    return f0.astype(np.float32), f1.astype(np.float32)


def _tracks(n):
    rng = np.random.default_rng(11)
    ys = rng.uniform(2, H - 3, n).astype(np.float32)
    xs = rng.uniform(2, W - 3, n).astype(np.float32)
    return ys, xs


def _run_both(shift, n=192, cfg_kw=None):
    f0, f1 = _frames(shift)
    ys, xs = _tracks(n)
    jcfg = jklt.KltConfig(**(cfg_kw or {}))
    tcfg = tklt.KltConfig(**(cfg_kw or {}))
    jp0 = jpyr.pyramid_average(jnp.asarray(f0), JPyramidConfig(SCALES))
    jp1 = jpyr.pyramid_average(jnp.asarray(f1), JPyramidConfig(SCALES))
    jt = jklt.sample_templates(jp0, jpyr.gradient(jp0), jnp.asarray(ys),
                               jnp.asarray(xs), SCALES, 3)
    jy, jx, jf = jklt.track_pyramid(jp1, jt, jnp.asarray(ys),
                                    jnp.asarray(xs), SCALES, jcfg)
    tp0 = tpyr.pyramid_average(torch.from_numpy(f0), PyramidConfig(SCALES))
    tp1 = tpyr.pyramid_average(torch.from_numpy(f1), PyramidConfig(SCALES))
    tt = tklt.sample_templates(tp0, tpyr.gradient(tp0), torch.from_numpy(ys),
                               torch.from_numpy(xs), SCALES, 3)
    ty, tx, tf = tklt.track_pyramid(tp1, tt, torch.from_numpy(ys),
                                    torch.from_numpy(xs), SCALES, tcfg)
    return (ys, xs), (jt, np.asarray(jy), np.asarray(jx), np.asarray(jf)), \
        (tt, ty.numpy(), tx.numpy(), tf.numpy())


@pytest.mark.parametrize("shift", [(2, -3), (0, 1), (-4, 5)])
def test_track_pyramid_matches_jax(shift):
    """Positions atol 1e-3 px on every track; fault codes equal."""
    (ys, xs), (jt, jy, jx, jf), (tt, ty, tx, tf) = _run_both(shift)
    for a, b in zip(jt.desc + jt.grad_x + jt.grad_y,
                    tt.desc + tt.grad_x + tt.grad_y):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)
    assert np.array_equal(jf, tf)
    np.testing.assert_allclose(ty, jy, atol=1e-3, rtol=0)
    np.testing.assert_allclose(tx, jx, atol=1e-3, rtol=0)
    ok = tf == tklt.TRACK_OK
    assert ok.mean() > 0.5
    # features move by -shift
    assert abs(np.median(ty[ok] - ys[ok]) + shift[0]) < 0.2
    assert abs(np.median(tx[ok] - xs[ok]) + shift[1]) < 0.2


def test_faults_exercised_and_equal():
    """A large shift and a tight error bound produce every fault kind the
    level loop can raise; the codes agree track by track."""
    _, (_, _, _, jf), (_, _, _, tf) = _run_both(
        (9, -11), cfg_kw=dict(max_per_pixel_error=6.0))
    assert np.array_equal(jf, tf)
    assert {tklt.FAULT_OUT_OF_BOUNDS, tklt.FAULT_LARGE_ERROR} <= set(tf)


def test_gather_method_not_ported():
    """The name is from when ``"gather"`` raised.  It is ported now (its
    parity tests are in test_torch_batched.py): only an unknown method
    raises, on either entry point."""
    f0, _ = _frames((0, 0))
    p = tpyr.pyramid_average(torch.from_numpy(f0), PyramidConfig(SCALES))
    at = torch.full((2,), 40.0)
    t = tklt.sample_templates(p, tpyr.gradient(p), at, at, SCALES, 3)
    for track in (tklt.track_pyramid, tklt.track_pyramid_reference):
        with pytest.raises(ValueError, match="'windowed' or 'gather'"):
            track(p, t, at, at, SCALES, tklt.KltConfig(method="fused"))
    ty, tx, tf = tklt.track_pyramid(p, t, at, at, SCALES,
                                    tklt.KltConfig(method="gather"))
    assert tf.tolist() == [tklt.TRACK_OK] * 2
    assert float((ty - at).abs().max()) < 1e-3
    assert float((tx - at).abs().max()) < 1e-3


# --- the klt_track kernel's control flow, one track at a time --------------
#
# csrc/klt_track.cu cannot run without a card.  This is its per-track
# program in numpy float32 scalars: truncating division repaired into floor
# division, the early exit with one more evaluation at the frozen position,
# the carry between levels and the fault priority.  It is held against
# track_pyramid_reference, the batched plain version with its fixed-count
# loop and frozen flags.

F32 = np.float32


def _floor_div_c(a: int, b: int) -> int:
    """floor_div of the kernel: C's truncating a / b, then the repair."""
    q = abs(a) // b * (1 if a >= 0 else -1)            # C: a / b
    rem = a - q * b                                      # C: a % b
    return q - 1 if (rem != 0 and a < 0) else q


def _clampf(v, lo, hi):
    return min(max(v, F32(lo)), F32(hi))


def _track_one(pyr, desc, gx, gy, y0, x0, scales, cfg):
    r = cfg.template_radius
    p = 2 * r + 1
    area = F32(p * p)
    wy, wx = (24, 16) if p + 2 <= 16 else (32, 32)
    sy, sx = (wy - (p + 1)) // 2, (wx - (p + 1)) // 2
    margin_y, margin_x = F32(wy - p - 1), F32(wx - p - 1)
    tol = F32(cfg.convergence_tol)
    cy = F32(y0) / F32(scales[-1])
    cx = F32(x0) / F32(scales[-1])
    fault, evals = 0, 0
    for l in range(len(scales) - 1, -1, -1):
        img = pyr[l]
        h, w = img.shape
        d, g1, g2 = desc[l], gx[l], gy[l]
        gxx, gxy, gyy = (F32(np.sum(g1 * g1)), F32(np.sum(g1 * g2)),
                         F32(np.sum(g2 * g2)))
        det = gxx * gyy - gxy * gxy
        ok_det = det / area >= F32(cfg.min_determinant)
        safe_det = F32(1.0) if det == 0 else det
        oy_ideal = int(np.floor(cy)) - r - sy
        oy = min(max(_floor_div_c(oy_ideal, 8) * 8, 0),
                 max(_floor_div_c(h, 8) * 8 - wy, 0))
        ox = min(max(int(np.floor(cx)) - r - sx, 0), max(w - wx, 0))
        py = cy - F32(r) - F32(oy)
        px = cx - F32(r) - F32(ox)
        rows = np.clip(oy + np.arange(wy), 0, h - 1)
        cols = np.clip(ox + np.arange(wx), 0, w - 1)
        win = img[rows][:, cols]
        done, per_pixel = False, F32(0.0)
        for _ in range(cfg.max_iterations):
            pyc = _clampf(py, 0.0, margin_y)
            pxc = _clampf(px, 0.0, margin_x)
            by, bx = int(np.floor(pyc)), int(np.floor(pxc))
            fy, fx = pyc - F32(by), pxc - F32(bx)
            a = win[by:by + p + 1, bx:bx + p + 1]
            t = (F32(1) - fx) * a[:, :p] + fx * a[:, 1:]
            e = ((F32(1) - fy) * t[:p] + fy * t[1:]) - d
            per_pixel = F32(np.sum(np.abs(e))) / area
            evals += 1
            if done:
                break
            bx_, by_ = F32(np.sum(e * g1)), F32(np.sum(e * g2))
            dx = (gyy * bx_ - gxy * by_) / safe_det
            dy = (gxx * by_ - gxy * bx_) / safe_det
            py, px = py - dy, px - dx
            done = bool(abs(dx) < tol and abs(dy) < tol)
        cy_l = _clampf(py, 0.0, margin_y) + F32(r) + F32(oy)
        cx_l = _clampf(px, 0.0, margin_x) + F32(r) + F32(ox)
        in_bounds = (cy_l >= r and cy_l <= h - 1 - r and cx_l >= r
                     and cx_l <= w - 1 - r and 0 < py < margin_y
                     and 0 < px < margin_x)
        f = tklt.TRACK_OK
        if per_pixel > F32(cfg.max_per_pixel_error):
            f = tklt.FAULT_LARGE_ERROR
        if not ok_det:
            f = tklt.FAULT_FAILED
        if not in_bounds:
            f = tklt.FAULT_OUT_OF_BOUNDS
        if f == tklt.TRACK_OK:
            cy, cx = cy_l, cx_l
        fault = max(fault, f)
        if l > 0:
            ratio = F32(scales[l] / scales[l - 1])
            cy, cx = cy * ratio, cx * ratio
    return cy, cx, fault, evals


def _border_scene(shift, n=96):
    """Templates on frame 0, pyramid of frame 1: random tracks, tracks
    within 6 px of every border (negative and clamped window origins), and
    dead slots with all-zero templates: two at (0, 0), where a fresh pool
    keeps them, and two inside the image."""
    f0, f1 = _frames(shift)
    ys, xs = _tracks(n)
    edge = np.array([0.0, 1.5, 3.25, 5.9], np.float32)
    mid_y = np.linspace(10, H - 11, 4).astype(np.float32)
    mid_x = np.linspace(10, W - 11, 4).astype(np.float32)
    ys = np.concatenate([ys, edge, H - 1 - edge, mid_y, mid_y,
                         np.array([0, 0, 40.5, 77], np.float32)])
    xs = np.concatenate([xs, mid_x, mid_x, edge, W - 1 - edge,
                         np.array([0, 0, 61, 90.25], np.float32)])
    p0 = tpyr.pyramid_average(torch.from_numpy(f0), PyramidConfig(SCALES))
    p1 = tpyr.pyramid_average(torch.from_numpy(f1), PyramidConfig(SCALES))
    tm = tklt.sample_templates(p0, tpyr.gradient(p0), torch.from_numpy(ys),
                               torch.from_numpy(xs), SCALES, 3)
    dead = torch.zeros(len(ys), dtype=torch.bool)
    dead[-4:] = True
    zero = lambda ts: tuple(torch.where(dead[:, None, None], 0.0, t)
                            for t in ts)
    tm = tklt.KltTemplates(zero(tm.desc), zero(tm.grad_x), zero(tm.grad_y))
    return p1, tm, ys, xs


@pytest.mark.parametrize("shift,cfg_kw", [
    ((2, -3), {}), ((0, 1), {}), ((-4, 5), {}),
    ((9, -11), dict(max_per_pixel_error=6.0)),
    ((1, -1), dict(max_iterations=2)),
    ((0, 1), dict(convergence_tol=1e-4)),
])
def test_kernel_control_flow_matches_plain_version(shift, cfg_kw):
    """Faults equal on every track and positions within 1e-4 px (the two
    sum the 49 patch terms in another order, nothing else differs),
    border tracks and zero-template slots included."""
    cfg = tklt.KltConfig(**cfg_kw)
    p1, tm, ys, xs = _border_scene(shift)
    ry, rx, rf = tklt.track_pyramid_reference(
        p1, tm, torch.from_numpy(ys), torch.from_numpy(xs), SCALES, cfg)
    pyr = [p.numpy() for p in p1]
    desc, gx, gy = ([t.numpy() for t in ts] for ts in tm)
    got = [_track_one(pyr, [d[n] for d in desc], [g[n] for g in gx],
                      [g[n] for g in gy], ys[n], xs[n], SCALES, cfg)
           for n in range(len(ys))]
    my = np.array([g[0] for g in got], np.float32)
    mx = np.array([g[1] for g in got], np.float32)
    mf = np.array([g[2] for g in got])
    evals = np.array([g[3] for g in got])
    assert np.array_equal(mf, rf.numpy())
    np.testing.assert_allclose(my, ry.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(mx, rx.numpy(), atol=1e-4, rtol=0)
    # the scene exercises what it is meant to
    # dead slots: out of bounds at the corner, singular inside the image
    assert list(rf.numpy()[-4:]) == [tklt.FAULT_OUT_OF_BOUNDS] * 2 \
        + [tklt.FAULT_FAILED] * 2
    assert not np.isnan(my).any() and not np.isnan(mx).any()
    assert tklt.FAULT_OUT_OF_BOUNDS in mf
    assert (tklt.FAULT_LARGE_ERROR if "max_per_pixel_error" in cfg_kw
            else tklt.TRACK_OK) in mf
    top = len(SCALES) * cfg.max_iterations
    assert evals.max() <= top
    if cfg.max_iterations >= 8:
        assert evals.min() < top                  # some track left early


def test_floor_division_of_negative_origins():
    for a in range(-40, 41):
        assert _floor_div_c(a, 8) == a // 8


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """Dispatch is by device: on CPU tensors track_pyramid is the plain
    version and never reaches the kernel's wrapper."""
    def no_kernel(*a, **k):
        raise AssertionError("klt_track_cuda called on CPU tensors")
    monkeypatch.setattr(tklt, "klt_track_cuda", no_kernel)
    p1, tm, ys, xs = _border_scene((2, -3), n=16)
    args = (p1, tm, torch.from_numpy(ys), torch.from_numpy(xs), SCALES,
            tklt.KltConfig())
    for a, b in zip(tklt.track_pyramid(*args),
                    tklt.track_pyramid_reference(*args)):
        assert torch.equal(a, b)


def test_kernel_wrapper_refuses_cpu_tensors():
    """klt_track_cuda has no CPU route: it raises and counts no launch."""
    p1, tm, ys, xs = _border_scene((0, 1), n=4)
    before = klt_track.launch_count()
    with pytest.raises(ValueError, match="CUDA"):
        klt_track.klt_track_cuda(
            list(p1), list(tm.desc), list(tm.grad_x), list(tm.grad_y),
            torch.from_numpy(ys), torch.from_numpy(xs), SCALES, 3, 8, 25.0,
            0.001, 0.01)
    assert klt_track.launch_count() == before
