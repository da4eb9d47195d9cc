"""The stream axis, module by module: B = 3 streams with different data go
through the port in one call and are held against the JAX function under
``jax.vmap`` (its Pallas kernel through the XLA path it takes on the CPU)
and against the port's own single-stream call on each stream's data.
Streams must not couple: stream b of a batch is bit-equal to the
single-stream result wherever the arithmetic per stream is the same.  Also
here: KLT's ``"gather"`` method against the JAX package."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.core.pyramid import PyramidConfig as JPyramidConfig
from boofcv_tpu.feature import disparity as jdisp
from boofcv_tpu.feature import klt as jklt
from boofcv_tpu.geo import pnp as jpnp
from boofcv_tpu.geo import robust as jrobust
from boofcv_tpu.geo import se3 as jse3
from boofcv_tpu.io import simulate as jsim
from boofcv_tpu.ip import pyramid_ops as jpyr
from boofcv_tpu.kernels import window_gather as jwg
from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.feature import disparity as tdisp
from boofcv_tpu_torch.feature import extract as textract
from boofcv_tpu_torch.feature import intensity as tint
from boofcv_tpu_torch.feature import klt as tklt
from boofcv_tpu_torch.geo import pnp as tpnp
from boofcv_tpu_torch.geo import robust as trobust
from boofcv_tpu_torch.geo import smalllinalg as tla
from boofcv_tpu_torch.ip import pyramid_ops as tpyr
from boofcv_tpu_torch.kernels import window_gather as twg

torch.set_num_threads(1)

B = 3
SCALES = (1, 2, 4)
H, W = 128, 160
SHIFTS = ((2, -3), (0, 1), (-1, 2))          # one per stream
T = torch.from_numpy


# --- window gather ---------------------------------------------------------

@pytest.mark.parametrize("wy,wx,pad_left", [(24, 16, 0), (16, 102, 102),
                                            (16, 7, 4)])
def test_window_gather_streams(wy, wx, pad_left):
    """[B, N] origins on [B, h, w] images, bit-equal to the reference under
    vmap and to the 2-D call per stream; one frame expanded over the
    streams (stride 0) equals B copies of it."""
    h, w, n = 61, 97, 64
    rng = np.random.default_rng(wx)
    imgs = rng.uniform(0, 255, (B, h, w)).astype(np.float32)
    oy = (rng.integers(0, h, (B, n)) // 8 * 8).astype(np.int32)
    ox = rng.integers(-pad_left, max(w - wx, 1), (B, n)).astype(np.int32)
    ref = np.asarray(jax.vmap(lambda im, y, x: jwg.gather_windows(
        im, y, x, wy=wy, wx=wx, pad_left=pad_left, pad_bottom=16))(
            jnp.asarray(imgs), jnp.asarray(oy), jnp.asarray(ox)))
    out = twg.gather_windows(T(imgs), T(oy), T(ox), wy, wx)
    assert out.shape == (B, n, wy, wx)
    assert np.array_equal(out.numpy(), ref)
    for b in range(B):
        one = twg.gather_windows(T(imgs[b]), T(oy[b]), T(ox[b]), wy, wx)
        assert torch.equal(out[b], one)
    shared = T(imgs[1]).expand(B, h, w)
    assert shared.stride(0) == 0
    assert torch.equal(
        twg.gather_windows(shared, T(oy), T(ox), wy, wx),
        twg.gather_windows(shared.contiguous(), T(oy), T(ox), wy, wx))


def test_plane_layouts_the_kernels_take():
    """``plane_stride`` is what both CUDA wrappers check images with: a
    stack, one expanded frame, or [h, w]; nothing else.  ``as_planes``
    copies only what would be refused."""
    img = torch.zeros((4, 6, 8))
    assert twg.plane_stride("image", img) == 48
    assert twg.plane_stride("image", img[0]) == 0
    assert twg.plane_stride("image", img[0].expand(5, 6, 8)) == 0
    assert twg.plane_stride("image", img[:1]) == 0
    for bad, what in ((img.double(), "float32"), (img[..., ::2], "planes"),
                      (img[::2], "stack"), (img[None], "float32"),
                      (img.transpose(1, 2), "planes"),
                      (torch.zeros((0, 8)), "empty")):
        with pytest.raises(ValueError, match=what):
            twg.plane_stride("image", bad)
    shared = img[0].expand(5, 6, 8)
    assert twg.as_planes(shared) is shared
    assert twg.as_planes(img) is img
    assert twg.as_planes(img[::2]).is_contiguous()
    assert twg.as_planes(img.double()[0]).dtype == torch.float32
    o = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        twg.gather_windows_cuda(img, o, o, 4, 4)


# --- KLT -------------------------------------------------------------------

def _klt_streams(n=96):
    """Per stream: its own pair of frames (another shift), its own tracks."""
    tex = jsim.noise_texture(np.random.default_rng(3), size=256)
    f0, f1, ys, xs = [], [], [], []
    for b, (sy, sx) in enumerate(SHIFTS):
        oy, ox = 40 + 7 * b, 50 - 9 * b
        f0.append(tex[oy:oy + H, ox:ox + W])
        f1.append(tex[oy + sy:oy + sy + H, ox + sx:ox + sx + W])
        rng = np.random.default_rng(11 + b)
        ys.append(rng.uniform(2, H - 3, n))
        xs.append(rng.uniform(2, W - 3, n))
    f32 = lambda a: np.stack(a).astype(np.float32)
    return f32(f0), f32(f1), f32(ys), f32(xs)


def _torch_templates(f0, ys, xs):
    p0 = tpyr.pyramid_average(T(f0), PyramidConfig(SCALES))
    return tklt.sample_templates(p0, tpyr.gradient(p0), T(ys), T(xs),
                                 SCALES, 3)


@pytest.mark.parametrize("method,cfg_kw", [
    ("windowed", {}), ("windowed", {"max_per_pixel_error": 8.0}),
    ("gather", {}), ("gather", {"max_iterations": 3}),
    ("gather", {"max_iterations": 0})])
def test_track_pyramid_streams(method, cfg_kw):
    """Templates atol 1e-3, positions atol 1e-3 px, fault codes equal, per
    stream, against ``jax.vmap(track_pyramid)``; stream b bit-equal to the
    single-stream call.  The gather cases hold the port's fixed count of
    steps (``max_iterations`` rounded up to even, frozen flags) against the
    reference's two-steps-a-trip loop with its all-done exit, at an even
    count, an odd one and none."""
    f0, f1, ys, xs = _klt_streams()
    jcfg = jklt.KltConfig(method=method, **cfg_kw)
    tcfg = tklt.KltConfig(method=method, **cfg_kw)

    def jtrack(f0, f1, ys, xs):
        p0 = jpyr.pyramid_average(f0, JPyramidConfig(SCALES))
        p1 = jpyr.pyramid_average(f1, JPyramidConfig(SCALES))
        tm = jklt.sample_templates(p0, jpyr.gradient(p0), ys, xs, SCALES, 3)
        return tm, jklt.track_pyramid(p1, tm, ys, xs, SCALES, jcfg)

    jt, (jy, jx, jf) = jax.vmap(jtrack)(*map(jnp.asarray, (f0, f1, ys, xs)))
    tt = _torch_templates(f0, ys, xs)
    tp1 = tpyr.pyramid_average(T(f1), PyramidConfig(SCALES))
    ty, tx, tf = tklt.track_pyramid(tp1, tt, T(ys), T(xs), SCALES, tcfg)
    assert ty.shape == (B, ys.shape[1]) and tf.dtype == torch.int32
    for a, b in zip(jt.desc + jt.grad_x + jt.grad_y,
                    tt.desc + tt.grad_x + tt.grad_y):
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)
    assert np.array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-3, rtol=0)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-3, rtol=0)
    if not cfg_kw:
        ok = tf.numpy() == tklt.TRACK_OK
        for b, (sy, sx) in enumerate(SHIFTS):       # features move by -shift
            assert ok[b].mean() > 0.5
            assert abs(np.median((ty.numpy() - ys)[b][ok[b]]) + sy) < 0.2
            assert abs(np.median((tx.numpy() - xs)[b][ok[b]]) + sx) < 0.2
    for b in range(B):
        one_t = _torch_templates(f0[b], ys[b], xs[b])
        one_p = tpyr.pyramid_average(T(f1[b]), PyramidConfig(SCALES))
        oy, ox, of = tklt.track_pyramid(one_p, one_t, T(ys[b]), T(xs[b]),
                                        SCALES, tcfg)
        assert torch.equal(ty[b], oy) and torch.equal(tx[b], ox)
        assert torch.equal(tf[b], of)


def test_shared_frame_pyramid_is_built_once_and_tracks_alike():
    """One frame expanded over the streams: ``pyramid_average`` keeps every
    level an expanded view (stride 0), and tracking on it equals tracking
    on B copies."""
    f0, f1, ys, xs = _klt_streams()
    tt = _torch_templates(f0, ys, xs)
    shared = T(f1[0]).expand(B, H, W)
    pyr = tpyr.pyramid_average(shared, PyramidConfig(SCALES))
    assert [p.stride(0) for p in pyr] == [0, 0, 0]
    assert [tuple(p.shape) for p in pyr] == [(B, H // s, W // s)
                                             for s in SCALES]
    copies = tpyr.pyramid_average(shared.contiguous(), PyramidConfig(SCALES))
    for a, b in zip(pyr, copies):
        assert torch.equal(a, b)
    got = tklt.track_pyramid(pyr, tt, T(ys), T(xs), SCALES, tklt.KltConfig())
    want = tklt.track_pyramid(copies, tt, T(ys), T(xs), SCALES,
                              tklt.KltConfig())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_gather_follows_border_tracks_that_windowed_faults():
    """The two methods' known difference, in the port: near the bottom and
    right borders the windowed method's clamped, 8-row-aligned window
    origin leaves the patch outside the window margin at coarse levels, so
    it faults (out of bounds) tracks that the gather method follows; where
    both track they agree to 0.02 px; no track is windowed-only."""
    tex = jsim.noise_texture(np.random.default_rng(5), size=256)
    f0 = tex[30:30 + H, 40:40 + W].astype(np.float32)
    f1 = tex[31:31 + H, 38:38 + W].astype(np.float32)
    rng = np.random.default_rng(2)
    ys = rng.uniform(12, H - 13, 160).astype(np.float32)
    xs = rng.uniform(12, W - 13, 160).astype(np.float32)
    tt = _torch_templates(f0, ys, xs)
    p1 = tpyr.pyramid_average(T(f1), PyramidConfig(SCALES))
    wy, wx, wf = (a.numpy() for a in tklt.track_pyramid(
        p1, tt, T(ys), T(xs), SCALES, tklt.KltConfig(method="windowed")))
    gy, gx, gf = (a.numpy() for a in tklt.track_pyramid(
        p1, tt, T(ys), T(xs), SCALES, tklt.KltConfig(method="gather")))
    both = (wf == tklt.TRACK_OK) & (gf == tklt.TRACK_OK)
    assert both.mean() > 0.8
    assert np.maximum(np.abs(wy - gy), np.abs(wx - gx))[both].max() <= 0.02
    only_gather = (gf == tklt.TRACK_OK) & (wf != tklt.TRACK_OK)
    assert only_gather.sum() > 0
    assert np.all(wf[only_gather] == tklt.FAULT_OUT_OF_BOUNDS)
    reach = 6 * SCALES[-1]
    assert np.all(((ys >= H - reach) | (xs >= W - reach))[only_gather])
    assert not ((wf == tklt.TRACK_OK) & (gf != tklt.TRACK_OK)).any()
    assert abs(np.median((gy - ys)[only_gather]) + 1) < 0.1
    assert abs(np.median((gx - xs)[only_gather]) - 2) < 0.1


# --- detection and sparse disparity ---------------------------------------

@pytest.fixture(scope="module")
def stereo_streams():
    """B rendered stereo pairs from B viewpoints, rounded to integers like
    a camera's."""
    K = np.array([[150.0, 0.0, 80.0], [0.0, 150.0, 60.0], [0.0, 0.0, 1.0]])
    poses = [(np.eye(3), np.array([0.1 * b, 0.0, -0.2 * b]))
             for b in range(B)]
    frames = jsim.render_stereo_sequence(np.random.default_rng(0), K, 0.3,
                                         poses, 120, 160)
    r = lambda a: np.round(np.asarray(a)).astype(np.float32)
    return (np.stack([r(l) for l, _ in frames]),
            np.stack([r(x) for _, x in frames]))


def test_detect_streams(stereo_streams):
    """Shi-Tomasi, non-max suppression and top-k per stream: stream b of
    the batch is bit-equal to the single-stream call (its own tie ramp, its
    own k best)."""
    lefts, _ = stereo_streams
    inten = tint.shi_tomasi(T(lefts), radius=2)
    det = textract.detect(inten, 64, radius=4, threshold=1.0, border=14)
    assert det.ys.shape == (B, 64) and det.valid.dtype == torch.bool
    for b in range(B):
        one_i = tint.shi_tomasi(T(lefts[b]), radius=2)
        assert torch.equal(inten[b], one_i)
        one = textract.detect(one_i, 64, radius=4, threshold=1.0, border=14)
        for got, want in zip(det, one):
            assert torch.equal(got[b], want)
    assert int(det.valid.sum()) > 40 * B // 2
    assert not torch.equal(det.ys[0], det.ys[1])


def test_sparse_block_match_streams(stereo_streams):
    """Disparity atol 1e-4 and ``valid`` equal against
    ``jax.vmap(sparse_block_match)`` (its SAD path); stream b bit-equal to
    the single-stream call."""
    lefts, rights = stereo_streams
    h, w = lefts.shape[1:]
    rng = np.random.default_rng(48)
    ys = rng.integers(0, h, (B, 96)).astype(np.int32)
    xs = rng.integers(0, w, (B, 96)).astype(np.int32)
    ys[:, :4] = [0, 1, h - 1, h - 2]                 # rows past the image
    xs[:, :4] = [0, 3, w - 1, 60]
    kw = dict(min_disparity=0, max_disparity=48, radius_x=3, radius_y=3,
              texture_threshold=0.1)
    jcfg = jdisp.DisparityConfig(error="sad", **kw)
    dj, vj = jax.vmap(lambda l, r, y, x: jdisp.sparse_block_match(
        l, r, y, x, jcfg))(*map(jnp.asarray, (lefts, rights, ys, xs)))
    tcfg = tdisp.DisparityConfig(**kw)
    dt, vt = tdisp.sparse_block_match(T(lefts), T(rights), T(ys), T(xs), tcfg)
    assert dt.shape == (B, 96)
    assert np.array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-4, rtol=0)
    assert vt.numpy().sum() > 40 * B // 2
    for b in range(B):
        d1, v1 = tdisp.sparse_block_match(T(lefts[b]), T(rights[b]), T(ys[b]),
                                          T(xs[b]), tcfg)
        assert torch.equal(dt[b], d1) and torch.equal(vt[b], v1)


# --- RANSAC PnP -----------------------------------------------------------

def _pnp_scene(rng, n, noise, outliers):
    world = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(4, 9, n)], 1)
    R = np.asarray(jse3.exp_so3(jnp.asarray(rng.normal(0, 0.1, 3))))
    t = rng.normal(0, 0.2, 3)
    Xc = world @ R.T + t
    obs = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, noise, (n, 2))
    bad = rng.uniform(size=n) < outliers
    obs[bad] += rng.uniform(-0.2, 0.2, (bad.sum(), 2))
    return world, obs


def _pnp_streams():
    """Three problems; stream 1 is mostly outliers with coarse noise, so it
    has fewer inliers, larger MSAC scores and a slower refine: freezing the
    refine on the batch's largest step would change streams 0 and 2.  (The
    MSAC tie-break is scaled by each stream's own largest score, as under
    ``vmap``; a batch-wide scale would only shrink the term, so no result
    can show it beyond a rounding.)"""
    rng = np.random.default_rng(21)
    n, K = 160, 96
    scenes = [_pnp_scene(rng, n, 3e-4, 0.2), _pnp_scene(rng, n, 2e-3, 0.7),
              _pnp_scene(rng, n, 1e-4, 0.05)]
    world = np.stack([s[0] for s in scenes])
    obs = np.stack([s[1] for s in scenes])
    valid = rng.uniform(size=(B, n)) > 0.05
    idx = np.stack([np.asarray(jrobust.sample_indices(
        jax.random.PRNGKey(b), K, 3, n, jnp.asarray(valid[b])))
        for b in range(B)])
    return world, obs, valid, idx, K, (1.5 / 480.0) ** 2


def test_ransac_pnp_streams():
    """Injected [B, K, 3] index sets.  Per stream against the JAX package:
    equal inlier mask and count, pose within 1e-5 (the float32 refine's
    resolution on the noisy stream).  Per stream against the port's
    single-stream call: inliers and count equal, pose within 1e-6 (the
    batched float32 products round otherwise than the single ones).  And
    bit for bit: streams 0 and 2 give the same result whatever stream 1
    holds, its hard problem or a copy of stream 0's easy one."""
    world, obs, valid, idx, K, thr = _pnp_streams()
    kw = dict(num_hypotheses=K, inlier_threshold=thr, refine_iterations=10)
    rt, (Rt, tt) = trobust.ransac_pnp(None, T(world), T(obs),
                                      valid_mask=T(valid),
                                      idx=T(idx).long(), **kw)
    assert Rt.shape == (B, 3, 3) and tt.shape == (B, 3)
    assert Rt.dtype == torch.float64 and rt.num_inliers.shape == (B,)
    counts = rt.num_inliers.tolist()
    assert counts[1] < 0.6 * counts[0] and counts[1] < 0.6 * counts[2]
    for b in range(B):
        rj, (Rj, tj) = jrobust.ransac_pnp(
            jax.random.PRNGKey(b), jnp.asarray(world[b]), jnp.asarray(obs[b]),
            valid_mask=jnp.asarray(valid[b]), **kw)
        assert np.array_equal(rt.inliers[b].numpy(), np.asarray(rj.inliers))
        assert counts[b] == int(rj.num_inliers)
        np.testing.assert_allclose(Rt[b].numpy(), np.asarray(Rj), atol=1e-5)
        np.testing.assert_allclose(tt[b].numpy(), np.asarray(tj), atol=1e-5)
        r1, (R1, t1) = trobust.ransac_pnp(
            None, T(world[b]), T(obs[b]), valid_mask=T(valid[b]),
            idx=T(idx[b]).long(), **kw)
        assert torch.equal(rt.inliers[b], r1.inliers)
        assert counts[b] == int(r1.num_inliers)
        np.testing.assert_allclose(float(rt.best_error[b]),
                                   float(r1.best_error), rtol=1e-5)
        np.testing.assert_allclose(Rt[b].numpy(), R1.numpy(), atol=1e-6)
        np.testing.assert_allclose(tt[b].numpy(), t1.numpy(), atol=1e-6)
    for a in (world, obs, valid, idx):
        a[1] = a[0]
    r2, (R2, t2) = trobust.ransac_pnp(None, T(world), T(obs),
                                      valid_mask=T(valid),
                                      idx=T(idx).long(), **kw)
    for b in (0, 2):
        assert torch.equal(R2[b], Rt[b]) and torch.equal(t2[b], tt[b])
        assert torch.equal(r2.inliers[b], rt.inliers[b])
        assert torch.equal(r2.best_error[b], rt.best_error[b])
    assert torch.equal(R2[1], R2[0])


def test_gn_refine_freezes_each_stream_on_its_own_step():
    """Stream 0 starts at its optimum and stops after one step; stream 1
    starts far off and keeps stepping.  The freeze is per stream: stream 0
    ends on the same bits as beside a copy of itself (were the loop frozen
    on the batch's largest step, it would go on taking rounding-sized steps
    beside the slow stream), and each stream agrees with its single-stream
    refine to 1e-6 (the float32 loop's batched products round
    otherwise)."""
    rng = np.random.default_rng(6)
    world, obs = _pnp_scene(rng, 120, 0.0, 0.0)
    R0, t0 = jpnp.gauss_newton_pose(
        jnp.eye(3), jnp.zeros(3), jnp.asarray(world), jnp.asarray(obs),
        iterations=12)
    R0, t0 = np.asarray(R0), np.asarray(t0)
    far = np.asarray(jse3.exp_so3(jnp.asarray([0.05, -0.04, 0.03])))
    Rb = T(np.stack([R0, R0 @ far]))
    tb = T(np.stack([t0, t0 + 0.1]))
    wb, ob = T(np.stack([world] * 2)), T(np.stack([obs] * 2))
    Rr, tr = tpnp.gauss_newton_pose(Rb, tb, wb, ob, iterations=10,
                                    polish_iterations=0)
    for b in range(2):
        R1, t1 = tpnp.gauss_newton_pose(Rb[b], tb[b], wb[b], ob[b],
                                        iterations=10, polish_iterations=0)
        np.testing.assert_allclose(Rr[b].numpy(), R1.numpy(), atol=1e-6)
        np.testing.assert_allclose(tr[b].numpy(), t1.numpy(), atol=1e-6)
    np.testing.assert_allclose(Rr[1].numpy(), R0, atol=1e-5)
    twin = lambda a: torch.stack([a[0], a[0]])
    Rs, ts = tpnp.gauss_newton_pose(twin(Rb), twin(tb), wb, ob,
                                    iterations=10, polish_iterations=0)
    assert torch.equal(Rs[0], Rr[0]) and torch.equal(ts[0], tr[0])


def test_sample_indices_streams_draw_what_single_streams_draw():
    """Stream b's index sets come from generator b alone: equal to a
    single-stream draw from a generator with the same seed."""
    n, K = 50, 40
    valid = torch.rand((B, n), generator=torch.Generator().manual_seed(9)) > .3
    gens = [torch.Generator().manual_seed(5 + b) for b in range(B)]
    idx = trobust.sample_indices(gens, K, 3, n, valid)
    assert idx.shape == (B, K, 3)
    for b in range(B):
        one = trobust.sample_indices(torch.Generator().manual_seed(5 + b), K,
                                     3, n, valid[b])
        assert torch.equal(idx[b], one)
        assert bool(valid[b][idx[b]].all())
    assert not torch.equal(idx[0], idx[1])


def test_f32_p3p_keeps_its_float64_half_with_a_stream_axis():
    """The reference's float32 P3P runs its quartic's three-root branch in
    float64 (``jnp.arange(3.0)`` under x64).  With [B, K] in front the
    port keeps every intermediate's dtype: the roots stay float64, the
    returned pose float32, and stream b equals the single-stream bank."""
    rng = np.random.default_rng(4)
    world = rng.uniform(-2, 2, (B, 32, 3, 3)) + np.array([0, 0, 6.0])
    Rtrue = np.asarray(jse3.exp_so3(jnp.asarray(rng.normal(0, 0.1, 3))))
    cam = world @ Rtrue.T + np.array([0.1, -0.2, 0.3])
    obs = cam[..., :2] / cam[..., 2:]
    c = [T(rng.normal(0, 1, (B, 32)).astype(np.float32)) for _ in range(5)]
    roots, real = tla.quartic_roots(*c)
    assert roots.dtype == torch.float64 and roots.shape == (B, 32, 4)
    mroots, _ = tla.cubic_roots(*c[:4])
    assert mroots.dtype == torch.float64
    R, t, ok = tpnp.p3p_grunert(T(world), T(obs), dtype=torch.float32)
    assert R.dtype == torch.float32 and t.dtype == torch.float32
    assert R.shape == (B, 32, 4, 3, 3) and ok.shape == (B, 32, 4)
    for b in range(B):
        R1, t1, ok1 = tpnp.p3p_grunert(T(world[b]), T(obs[b]),
                                       dtype=torch.float32)
        assert torch.equal(ok[b], ok1)
        assert torch.equal(R[b][ok1], R1[ok1])
        assert torch.equal(t[b][ok1], t1[ok1])
        assert roots[b].dtype == torch.float64
    best = (R[ok].double() - torch.tensor(Rtrue)).abs().amax(dim=(-1, -2))
    assert float(best.min()) < 1e-3
