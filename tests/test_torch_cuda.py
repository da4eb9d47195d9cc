"""Tests that need the card.  They skip without a CUDA device; on the card,
where JAX is absent, run them without the JAX conftest:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""

import ctypes

import numpy as np
import pytest
import torch

from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.feature import klt
from boofcv_tpu_torch.geo import pnp
from boofcv_tpu_torch.io import simulate
from boofcv_tpu_torch.ip import pyramid_ops
from boofcv_tpu_torch.kernels import gn_pose as gp
from boofcv_tpu_torch.kernels import klt_track as kt
from boofcv_tpu_torch.kernels import window_gather as wg

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_kernel_matches_plain_version(cuda):
    """The CUDA kernel equals the plain version bit for bit, at the KLT and
    sparse-SAD shapes and with origins far outside the image."""
    g = torch.Generator().manual_seed(0)
    for h, w, n, wy, wx in ((480, 640, 512, 24, 16), (37, 53, 100, 7, 102),
                            (15, 20, 64, 24, 16), (480, 640, 512, 7, 7)):
        img = torch.rand((h, w), generator=g).to(cuda)
        oy = torch.randint(-110, h + 10, (n,), generator=g,
                           dtype=torch.int32).to(cuda)
        ox = torch.randint(-110, w + 10, (n,), generator=g,
                           dtype=torch.int32).to(cuda)
        before = wg.launch_count()
        out = wg.gather_windows(img, oy, ox, wy, wx)
        torch.cuda.synchronize()
        assert wg.launch_count() == before + 1
        assert torch.equal(out, wg.gather_windows_reference(img, oy, ox,
                                                             wy, wx))


def test_kernel_rejects_bad_inputs(cuda):
    img = torch.zeros((8, 8), device=cuda)
    o32 = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        wg.gather_windows(img, o32.long(), o32, 4, 4)
    with pytest.raises(ValueError):
        wg.gather_windows(img.double(), o32, o32, 4, 4)
    with pytest.raises(ValueError):
        wg.gather_windows(img.t(), o32, o32, 4, 4)
    with pytest.raises(ValueError):
        wg.gather_windows(img, o32.cpu(), o32, 4, 4)


def test_klt_on_card_matches_cpu(cuda):
    """The same KLT pass on the card (through the kernel) and on the CPU
    (through the plain version): positions to 1e-3 px, faults equal."""
    tex = simulate.noise_texture(np.random.default_rng(3), size=256)
    f0 = torch.from_numpy(tex[40:168, 50:210].copy())
    f1 = torch.from_numpy(tex[42:170, 47:207].copy())
    rng = np.random.default_rng(1)
    ys = torch.from_numpy(rng.uniform(2, 125, 256).astype(np.float32))
    xs = torch.from_numpy(rng.uniform(2, 157, 256).astype(np.float32))
    scales = (1, 2, 4)
    out = {}
    for dev in ("cpu", cuda):
        p0 = pyramid_ops.pyramid_average(f0.to(dev), PyramidConfig(scales))
        p1 = pyramid_ops.pyramid_average(f1.to(dev), PyramidConfig(scales))
        tm = klt.sample_templates(p0, pyramid_ops.gradient(p0), ys.to(dev),
                                  xs.to(dev), scales, 3)
        out[str(dev)] = [t.cpu() for t in klt.track_pyramid(
            p1, tm, ys.to(dev), xs.to(dev), scales, klt.KltConfig())]
    (cy, cx, cf), (gy, gx, gf) = out["cpu"], out[str(cuda)]
    assert torch.equal(cf, gf)
    assert float((cy - gy).abs().max()) < 1e-3
    assert float((cx - gx).abs().max()) < 1e-3


def _klt_scene(dev, n_levels=3):
    """256 tracks on a 128x160 noise texture shifted by (2, -3): templates
    on the first frame, pyramid of the second.  The tracks reach to every
    border (negative and clamped window origins); the last 8 slots are dead
    (all-zero templates), four at (0, 0) and four inside the image."""
    tex = simulate.noise_texture(np.random.default_rng(3), size=256)
    f0 = torch.from_numpy(tex[40:168, 50:210].copy()).to(dev)
    f1 = torch.from_numpy(tex[42:170, 47:207].copy()).to(dev)
    rng = np.random.default_rng(1)
    ys = rng.uniform(0, 127, 256).astype(np.float32)
    xs = rng.uniform(0, 159, 256).astype(np.float32)
    ys[-8:-4], xs[-8:-4] = 0.0, 0.0
    ys, xs = torch.from_numpy(ys).to(dev), torch.from_numpy(xs).to(dev)
    scales = tuple(2 ** i for i in range(n_levels))
    p0 = pyramid_ops.pyramid_average(f0, PyramidConfig(scales))
    p1 = pyramid_ops.pyramid_average(f1, PyramidConfig(scales))
    tm = klt.sample_templates(p0, pyramid_ops.gradient(p0), ys, xs, scales, 3)
    dead = torch.zeros(256, dtype=torch.bool, device=dev)
    dead[-8:] = True
    zero = lambda ts: tuple(torch.where(dead[:, None, None], 0.0, t)
                            for t in ts)
    tm = klt.KltTemplates(zero(tm.desc), zero(tm.grad_x), zero(tm.grad_y))
    return p1, tm, ys, xs, scales


@pytest.mark.parametrize("cfg_kw", [{}, dict(max_iterations=2),
                                    dict(max_per_pixel_error=6.0)])
def test_klt_track_matches_plain_version(cuda, cfg_kw):
    """One launch of klt_track against the plain version on the card: fault
    codes equal on >= 99 % of tracks (a track on a threshold may take the
    other branch), positions within 2e-3 px where both say TRACK_OK (the
    kernel sums the 49 patch terms in another order than torch.sum)."""
    cfg = klt.KltConfig(**cfg_kw)
    p1, tm, ys, xs, scales = _klt_scene(cuda)
    before = kt.launch_count()
    gy, gx, gf = klt.track_pyramid(p1, tm, ys, xs, scales, cfg)
    torch.cuda.synchronize()
    assert kt.launch_count() == before + 1
    wy, wx, wf = klt.track_pyramid_reference(p1, tm, ys, xs, scales, cfg)
    assert kt.launch_count() == before + 1       # the plain version: none
    assert int((gf == wf).sum()) >= 0.99 * 256, torch.nonzero(gf != wf)
    ok = (gf == klt.TRACK_OK) & (wf == klt.TRACK_OK)
    assert int(ok.sum()) >= 64
    assert float((gy - wy).abs()[ok].max()) <= 2e-3
    assert float((gx - wx).abs()[ok].max()) <= 2e-3
    assert bool((gf[-8:] != klt.TRACK_OK).all())
    assert bool(torch.isfinite(gy).all() and torch.isfinite(gx).all())


def test_klt_track_rejects_bad_inputs(cuda):
    cfg = klt.KltConfig()
    p1, tm, ys, xs, scales = _klt_scene(cuda)

    def call(pyr=p1, desc=tm.desc, ys_=ys, scales_=scales):
        return kt.klt_track_cuda(
            list(pyr), list(desc), list(tm.grad_x), list(tm.grad_y), ys_, xs,
            scales_, 3, cfg.max_iterations, cfg.max_per_pixel_error,
            cfg.min_determinant, cfg.convergence_tol)

    before = kt.launch_count()
    with pytest.raises(ValueError, match="float32"):
        call(ys_=ys.double())
    with pytest.raises(ValueError, match="float32"):
        call(desc=(tm.desc[0].half(),) + tm.desc[1:])
    with pytest.raises(ValueError, match="CUDA"):
        call(ys_=ys.cpu())
    with pytest.raises(ValueError, match="on cpu"):
        call(pyr=(p1[0].cpu(),) + p1[1:])
    with pytest.raises(ValueError, match="contiguous"):
        call(pyr=(p1[0].t().contiguous().t(),) + p1[1:])
    with pytest.raises(ValueError, match="contiguous"):
        call(desc=(tm.desc[0].transpose(1, 2),) + tm.desc[1:])
    with pytest.raises(ValueError, match="must be"):
        call(desc=(tm.desc[0][:, :5, :5].contiguous(),) + tm.desc[1:])
    nine = tuple(2 ** i for i in range(9))
    with pytest.raises(ValueError, match="levels"):
        kt.klt_track_cuda([p1[0]] * 9, [tm.desc[0]] * 9, [tm.grad_x[0]] * 9,
                          [tm.grad_y[0]] * 9, ys, xs, nine, 3, 8, 25.0,
                          0.001, 0.01)
    assert kt.launch_count() == before
    call()
    assert kt.launch_count() == before + 1


def test_klt_track_takes_eight_levels_and_wide_patches(cuda):
    """The kernel's limits: 8 levels (the coarsest 8x8, the least the
    template sampler takes for a 7x7 patch) and the 15x15 patch with its
    32x32 window, against the plain version."""
    tex = simulate.noise_texture(np.random.default_rng(4), size=1100)
    f0 = torch.from_numpy(tex[:1024, :1088].copy()).to(cuda)
    f1 = torch.from_numpy(tex[1:1025, 2:1090].copy()).to(cuda)
    rng = np.random.default_rng(2)
    ys = torch.from_numpy(rng.uniform(0, 1023, 200).astype(np.float32)).to(cuda)
    xs = torch.from_numpy(rng.uniform(0, 1087, 200).astype(np.float32)).to(cuda)
    for scales, radius in ((tuple(2 ** i for i in range(8)), 3),
                           ((1, 2, 4), 7), ((1, 2), 1)):
        cfg = klt.KltConfig(template_radius=radius)
        p0 = pyramid_ops.pyramid_average(f0, PyramidConfig(scales))
        p1 = pyramid_ops.pyramid_average(f1, PyramidConfig(scales))
        tm = klt.sample_templates(p0, pyramid_ops.gradient(p0), ys, xs,
                                  scales, radius)
        gy, gx, gf = klt.track_pyramid(p1, tm, ys, xs, scales, cfg)
        wy, wx, wf = klt.track_pyramid_reference(p1, tm, ys, xs, scales, cfg)
        torch.cuda.synchronize()
        assert int((gf == wf).sum()) >= 0.99 * 200, (scales, radius)
        ok = (gf == klt.TRACK_OK) & (wf == klt.TRACK_OK)
        if bool(ok.any()):
            assert float((gy - wy).abs()[ok].max()) <= 2e-3, (scales, radius)
            assert float((gx - wx).abs()[ok].max()) <= 2e-3, (scales, radius)


# --- the stream axis: B streams in one launch --------------------------------

@pytest.mark.parametrize("wy,wx", [(7, 102), (7, 7), (24, 16)])
def test_window_gather_streams_match_plain_and_2d(cuda, wy, wx):
    """[B, N] origins on [B, h, w] images, one launch: bit-equal to the plain
    version and, stream by stream, to the 2-D launch; one frame expanded over
    the streams (stride 0) equals B copies of it."""
    b, h, w, n = 5, 61, 97, 200
    g = torch.Generator().manual_seed(wx)
    imgs = torch.rand((b, h, w), generator=g).to(cuda)
    oy = torch.randint(-20, h + 10, (b, n), generator=g,
                       dtype=torch.int32).to(cuda)
    ox = torch.randint(-110, w + 10, (b, n), generator=g,
                       dtype=torch.int32).to(cuda)
    before = wg.launch_count()
    out = wg.gather_windows(imgs, oy, ox, wy, wx)
    torch.cuda.synchronize()
    assert wg.launch_count() == before + 1
    assert out.shape == (b, n, wy, wx)
    assert torch.equal(out, wg.gather_windows_reference(imgs, oy, ox, wy, wx))
    for i in range(b):
        assert torch.equal(out[i], wg.gather_windows(imgs[i], oy[i], ox[i],
                                                     wy, wx))
    shared = imgs[2].expand(b, h, w)
    assert torch.equal(wg.gather_windows(shared, oy, ox, wy, wx),
                       wg.gather_windows(shared.contiguous(), oy, ox, wy, wx))
    with pytest.raises(ValueError, match="stack"):
        wg.gather_windows(imgs[::2], oy[::2].contiguous(),
                          ox[::2].contiguous(), wy, wx)
    with pytest.raises(ValueError, match="origins"):
        wg.gather_windows(imgs, oy[:3].contiguous(), ox[:3].contiguous(),
                          wy, wx)


def _klt_streams(dev, b=4):
    """b streams of ``_klt_scene``'s kind, each with its own shift of the
    texture and its own tracks."""
    tex = simulate.noise_texture(np.random.default_rng(3), size=256)
    shifts = [(2, -3), (0, 1), (-1, 2), (1, 1), (-2, 0)][:b]
    f0 = np.stack([tex[40 + 5 * i:168 + 5 * i, 50:210]
                   for i in range(b)]).astype(np.float32)
    f1 = np.stack([tex[40 + 5 * i + sy:168 + 5 * i + sy, 50 + sx:210 + sx]
                   for i, (sy, sx) in enumerate(shifts)]).astype(np.float32)
    rng = np.random.default_rng(1)
    ys = torch.from_numpy(rng.uniform(0, 127, (b, 256)).astype(np.float32))
    xs = torch.from_numpy(rng.uniform(0, 159, (b, 256)).astype(np.float32))
    ys, xs = ys.to(dev), xs.to(dev)
    scales = (1, 2, 4)
    p0 = pyramid_ops.pyramid_average(torch.from_numpy(f0).to(dev),
                                     PyramidConfig(scales))
    p1 = pyramid_ops.pyramid_average(torch.from_numpy(f1).to(dev),
                                     PyramidConfig(scales))
    tm = klt.sample_templates(p0, pyramid_ops.gradient(p0), ys, xs, scales, 3)
    return p1, tm, ys, xs, scales


@pytest.mark.parametrize("shared", [False, True])
def test_klt_track_streams_match_plain_and_2d(cuda, shared):
    """[B, N] tracks in one launch, on a stack of frames or on one frame
    expanded over the streams: against the plain version as the 2-D launch
    is held (fault codes equal on >= 99 % of tracks, positions within 2e-3 px
    where both track), and stream b bit-equal to the 2-D launch on stream
    b's data (the arithmetic per track is the same)."""
    cfg = klt.KltConfig()
    p1, tm, ys, xs, scales = _klt_streams(cuda)
    if shared:
        p1 = tuple(p[0].expand(p.shape) for p in p1)
        assert p1[0].stride(0) == 0
    before = kt.launch_count()
    gy, gx, gf = klt.track_pyramid(p1, tm, ys, xs, scales, cfg)
    torch.cuda.synchronize()
    assert kt.launch_count() == before + 1
    assert gy.shape == ys.shape and gf.dtype == torch.int32
    wy, wx, wf = klt.track_pyramid_reference(p1, tm, ys, xs, scales, cfg)
    assert int((gf == wf).sum()) >= 0.99 * gf.numel()
    ok = (gf == klt.TRACK_OK) & (wf == klt.TRACK_OK)
    assert int(ok[0].sum()) >= 64
    assert float((gy - wy).abs()[ok].max()) <= 2e-3
    assert float((gx - wx).abs()[ok].max()) <= 2e-3
    for i in range(ys.shape[0]):
        one = klt.KltTemplates(*(tuple(t[i] for t in seq) for seq in tm))
        oy, ox, of = klt.track_pyramid(tuple(p[i] for p in p1), one, ys[i],
                                       xs[i], scales, cfg)
        assert torch.equal(gy[i], oy) and torch.equal(gx[i], ox)
        assert torch.equal(gf[i], of)
    # the wrapper itself is strict: every other stream of a longer stack is
    # neither a contiguous stack nor one frame expanded
    strided = [p.contiguous().repeat(2, 1, 1)[::2] for p in p1]
    launches = kt.launch_count()
    with pytest.raises(ValueError, match="stack"):
        kt.klt_track_cuda(strided, list(tm.desc), list(tm.grad_x),
                          list(tm.grad_y), ys, xs, scales, 3,
                          cfg.max_iterations, cfg.max_per_pixel_error,
                          cfg.min_determinant, cfg.convergence_tol)
    with pytest.raises(ValueError, match="for ys"):
        kt.klt_track_cuda([p[:2].contiguous() for p in p1], list(tm.desc),
                          list(tm.grad_x), list(tm.grad_y), ys, xs, scales, 3,
                          cfg.max_iterations, cfg.max_per_pixel_error,
                          cfg.min_determinant, cfg.convergence_tol)
    assert kt.launch_count() == launches


# --- the redesigned kernels: every template instantiation ------------------

def _hold_klt(got, want, n_min_ok=1):
    """Held as the 2-D launch is: faults equal on >= 99 % of tracks,
    positions within 2e-3 px where both track."""
    (gy, gx, gf), (wy, wx, wf) = got[:3], want[:3]
    assert int((gf == wf).sum()) >= 0.99 * gf.numel(), torch.nonzero(gf != wf)
    ok = (gf == klt.TRACK_OK) & (wf == klt.TRACK_OK)
    assert int(ok.sum()) >= n_min_ok
    if bool(ok.any()):
        assert float((gy - wy).abs()[ok].max()) <= 2e-3
        assert float((gx - wx).abs()[ok].max()) <= 2e-3
    assert bool(torch.isfinite(gy).all() and torch.isfinite(gx).all())


@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5, 6, 7])
def test_klt_track_every_radius(cuda, radius):
    """Every radius the kernel takes, so every instantiation: the 24x16
    window with two patch pixels a lane up to 7x7 and eight a lane for 9x9
    to 13x13, the 32x32 window for 15x15.  Against the plain version."""
    tex = simulate.noise_texture(np.random.default_rng(6), size=300)
    f0 = torch.from_numpy(tex[20:260, 30:290].copy()).to(cuda)
    f1 = torch.from_numpy(tex[21:261, 28:288].copy()).to(cuda)
    rng = np.random.default_rng(radius)
    ys = torch.from_numpy(rng.uniform(0, 239, 300).astype(np.float32)).to(cuda)
    xs = torch.from_numpy(rng.uniform(0, 259, 300).astype(np.float32)).to(cuda)
    scales = (1, 2, 4)
    cfg = klt.KltConfig(template_radius=radius)
    p0 = pyramid_ops.pyramid_average(f0, PyramidConfig(scales))
    p1 = pyramid_ops.pyramid_average(f1, PyramidConfig(scales))
    tm = klt.sample_templates(p0, pyramid_ops.gradient(p0), ys, xs, scales,
                              radius)
    args = ([wg.as_planes(p) for p in p1], list(tm.desc), list(tm.grad_x),
            list(tm.grad_y), ys, xs, scales, radius, cfg.max_iterations,
            cfg.max_per_pixel_error, cfg.min_determinant,
            cfg.convergence_tol)
    got = kt.klt_track_cuda(*args)
    want = klt.track_pyramid_reference(p1, tm, ys, xs, scales, cfg)
    torch.cuda.synchronize()
    _hold_klt(got, want, 20)
    assert int(got[3].min()) >= 1
    assert int(got[3].max()) <= len(scales) * cfg.max_iterations


def test_klt_track_level_smaller_than_its_window(cuda):
    """Levels of 40x60, 20x30 and 10x15 (the last two smaller than the 24x16
    window, the last in both sides; 8x8 is the least the template sampler
    takes): the window's clamped reads replicate the edges, as the plain
    version's gather does."""
    tex = simulate.noise_texture(np.random.default_rng(8), size=96)
    f0 = torch.from_numpy(tex[10:50, 5:65].copy()).to(cuda)
    f1 = torch.from_numpy(tex[11:51, 4:64].copy()).to(cuda)
    rng = np.random.default_rng(9)
    ys = torch.from_numpy(rng.uniform(0, 39, 64).astype(np.float32)).to(cuda)
    xs = torch.from_numpy(rng.uniform(0, 59, 64).astype(np.float32)).to(cuda)
    scales = (1, 2, 4)
    cfg = klt.KltConfig()
    p0 = pyramid_ops.pyramid_average(f0, PyramidConfig(scales))
    p1 = pyramid_ops.pyramid_average(f1, PyramidConfig(scales))
    (h1, _), (h2, w2) = p1[1].shape, p1[2].shape
    assert h1 < 24 and h2 < 24 and w2 < 16
    tm = klt.sample_templates(p0, pyramid_ops.gradient(p0), ys, xs, scales, 3)
    before = kt.launch_count()
    got = klt.track_pyramid(p1, tm, ys, xs, scales, cfg)
    assert kt.launch_count() == before + 1
    want = klt.track_pyramid_reference(p1, tm, ys, xs, scales, cfg)
    torch.cuda.synchronize()
    _hold_klt(got, want)


def test_klt_track_256_streams_on_a_shared_frame(cuda):
    """[256, 512] tracks on one frame expanded over the streams (the batched
    runner's shape), each stream with its own tracks: one launch, held to
    the plain version, and every stream bit-equal to its own 2-D launch."""
    tex = simulate.noise_texture(np.random.default_rng(10), size=320)
    f0 = torch.from_numpy(tex[:240, :300].copy()).to(cuda)
    f1 = torch.from_numpy(tex[2:242, 1:301].copy()).to(cuda)
    b, n = 256, 512
    rng = np.random.default_rng(11)
    ys = torch.from_numpy(rng.uniform(4, 235, (b, n)).astype(np.float32))
    xs = torch.from_numpy(rng.uniform(4, 295, (b, n)).astype(np.float32))
    ys, xs = ys.to(cuda), xs.to(cuda)
    scales = (1, 2, 4)
    cfg = klt.KltConfig()
    p0 = pyramid_ops.pyramid_average(f0.expand(b, 240, 300),
                                     PyramidConfig(scales))
    p1 = pyramid_ops.pyramid_average(f1.expand(b, 240, 300),
                                     PyramidConfig(scales))
    assert all(p.stride(0) == 0 for p in p1)
    tm = klt.sample_templates(p0, pyramid_ops.gradient(p0), ys, xs, scales, 3)
    before = kt.launch_count()
    gy, gx, gf = klt.track_pyramid(p1, tm, ys, xs, scales, cfg)
    assert kt.launch_count() == before + 1
    want = klt.track_pyramid_reference(p1, tm, ys, xs, scales, cfg)
    torch.cuda.synchronize()
    _hold_klt((gy, gx, gf), want, b * n // 2)
    for i in range(b):
        one = klt.KltTemplates(*(tuple(t[i] for t in seq) for seq in tm))
        oy, ox, of = klt.track_pyramid(tuple(p[i] for p in p1), one, ys[i],
                                       xs[i], scales, cfg)
        assert torch.equal(gy[i], oy) and torch.equal(gx[i], ox), i
        assert torch.equal(gf[i], of), i


def _near_midpoint_pairs(rng, count):
    """(a, b, c) with 24-bit integer mantissas whose quotients a / b and
    c / b lie within about 2^-48 of a midpoint of the float grid (A * 2^s
    = M * B + r with M odd and |r| <= 3), the nearest two floats' quotients
    come; scaled by random powers of two and signs."""
    out = []
    while len(out) < count:
        bm = int(rng.integers(2 ** 23, 2 ** 24)) | 1
        found = []
        for s in (24, 25):
            inv = pow(2 ** s, -1, bm)
            for r in (1, -1, 2, -2, 3, -3):
                am = (r * inv) % bm
                m, rem = divmod(am * 2 ** s - r, bm)
                if (rem == 0 and m % 2 == 1 and 2 ** 23 <= am < 2 ** 24
                        and 2 ** (s - 1) <= m < 2 ** s):
                    found.append(am)
        if len(found) >= 2:
            out.append((found[0], bm, found[1]))
    a, b, c = (np.array(v, dtype=np.float64) for v in zip(*out))
    ea, eb = rng.integers(-60, 60, count), rng.integers(-60, 60, count)
    sign = lambda: rng.choice([-1.0, 1.0], count)
    return ((sign() * np.ldexp(a, ea)).astype(np.float32),
            (sign() * np.ldexp(b, eb)).astype(np.float32),
            (sign() * np.ldexp(c, ea)).astype(np.float32))


def test_klt_step_quotients_are_float_divisions(cuda):
    """The kernel's Gauss-Newton step and mean |error| divide through the
    divisor's double reciprocal (see csrc/klt_track.cu); on the card its
    quotient() and quotients() equal the float division bit for bit: on
    quotients nearest a rounding boundary, on random ones over the whole
    exponent range, on subnormal and tiny ones about the 2^-125 guard,
    overflowing ones and zeros."""
    rng = np.random.default_rng(13)
    near = _near_midpoint_pairs(rng, 4096)
    bits = lambda n: rng.integers(0, 2 ** 31, n, dtype=np.int64)
    rand = [(bits(1 << 16) | rng.choice([0, 1 << 31], 1 << 16))
            .astype(np.uint32).view(np.float32) for _ in range(3)]
    big = np.float32(3e38)
    tiny_a = np.ldexp(rng.uniform(1, 2, 4096), rng.integers(-149, -100, 4096))
    tiny_b = np.ldexp(rng.uniform(1, 2, 4096), rng.integers(-30, 30, 4096))
    edge = [tiny_a.astype(np.float32), tiny_b.astype(np.float32),
            np.resize(np.float32([0.0, -0.0, big, -big, 1e-45, 1.5e-38]),
                      4096)]
    a, b, c = (np.concatenate(v) for v in zip(near, rand, edge))
    keep = np.isfinite(a) & np.isfinite(b) & np.isfinite(c) & (b != 0)
    a, b, c = a[keep], b[keep], c[keep]
    n = a.size
    with np.errstate(over="ignore", under="ignore"):
        want = np.concatenate([a / b, a / b, c / b])
    lib = kt._KERNEL.library()
    fn = lib.klt_quotient_test_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    da, db, dc = (torch.from_numpy(v).to(cuda) for v in (a, b, c))
    q = torch.empty(3 * n, dtype=torch.float32, device=cuda)
    err = fn(da.data_ptr(), db.data_ptr(), dc.data_ptr(), q.data_ptr(), n,
             torch.cuda.current_stream(cuda).cuda_stream)
    assert err == 0, lib.klt_track_error_string(err)
    got = q.cpu().numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
        np.nonzero(got.view(np.uint32) != want.view(np.uint32))
    tiny = np.abs(want) < 2.0 ** -125
    assert 1000 < int(tiny.sum()) < 3 * n   # the guard's branch was taken


@pytest.mark.parametrize("wy,wx", [(7, 102), (7, 7), (24, 16), (5, 33)])
def test_window_gather_every_shape_bit_equal(cuda, wy, wx):
    """The three compiled shapes and one taking the run-time path, on one
    frame and at [256, 512] on a shared frame and on a stack: bit-equal to
    the plain version and, stream by stream, to the 2-D launch."""
    h, w = 480, 640
    g = torch.Generator().manual_seed(wy * 1000 + wx)
    frames = torch.rand((4, h, w), generator=g).to(cuda)
    oy = torch.randint(-10, h + 5, (256, 512), generator=g,
                       dtype=torch.int32).to(cuda)
    ox = torch.randint(-110, w + 5, (256, 512), generator=g,
                       dtype=torch.int32).to(cuda)
    one = wg.gather_windows(frames[0], oy[0], ox[0], wy, wx)
    assert torch.equal(one, wg.gather_windows_reference(frames[0], oy[0],
                                                        ox[0], wy, wx))
    for imgs in (frames[0].expand(256, h, w),
                 frames.repeat(64, 1, 1)):
        before = wg.launch_count()
        out = wg.gather_windows(imgs, oy, ox, wy, wx)
        assert wg.launch_count() == before + 1
        assert torch.equal(out, wg.gather_windows_reference(imgs, oy, ox,
                                                             wy, wx))
        for i in (0, 1, 127, 255):
            assert torch.equal(out[i], wg.gather_windows(
                imgs[i].contiguous(), oy[i], ox[i], wy, wx))


@pytest.mark.parametrize("strict", [True, False])
def test_nonmax_mask_on_card_equals_cpu(cuda, strict):
    """``extract.nonmax_mask`` with either ``strict`` on the card equals
    the CPU's mask, a plateau and a near-tie peak included."""
    from boofcv_tpu_torch.feature import extract, intensity
    tex = simulate.noise_texture(np.random.default_rng(12), size=256)
    img = torch.from_numpy(np.round(tex[:120, :160]).copy())
    inten = intensity.shi_tomasi(img, radius=2)
    top = float(inten.max())
    inten[40:44, 50:54] = top * 1.5
    inten[80, 100] = top * 2.0
    inten[81, 100] = float(np.float32(top * 2.0) * np.float32(1 + 1e-6))
    for radius, border in ((2, 0), (4, 14)):
        cpu = extract.nonmax_mask(inten, radius, 1.0, border, strict=strict)
        card = extract.nonmax_mask(inten.to(cuda), radius, 1.0, border,
                                   strict=strict)
        assert torch.equal(card.cpu(), cpu)
        assert bool(cpu[81, 100]) != strict


def _ba_scene(dtype, device, model="normalized", V=8, P=120, L=5, seed=0):
    """A small seeded BA problem: forward motion, 3 to L observations a
    point, noise 5e-4 of the focal length, the initial guess perturbed."""
    from boofcv_tpu_torch.geo import ba
    rng = np.random.default_rng(seed)
    f = {"normalized": 1.0, "pinhole_f": 450.0, "snavely": -500.0}[model]
    pts = np.stack([rng.uniform(-2, 2, P), rng.uniform(-2, 2, P),
                    rng.uniform(4, 8, P)], 1)
    ts = np.stack([[-0.3 * v, 0.02 * v, -0.05 * v] for v in range(V)])
    Rs = np.tile(np.eye(3), (V, 1, 1))
    if model == "snavely":                  # looks down -z
        pts, ts = pts * [1, 1, -1], ts * [1, 1, -1]
    views = np.stack([np.sort(rng.permutation(V)[:L]) for _ in range(P)])
    obs_valid = np.arange(L)[None, :] < rng.integers(3, L + 1, P)[:, None]
    pc = pts[:, None, :] + ts[views]
    obs_xy = np.abs(f) * pc[..., :2] / np.abs(pc[..., 2:]) \
        + rng.normal(0, 5e-4 * np.abs(f), (P, L, 2))
    obs_xy[~obs_valid] = 0.0
    intr = {"normalized": np.zeros((V, 0)), "pinhole_f": np.full((V, 1), 452.0),
            "snavely": np.tile([502.0, 0.0, 0.0], (V, 1))}[model]
    fixed = np.zeros(V, bool)
    fixed[:2] = True
    return ba.make_problem(
        Rs, ts + rng.normal(0, 0.01, ts.shape) * ~fixed[:, None],
        pts + rng.normal(0, 0.02, pts.shape), obs_xy,
        np.where(obs_valid, views, 0), obs_valid, intr=intr, model=model,
        fixed_views=fixed, dtype=dtype, device=device)


@pytest.mark.parametrize("model", ("normalized", "snavely", "pinhole_f"))
def test_ba_on_card_matches_cpu(cuda, model):
    """The float64 solve on the card against the same solve on the CPU:
    per-iteration costs within 1e-6 relative, poses and points within 1e-7;
    the float32 mixed solve ends within 5 % of the CPU's cost.  No host sync
    inside ``optimize``."""
    import warnings
    from boofcv_tpu_torch.geo import ba
    out = {}
    for dev in ("cpu", cuda):
        prob = _ba_scene(torch.float64, dev, model)
        out[str(dev)] = ba.optimize(prob, iterations=12)
    (cp, ci), (gp, gi) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(gi["costs"].cpu().numpy(), ci["costs"].numpy(),
                               rtol=1e-6)
    assert float(gi["final_cost"]) < 1e-2 * float(gi["initial_cost"])
    for k in ("R", "t", "points"):
        np.testing.assert_allclose(getattr(gp, k).cpu().numpy(),
                                   getattr(cp, k).numpy(), atol=1e-7)
    np.testing.assert_allclose(gp.intr.cpu().numpy(), cp.intr.numpy(),
                               rtol=1e-7)
    c32, g32 = (ba.optimize(_ba_scene(torch.float32, dev, model),
                            iterations=12)[1] for dev in ("cpu", cuda))
    assert abs(float(g32["final_cost"]) / float(c32["final_cost"]) - 1) < 0.05
    prob = _ba_scene(torch.float32, cuda, model)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ba.optimize(prob, iterations=3)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs, syncs


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_ba_on_card_repeats_bit_for_bit(cuda, dtype):
    """Two solves of one problem on the card give the same bits: every sum
    over views runs in an order fixed once per solve; the same sums by
    ``index_add_`` (atomics) agree only to rounding."""
    from boofcv_tpu_torch.geo import ba
    prob = _ba_scene(dtype, cuda, V=30, P=1500, L=8, seed=1)
    a, ia = ba.optimize(prob, iterations=8)
    b, ib = ba.optimize(prob, iterations=8)
    for k in ("R", "t", "points"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(ia["costs"], ib["costs"])
    assert float(ia["final_cost"]) < 1e-2 * float(ia["initial_cost"])
    Jv, _, _ = ba._jacobians(prob)
    order = ba._view_order(prob.obs_view, 30, prob.obs_valid)
    x = (Jv * Jv).sum(2)
    got = ba._sum_by_view(x, order)
    want = torch.zeros_like(got).index_add_(
        0, prob.obs_view.long().reshape(-1), x.reshape(-1, x.shape[-1]))
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_ba_on_card_table_without_a_note_reads_nothing_back(cuda):
    """A table made on the card (as the window BA and the shards make
    theirs) has no track-length note: ``optimize`` plans it as it is, with
    no host sync, and gives the costs of the noted table's solve (whose
    plan compacts and groups the points) within float64 rounding."""
    import warnings
    from boofcv_tpu_torch.geo import ba
    prob = _ba_scene(torch.float64, cuda, "snavely", V=12, P=600, L=6,
                     seed=3)
    bare = prob._replace(obs_valid=prob.obs_valid.clone())
    assert ba._track_lengths(bare.obs_valid) is None
    ba.optimize(bare, iterations=1)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, ib = ba.optimize(bare, iterations=4)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs, syncs
    _, ia = ba.optimize(prob, iterations=4)
    np.testing.assert_allclose(ib["costs"].cpu().numpy(),
                               ia["costs"].cpu().numpy(), rtol=1e-12)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_schur_fill_kernel_matches_plain_version(cuda, dtype, monkeypatch):
    """``kernels/schur_fill`` against the plain fill-in (``_pair_products``
    and ``_segment_sum`` on the CPU) on a bucketed plan with tracks of 3
    to 24 views and a budget small enough for many groups: the card's and
    the CPU's plans order the pairs alike, and each group's S agrees to
    the dtype's rounding (the kernel fuses a product's adds into fmas);
    one launch a group."""
    from boofcv_tpu_torch.geo import ba
    from boofcv_tpu_torch.kernels import schur_fill as sf
    monkeypatch.setattr(ba, "_PAIR_BYTES", 81 * 8 * 20000)
    V = 30
    plans = [ba._buckets(_ba_scene(dtype, dev, V=V, P=1500, L=24, seed=5), V)
             for dev in ("cpu", cuda)]
    assert len(plans[0].groups) > 2
    assert max(w for _, _, w, _ in plans[0].pieces) > 16
    rng = np.random.default_rng(6)
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    for g, (_, _, s0, s1, _) in enumerate(plans[0].groups):
        orders = [p.orders[g] for p in plans]
        assert torch.equal(orders[0].pair_perm, orders[1].pair_perm.cpu())
        assert torch.equal(plans[0].fills[g].runs,
                           plans[1].fills[g].runs.cpu())
        W, Y = (torch.from_numpy(rng.normal(size=(s1 - s0, 3, 9))).to(dtype)
                for _ in range(2))
        S = torch.from_numpy(rng.normal(size=(V * V, 9, 9))).to(dtype)
        want = S.clone()
        ba._fill_in(want, W, Y, orders[0], plans[0].fills[g])
        got = S.to(cuda)
        before = sf.launch_count()
        ba._fill_in(got, W.to(cuda), Y.to(cuda), orders[1], plans[1].fills[g])
        torch.cuda.synchronize()
        assert sf.launch_count() == before + 1
        err = float((got.cpu() - want).abs().max())
        assert err <= tol * float((want - S).abs().max()), (g, err)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_ba_with_the_schur_fill_kernel_repeats_and_syncs_nothing(
        cuda, dtype, monkeypatch):
    """``optimize`` on the card with tracks wider than 16 and several
    groups: ``schur_fill`` launches once a group an iteration, nothing is
    read back inside the solve (an error under the debug mode), and two
    solves give the same bits."""
    from boofcv_tpu_torch.geo import ba
    from boofcv_tpu_torch.kernels import schur_fill as sf
    monkeypatch.setattr(ba, "_PAIR_BYTES", 81 * 8 * 20000)
    prob = _ba_scene(dtype, cuda, V=30, P=1500, L=24, seed=7)
    groups = len(ba._buckets(prob, 30).groups)
    assert groups > 2
    ba.optimize(prob, iterations=1)
    torch.cuda.synchronize()
    before = sf.launch_count()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, ia = ba.optimize(prob, iterations=8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert sf.launch_count() == before + 8 * groups
    b, ib = ba.optimize(prob, iterations=8)
    for k in ("R", "t", "intr", "points"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(ia["costs"], ib["costs"])
    assert float(ia["final_cost"]) < 1e-2 * float(ia["initial_cost"])


def test_window_ba_on_card(cuda):
    """``SlidingWindowBA`` behind the VO on the card: one host sync a push,
    a refined window with finite poses and a cost that does not rise."""
    import warnings
    from boofcv_tpu_torch.sfm import stereo_vo, window_ba
    h, w, fx = 120, 160, 150.0
    k = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
    poses = []
    for i in range(5):
        a = 0.004 * i
        R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                      [-np.sin(a), 0.0, np.cos(a)]])
        poses.append((R, -R @ np.array([0.015 * i, 0.0, 0.06 * i])))
    frames = simulate.render_stereo_sequence(np.random.default_rng(0), k, 0.3,
                                             poses, h, w)
    cfg = stereo_vo.StereoVoConfig(num_tracks=256, pyramid_scales=(1, 2, 4),
                                   max_disparity=48, ransac_hypotheses=192,
                                   detect_radius=4)
    vo = stereo_vo.StereoVisualOdometry(cfg, k, 0.3, h, w, device=cuda)
    wba = window_ba.SlidingWindowBA(window=5, device=cuda)
    for left, right in frames:
        assert vo.process(left, right)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                wba.push(vo.state, fx, fx, w / 2, h / 2)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert len([c for c in caught if "called a synchronizing CUDA "
                    "operation" in str(c.message)]) == 1
    refined, info = wba.optimize()
    assert len(refined) == 5 and info["tracks"] >= 12
    assert all(np.isfinite(R).all() and np.isfinite(t).all()
               for R, t in refined)
    assert float(info["final_cost"]) <= float(info["initial_cost"])


# ---- the dense-image breadth modules: the card against the CPU ------------

def _int_pair(seed, h=64, w=96, dmax=16):
    """Integer-valued stereo pair of a smooth texture, true disparity 3 to
    dmax - 2 growing with the row."""
    rng = np.random.default_rng(seed)
    tex = rng.normal(0, 1, (h, w + dmax + 8))
    k = np.hanning(5) / np.hanning(5).sum()
    tex = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, tex)
    tex = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, tex)
    tex = np.round(128 + 60 * tex / tex.std()).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    disp = 3 + (dmax - 5) * yy // h
    return torch.from_numpy(tex[:, :w].copy()), torch.from_numpy(
        tex[yy, xx + disp].copy())


def _on_both(cuda, fn, *tensors):
    """fn on the CPU tensors and on their copies on the card (result moved
    back)."""
    to_cpu = lambda o: (o.cpu() if isinstance(o, torch.Tensor)
                        else type(o)(*(to_cpu(x) for x in o))
                        if hasattr(o, "_fields")
                        else tuple(to_cpu(x) for x in o))
    return fn(*tensors), to_cpu(fn(*(t.to(cuda) for t in tensors)))


def test_breadth_integer_paths_equal_the_cpu(cuda):
    """Census codes, Hamming costs with bit 31 in play, packed BRIEF words,
    the first-minimum rule of argmin and the census SGM aggregation (4 and
    8 paths) are the same integers on the card as on the CPU."""
    from boofcv_tpu_torch.feature import associate, describe, disparity
    from boofcv_tpu_torch.ip import census
    left, right = _int_pair(0)
    c, g = _on_both(cuda, census.dense5x5, left)
    assert torch.equal(c, g)
    rng = np.random.default_rng(1)
    words = torch.from_numpy(rng.integers(
        -2**31, 2**31, (2, 80, 4), dtype=np.int64).astype(np.int32))
    words[0, 0], words[0, 1], words[1, 0], words[1, 1] = 0, -1, -1, -2**31
    c, g = _on_both(cuda, associate.score_hamming, words[0], words[1])
    assert torch.equal(c, g) and c[0, 0] == 128
    c, g = _on_both(cuda, census.hamming_distance, words[0], words[1])
    assert torch.equal(c, g)
    definition = describe.brief_definition(64, 6, seed=3, device="cpu")
    ys = torch.from_numpy(rng.uniform(0, 63, 100).astype(np.float32))
    xs = torch.from_numpy(rng.uniform(0, 95, 100).astype(np.float32))
    c = describe.brief(left, ys, xs, definition)
    g = describe.brief(left.to(cuda), ys.to(cuda), xs.to(cuda),
                       describe.BriefDefinition(*(t.to(cuda)
                                                  for t in definition)))
    assert torch.equal(c, g.cpu()) and bool((c < 0).any())
    ties = torch.from_numpy(rng.integers(0, 3, (12, 30, 40)).astype(
        np.float32))
    ties[3] = ties[7] = 0.0
    c, g = _on_both(cuda, lambda t: torch.argmin(t, dim=0), ties)
    assert torch.equal(c, g)
    assert torch.equal(g, torch.from_numpy(np.argmin(ties.numpy(), axis=0)))
    cfg = disparity.DisparityConfig(max_disparity=16, radius_x=0, radius_y=0,
                                    error="census")
    for paths in (4, 8):
        c, g = _on_both(cuda, lambda l, r: disparity._aggregate(
            torch.clamp(disparity.cost_volume(l, r, cfg), max=1e5), 5.0,
            60.0, paths), left, right)
        assert torch.equal(c, g)
    c, g = _on_both(cuda, lambda l, r: disparity.sgm(
        l, r, disparity.SgmConfig(max_disparity=16)), left, right)
    assert torch.equal(c, g)


def test_breadth_float_paths_match_the_cpu(cuda):
    """BM (the prefix sums add in another order on the card: valid masks on
    99 %, 0.05 px on 99 %), blur 1e-6 relative, SURF detections as sets and
    descriptors to 1e-4, association indices exact, Horn-Schunck after 20
    iterations to 1e-4 px."""
    from boofcv_tpu_torch.feature import (associate, describe, disparity,
                                          fasthessian, flow)
    from boofcv_tpu_torch.ip import blur, integral
    left, right = _int_pair(2)
    c, g = _on_both(cuda, lambda l, r: disparity.block_match(
        l, r, disparity.DisparityConfig(max_disparity=16)), left, right)
    assert float(((c >= 0) == (g >= 0)).float().mean()) >= 0.99
    ok = (c >= 0) & (g >= 0)
    assert float(((c - g).abs()[ok] <= 0.05).float().mean()) >= 0.99
    c, g = _on_both(cuda, lambda l: blur.gaussian(l, sigma=1.5), left)
    assert float((c - g).abs().max()) <= 1e-6 * float(c.abs().max())

    def surf(img):
        ii = integral.transform(img)
        det = fasthessian.detect_multi_octave(ii, 40, 2)
        ang = describe.orientation_average_haar(ii, det.ys, det.xs,
                                                det.scales)
        return det, describe.surf(ii, det.ys, det.xs, det.scales, ang)
    (cd, cs), (gd, gs) = _on_both(cuda, surf, left)
    key = lambda det: torch.stack([det.ys, det.xs, det.scales], 1)[det.valid]
    ck, gk = key(cd), key(gd)
    assert ck.shape == gk.shape and len(ck) >= 20
    near = torch.cdist(gk, ck).argmin(1)
    assert float((gk - ck[near]).abs().max()) <= 1e-3
    assert float((gs[gd.valid] - cs[cd.valid][near]).abs().max()) <= 1e-4
    a, b = cs[cd.valid], cs[cd.valid].flip(0) + 0.01
    c, g = _on_both(cuda, lambda x, y: associate.associate_mutual(
        associate.score_euclidean_sq(x, y)), a, b)
    assert torch.equal(c.dst, g.dst) and torch.equal(c.valid, g.valid)
    c, g = _on_both(cuda, lambda x, y: associate.associate_mutual_tiled(
        x, y, tile=16), a, b)
    assert torch.equal(c.dst, g.dst) and torch.equal(c.valid, g.valid)
    (cu, cv), (gu, gv) = _on_both(cuda, lambda i1, i2: flow.horn_schunck(
        i1, i2, iterations=20), left, torch.roll(left, (1, 2), (0, 1)))
    assert float((cu - gu).abs().max()) <= 1e-4
    assert float((cv - gv).abs().max()) <= 1e-4


def test_breadth_makes_no_host_sync(cuda):
    """block_match, sgm, the SURF chain, association and Horn-Schunck make
    no synchronizing call (an error under the debug mode)."""
    from boofcv_tpu_torch.feature import (associate, describe, disparity,
                                          fasthessian, flow)
    from boofcv_tpu_torch.ip import integral
    left, right = (t.to(cuda) for t in _int_pair(3))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        disparity.block_match(left, right,
                              disparity.DisparityConfig(max_disparity=16))
        disparity.sgm(left, right, disparity.SgmConfig(max_disparity=16,
                                                       paths=8))
        ii = integral.transform(left)
        det = fasthessian.detect_multi_octave(ii, 40, 2)
        ang = describe.orientation_average_haar(ii, det.ys, det.xs,
                                                det.scales)
        desc = describe.surf(ii, det.ys, det.xs, det.scales, ang)
        associate.associate_mutual(associate.score_euclidean_sq(desc, desc),
                                   det.valid, det.valid)
        associate.associate_mutual_tiled(desc, desc, tile=32)
        flow.horn_schunck(left, right, iterations=3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# ---- the rest of the breadth surface: the card against the CPU ------------

def test_canny_on_card_equals_cpu(cuda):
    """Canny's mask (blur, Sobel, NMS and the hysteresis fixpoint) is the
    same on the card as on the CPU, and so is the trip count."""
    from boofcv_tpu_torch.feature import canny
    left, _ = _int_pair(4)
    c, g = _on_both(cuda, lambda x: canny.canny(x, 2.0, 8.0), left)
    assert torch.equal(c, g) and 0 < int(c.sum()) < c.numel()
    nms = canny._nms(left, -1.0, 2)
    assert canny._hysteresis(nms, 2.0, 8.0)[1] == canny._hysteresis(
        nms.to(cuda), 2.0, 8.0)[1]


@pytest.mark.parametrize("error", ["ssd", "sad"])
def test_sparse_costs_launch_window_gather(cuda, error):
    """The sparse SSD and SAD costs on the card read their windows through
    the kernel (two launches) and equal the same costs from the plain
    gather: SAD of integer images exactly where no 1e6 sentinel is summed
    (past 2^24 the sum rounds with its order), SSD to float32 rounding of
    the squares' sum."""
    from boofcv_tpu_torch.feature import disparity
    left, right = _int_pair(5)
    rng = np.random.default_rng(5)
    ys = torch.from_numpy(rng.integers(0, 64, 200).astype(np.int32))
    xs = torch.from_numpy(rng.integers(0, 96, 200).astype(np.int32))
    cfg = disparity.DisparityConfig(max_disparity=16, error=error)
    score = {"ssd": disparity._sparse_costs_ssd,
             "sad": disparity._sparse_costs_sad}[error]
    before = wg.launch_count()
    g = score(left.to(cuda), right.to(cuda), ys.to(cuda), xs.to(cuda), cfg)
    torch.cuda.synchronize()
    assert wg.launch_count() == before + 2
    c = score(left, right, ys, xs, cfg)
    if error == "sad":
        inside = c < 1e6
        assert bool(inside.any()) and torch.equal(c[inside], g.cpu()[inside])
    else:
        torch.testing.assert_close(g.cpu(), c, rtol=1e-6, atol=1e-3)
    d_c, v_c = disparity.sparse_block_match(left, right, ys, xs, cfg)
    d_g, v_g = disparity.sparse_block_match(left.to(cuda), right.to(cuda),
                                            ys.to(cuda), xs.to(cuda), cfg)
    assert float((v_c == v_g.cpu()).float().mean()) >= 0.99


def test_new_breadth_float_paths_match_the_cpu(cuda):
    """SIFT keypoints as sets (1e-3 px) and descriptors (1e-4 where both
    found the keypoint with one orientation), the three flows (1e-4 px;
    Brox on 99.5 % of the interior pixels and 1e-3 on all of them: its
    lagged weights carry the rounding of 20 sweeps; block flow exactly where
    no sentinel is in the window), and a RANSAC
    fundamental matrix with injected index sets (1e-9 up to sign)."""
    from boofcv_tpu_torch.feature import flow, sift
    from boofcv_tpu_torch.geo import robust
    left, _ = _int_pair(6)
    (ck, cd), (gk, gd) = _on_both(cuda, lambda x: sift.detect_describe(
        x, max_features=60, num_octaves=2), left)
    a = torch.stack([ck.ys, ck.xs], 1)[ck.valid]
    b = torch.stack([gk.ys, gk.xs], 1)[gk.valid]
    assert a.shape == b.shape and len(a) >= 5
    near = torch.cdist(b.double(), a.double()).argmin(1)
    assert float((b - a[near]).abs().max()) <= 1e-3
    same = (gd[gk.valid] - cd[ck.valid][near]).abs().amax(1) <= 1e-4
    assert float(same.float().mean()) >= 0.9
    moved = torch.roll(left, (1, 2), (0, 1))
    (cu, cv), (gu, gv) = _on_both(cuda, lambda i1, i2: flow.brox_warping(
        i1, i2, scales=(1, 2), outer_iterations=2, inner_iterations=10),
        left, moved)
    d = torch.maximum((cu - gu).abs(), (cv - gv).abs())[7:-7, 7:-7]
    assert float((d <= 1e-4).float().mean()) >= 0.995 and float(d.max()) <= 1e-3
    (cu, cv, cok), (gu, gv, gok) = _on_both(cuda, lambda i1, i2:
                                            flow.dense_klt(i1, i2,
                                                           scales=(1, 2)),
                                            left, moved)
    assert float((cok == gok).float().mean()) >= 0.999
    assert float((cu - gu).abs()[cok & gok].max()) <= 1e-4
    (cu, cv, cs), (gu, gv, gs) = _on_both(cuda, flow.block_flow, left, moved)
    inner = np.s_[7:-7, 7:-7]
    assert torch.equal(cs[inner], gs[inner]) and torch.equal(cu[inner],
                                                             gu[inner])
    rng = np.random.default_rng(6)
    p1 = torch.from_numpy(rng.uniform(0, 640, (200, 2)))
    p2 = p1 + torch.from_numpy(rng.normal(0, 0.3, (200, 2))) + 5.0
    idx = robust.sample_indices(torch.Generator().manual_seed(0), 64, 7, 200)
    c, g = _on_both(cuda, lambda x, y, i: robust.ransac_fundamental(
        None, x, y, num_hypotheses=64, idx=i), p1, p2, idx)
    sign = torch.sign((c.model[0] * g.model[0]).sum())
    torch.testing.assert_close(g.model[0] * sign, c.model[0], rtol=0,
                               atol=1e-9)
    assert torch.equal(c.inliers, g.inliers)


# ---- the other odometry families and 2-D motion: the card against the CPU --

FAMILIES = ("depth", "dual", "quad", "direct", "mono_plane", "overhead",
            "stitch2d", "PointTrackerKlt", "PointTrackerDda",
            "PointTrackerCombined", "PointTrackerTwoPassKlt")
# the hand kernels each family's card run must launch
FAMILY_KERNELS = {"depth": ("klt_track",),
                  "dual": ("klt_track", "window_gather"),
                  "mono_plane": ("klt_track",), "overhead": ("klt_track",),
                  "stitch2d": ("klt_track",), "PointTrackerKlt": ("klt_track",),
                  "PointTrackerCombined": ("klt_track",),
                  "PointTrackerTwoPassKlt": ("klt_track",)}


def _same_draws(monkeypatch):
    """RANSAC draws the same index sets on either device: the i-th call of
    a run draws from a CPU generator seeded i.  Returns a function that
    starts a run."""
    from boofcv_tpu_torch.geo import robust
    plain = robust.sample_indices
    calls = [0]

    def sample(generator, k, s, n, valid_mask=None):
        g = torch.Generator().manual_seed(calls[0])
        calls[0] += 1
        vm = None if valid_mask is None else valid_mask.cpu()
        idx = plain(g, k, s, n, vm)
        return idx if valid_mask is None else idx.to(valid_mask.device)

    monkeypatch.setattr(robust, "sample_indices", sample)
    return lambda: calls.__setitem__(0, 0)


def _drive_family(name: str, dev, n_frames: int = 3):
    """Three frames of one family at 240x320 on ``dev``: (the pose or
    motion it ends with, the track positions it ends with or None)."""
    import chip_smoke as cs
    from boofcv_tpu_torch.feature import point_tracker as pt
    from boofcv_tpu_torch.sfm import (depth_vo, direct_vo, dual_track_vo,
                                      mono_plane_vo, overhead_vo, quad_vo,
                                      stitch2d, stereo_vo)
    h, w = 240, 320
    k = np.array([[240.0, 0.0, 160.0], [0.0, 240.0, 120.0], [0.0, 0.0, 1.0]])
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    pose = lambda vo: np.concatenate([a.ravel() for a in vo.camera_to_world()])
    if name in ("depth", "dual", "quad", "direct"):
        poses, frames = cs._scene(n_frames, k, h, w, seed=0)
        pairs = [(on(l), on(r)) for l, r in frames]
        depths = cs.plane_depths(poses, k, h, w)
        vo = {"depth": lambda: depth_vo.DepthVisualOdometry(
                  stereo_vo.StereoVoConfig(), k, h, w, device=dev),
              "dual": lambda: dual_track_vo.DualTrackVisualOdometry(
                  dual_track_vo.DualTrackVoConfig(), k, cs.BASELINE,
                  device=dev),
              "quad": lambda: quad_vo.QuadVisualOdometry(
                  quad_vo.QuadVoConfig(), k, cs.BASELINE, device=dev),
              "direct": lambda: direct_vo.DirectDepthVisualOdometry(
                  k, device=dev)}[name]()
        for (l, r), d in zip(pairs, depths):
            assert vo.process(l, on(d) if name in ("depth", "direct") else r)
        s = getattr(vo, "state", None)
        if name == "depth":
            tracks = torch.stack([s.xs, s.ys], 1)[s.alive]
        elif name == "dual":
            tracks = torch.stack([s.lxs, s.lys, s.rxs, s.rys], 1)[s.alive]
        else:
            tracks = None
        return pose(vo), None if tracks is None else tracks.cpu().numpy()
    if name == "mono_plane":
        _, frames = cs.mono_plane_scene(k, h, w, n_frames)
        vo = mono_plane_vo.MonoPlaneVisualOdometry(k, (0.0, 0.0, 1.0), 4.0,
                                                   device=dev)
        for f in frames:
            assert vo.process(on(f))
        return pose(vo), torch.stack(vo._tracks[:2], 1).cpu().numpy()
    if name == "overhead":
        Rp, tp, frames = cs.overhead_scene(k, h, w, n_frames)
        vo = overhead_vo.MonoOverheadVisualOdometry(k, Rp, tp, h, w,
                                                    device=dev)
        for f in frames:
            assert vo.process(on(f))
        return (np.array(vo.plane_motion()),
                torch.stack(vo._tracks[:2], 1).cpu().numpy())
    if name == "stitch2d":
        _, frames = cs.sliding_frames(h, w, n_frames, 0, 12, seed=0)
        st = stitch2d.Stitcher(h + 40, w + 80, offset=(20.0, 20.0),
                               device=dev)
        for f in frames:
            assert st.process(on(f))
        ys, xs, valid = st._tracks
        return (st.H_mosaic_from_frame.ravel(),
                torch.stack([ys, xs], 1)[valid].cpu().numpy())
    _, frames = cs.sliding_frames(h, w, n_frames, 1, 2, seed=7)
    tracker = getattr(pt, name)(device=dev)
    for i, f in enumerate(frames):
        tracker.process(on(f))
        if name == "PointTrackerTwoPassKlt":
            tracker.second_pass(tracker.ys - 1, tracker.xs - 2)
            tracker.finish()
        if i == 0:
            tracker.spawn()
    active = tracker.active_tracks()
    return None, np.array([(t.uid, t.x, t.y) for t in active])


@pytest.mark.parametrize("name", FAMILIES)
def test_family_on_card_matches_cpu(cuda, name, monkeypatch):
    """Three frames of each front end on the card and on the CPU from the same
    inputs and the same RANSAC index sets: the pose within 1e-5 (the plane
    motion of the overhead VO in meters, the stitcher's homography entries)
    and the tracks within 1e-3 px.  SURF on the card sums its float32
    integral image in another order, which moves positions by up to 1e-2
    px: there the pose within 1e-3 and the tracks as sets.  The card run
    launches the hand kernels of its path."""
    start = _same_draws(monkeypatch)
    start()
    cpu = _drive_family(name, torch.device("cpu"))
    start()
    kt.reset_launch_count()
    wg.reset_launch_count()
    card = _drive_family(name, cuda)
    torch.cuda.synchronize()
    launched = {"klt_track": kt.launch_count(),
                "window_gather": wg.launch_count()}
    for kernel in FAMILY_KERNELS.get(name, ()):
        assert launched[kernel] > 0, (name, kernel)
    surf = name in ("quad", "PointTrackerDda", "PointTrackerCombined")
    if cpu[0] is not None:
        np.testing.assert_allclose(card[0], cpu[0], atol=1e-3 if surf else
                                   1e-5, rtol=0)
    if cpu[1] is None:
        return
    if not surf:
        assert card[1].shape == cpu[1].shape
        np.testing.assert_allclose(card[1], cpu[1], atol=1e-3, rtol=0)
        return
    # SURF detections as sets of positions, but for 2 % of either side (a
    # response that the prefix sums' rounding moves across the threshold,
    # and the association that follows it)
    a, b = card[1][:, -2:], cpu[1][:, -2:]
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    spare = max(len(a), len(b)) // 50
    assert len(b) > 100
    assert (d.min(1) > 1e-2).sum() <= spare
    assert (d.min(0) > 1e-2).sum() <= spare


@pytest.mark.parametrize("name", FAMILIES)
def test_family_asks_for_the_card(name, monkeypatch):
    """Without CUDA a front end asked for the card (no ``device``) raises."""
    from boofcv_tpu_torch.feature import point_tracker as pt
    from boofcv_tpu_torch.sfm import (depth_vo, direct_vo, dual_track_vo,
                                      mono_plane_vo, overhead_vo, quad_vo,
                                      stitch2d, stereo_vo)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    k = np.eye(3)
    make = {"depth": lambda: depth_vo.DepthVisualOdometry(
                stereo_vo.StereoVoConfig(num_tracks=4), k, 8, 8),
            "dual": lambda: dual_track_vo.DualTrackVisualOdometry(
                dual_track_vo.DualTrackVoConfig(num_tracks=4), k, 0.1),
            "quad": lambda: quad_vo.QuadVisualOdometry(
                quad_vo.QuadVoConfig(num_features=4), k, 0.1),
            "direct": lambda: direct_vo.DirectDepthVisualOdometry(k),
            "mono_plane": lambda: mono_plane_vo.MonoPlaneVisualOdometry(
                k, (0.0, 0.0, 1.0), 1.0),
            "overhead": lambda: overhead_vo.MonoOverheadVisualOdometry(
                k, np.eye(3), np.ones(3), 8, 8, overhead_shape=(4, 4)),
            "stitch2d": lambda: stitch2d.Stitcher(8, 8)}
    with pytest.raises(RuntimeError, match="CUDA"):
        make.get(name, lambda: getattr(pt, name)(max_tracks=4))()


@pytest.mark.parametrize("name", ["PointTrackerKlt",
                                  "PointTrackerTwoPassKlt"])
def test_family_beyond_klt_track_limits_raises(cuda, name):
    """A path that asks ``klt_track`` for more than it takes (a 17x17
    template) raises on the card; it does not drop to the plain version."""
    import chip_smoke as cs
    from boofcv_tpu_torch.feature import point_tracker as pt
    _, frames = cs.sliding_frames(240, 320, 2, 1, 2, seed=7)
    frames = [torch.from_numpy(f).to(cuda) for f in frames]
    tracker = getattr(pt, name)(template_radius=8, device=cuda)
    tracker.process(frames[0])
    tracker.spawn()
    with pytest.raises(ValueError, match="template_radius 8"):
        tracker.process(frames[1])


# ---- multi-view geometry and SfM ---------------------------------------

def _poses_close(a, b, tol):
    assert sorted(a) == sorted(b)
    for v in a:
        np.testing.assert_allclose(a[v][0], b[v][0], atol=tol)
        np.testing.assert_allclose(a[v][1], b[v][1], atol=tol)


def test_sfm_incremental_on_card_matches_cpu(cuda, monkeypatch):
    """``build_pairwise_graph`` + ``reconstruct_incremental`` on the card and
    on the CPU with the same index sets.  The graph (float64 Nister, refits
    and cheirality) gives the same edges and inliers and poses within 1e-5.
    The growth's PnP RANSAC scores in float32 against a hard gate, as the
    reference does, and the card's float32 P3P rounds otherwise: a point
    within rounding of the gate can change sides (seen on the card: 314
    against 316 inliers, errors 2.55e-5 and 2.50e-5 against 2e-5), and the
    later views register, triangulate and bundle other observations.  The
    grown scenes then differ by the scene's own estimation spread (seen on
    the card: a far view's translation 0.079 of 2.9 apart), so each is held
    to the truth as the reference test holds it: every view registered,
    centres within 2 % of the span after a similarity alignment."""
    import chip_smoke as cs
    from boofcv_tpu_torch.sfm import reconstruction
    k = np.array([[240.0, 0, 160.0], [0, 240.0, 120.0], [0, 0, 1.0]])
    poses, feats = cs.incremental_scene(5, 200, k=k, h=240, w=320)
    out = {}
    start = _same_draws(monkeypatch)
    for dev in ("cpu", cuda):
        start()
        g = reconstruction.build_pairwise_graph(
            list(range(5)), k, detect=lambda i: feats[i], device=dev)
        out[str(dev)] = g, reconstruction.reconstruct_incremental(
            g, k, device=dev)
    (gc, sc), (gg, sg) = out["cpu"], out[str(cuda)]
    assert sorted(gc.edges) == sorted(gg.edges)
    for key, e in gc.edges.items():
        assert np.array_equal(e.inliers, gg.edges[key].inliers)
        np.testing.assert_allclose(gg.edges[key].R, e.R, atol=1e-5)
        np.testing.assert_allclose(gg.edges[key].t, e.t, atol=1e-5)
    assert sc["views"] == sg["views"] == list(range(5))
    for scene in (sc, sg):
        err, span = cs._centre_error(poses,
                                     [scene["poses"][v] for v in range(5)])
        assert err < 0.02 * span, (err, span)


def test_sfm_uncalibrated_on_card_matches_cpu(cuda, monkeypatch):
    """``reconstruct_uncalibrated`` on the orbit scene (6 views, 320x240)
    on both devices with the same index sets: focal within 1e-5 relative,
    poses within 1e-5."""
    import chip_smoke as cs
    from boofcv_tpu_torch.sfm import structure2
    _, feats = cs.orbit_scene(6, 200, h=240, w=320, f=280.0)
    imgs = [np.zeros((240, 320), np.float32)] * 6
    out = {}
    start = _same_draws(monkeypatch)
    for dev in ("cpu", cuda):
        start()
        it = iter(feats)
        out[str(dev)] = structure2.reconstruct_uncalibrated(
            imgs, detect=lambda im: next(it), device=dev)
    c, g = out["cpu"], out[str(cuda)]
    assert abs(g["K"][0, 0] - c["K"][0, 0]) < 1e-5 * c["K"][0, 0]
    _poses_close(c["poses"], g["poses"], 1e-5)


def _relative_poses(Rs, ts):
    """Rotations and centres of views 1.. in view 0's frame, centres over
    the first baseline: what a metric scene fixes (its world frame and scale
    are the self-calibration's choice, and that rests on eigenvector signs,
    which differ between cuSOLVER and LAPACK)."""
    c = np.stack([-R.T @ t for R, t in zip(Rs, ts)])
    d = (c[1:] - c[0]) @ Rs[0].T
    return np.stack([R @ Rs[0].T for R in Rs[1:]]), \
        d / np.linalg.norm(d[0])


def test_three_view_on_card_matches_cpu(cuda):
    """``estimate_metric_scene`` on 300 triples with 20 % outliers, the same
    index sets on both devices: the same inliers, the focal within 1e-5
    relative, and the poses (relative to view 0, at the first baseline's
    scale) within 1e-5."""
    import chip_smoke as cs
    from boofcv_tpu_torch.sfm import three_view
    views, _ = cs.three_view_scene(300, 0.2)
    idx = torch.stack([torch.randperm(300, generator=torch.Generator()
                                      .manual_seed(i))[:8]
                       for i in range(256)])
    res = [three_view.estimate_metric_scene(*views, (480, 640), idx=idx,
                                            device=dev)
           for dev in ("cpu", cuda)]
    assert np.array_equal(res[0].inliers, res[1].inliers)
    assert abs(res[0].K[0, 0] - res[1].K[0, 0]) < 1e-5 * res[0].K[0, 0]
    for a, b in zip(_relative_poses(res[1].Rs, res[1].ts),
                    _relative_poses(res[0].Rs, res[0].ts)):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_eigh_takes_large_batches(cuda):
    """A batch of 4x4 matrices larger than cuSOLVER's batched solver takes
    goes in chunks, each matrix as it would alone."""
    from boofcv_tpu_torch.geo import smalllinalg
    g = torch.Generator(device=cuda).manual_seed(0)
    A = torch.randn((3, smalllinalg._EIGH_BATCH, 4, 4), generator=g,
                    device=cuda, dtype=torch.float64)
    w, v = smalllinalg._eigh_sym(A)
    w1, v1 = smalllinalg._eigh_sym(A[1, :100])
    assert w.shape == (3, smalllinalg._EIGH_BATCH, 4)
    torch.testing.assert_close(w[1, :100], w1)
    S = 0.5 * (A + A.transpose(-1, -2))
    torch.testing.assert_close(S @ v, v * w[..., None, :])


def test_pose_graph_on_card_repeats_bit_for_bit(cuda):
    """Two card solves of the 300-pose graph give the same bits, and the
    poses agree with the CPU's within 1e-9."""
    import chip_smoke as cs
    from boofcv_tpu_torch.sfm import pose_graph
    Rp, tp, edges = cs.pose_graph_scene(300, 30)
    g = pose_graph.make_graph(Rp, tp, edges, device=cuda)
    a, ca = pose_graph.optimize(g, iterations=10)
    b, cb = pose_graph.optimize(g, iterations=10)
    assert torch.equal(a.R, b.R) and torch.equal(a.t, b.t) \
        and torch.equal(ca, cb)
    c, _ = pose_graph.optimize(pose_graph.make_graph(Rp, tp, edges,
                                                     device="cpu"),
                               iterations=10)
    np.testing.assert_allclose(a.t.cpu().numpy(), c.t.numpy(), atol=1e-9)


def test_spherical_and_cloud_on_card_match_cpu(cuda):
    """The 360 round trip at 320x240 and k-NN on 2,048 points on both
    devices: images within 1e-2 grey levels, neighbour sets equal on 99.9 %
    of the queries."""
    import chip_smoke as cs
    from boofcv_tpu_torch.geo import cloud, spherical
    cam, Rs, views = cs.spherical_scene(240, 320, 240.0)
    out = []
    for dev in ("cpu", cuda):
        imgs = [torch.from_numpy(v).to(dev) for v in views]
        canvas = spherical.multi_camera_to_equi(imgs, [cam, cam], Rs,
                                                (256, 512))
        out.append(spherical.equi_to_pinhole(canvas, cam, Rs[0],
                                             (240, 320)).cpu().numpy())
    np.testing.assert_allclose(out[1], out[0], atol=1e-2)
    pts, q = cs.cloud_scene(2048)
    ic, _ = cloud.nearest_neighbors(q, pts, 8, device="cpu")
    ig, _ = cloud.nearest_neighbors(q, pts, 8, device=cuda)
    same = np.mean([set(a) == set(b) for a, b in
                    zip(ic.numpy(), ig.cpu().numpy())])
    assert same >= 0.999
    assert torch.equal(cloud.filter_radius_outliers(pts, 8, 1.0,
                                                    device="cpu"),
                       cloud.filter_radius_outliers(pts, 8, 1.0,
                                                    device=cuda).cpu())


# ---- recognition: binary images, fiducials, QR codes, calibration targets

def test_label_blobs_on_card_equals_native_ccl(cuda):
    """``label_blobs`` on the card (a sync every ``CHECK_EVERY`` sweeps)
    equals the native CCL, compact and raw numbering, and the CPU's."""
    import chip_smoke as cs
    from boofcv_tpu_torch import native
    from boofcv_tpu_torch.ip import binary, threshold
    img = torch.from_numpy(cs.binary_scene(240, 320))
    for eight in (True, False):
        bw = threshold.threshold(img, threshold.compute_otsu(img))
        lab = binary.label_blobs(bw.to(cuda), eight).cpu()
        assert torch.equal(lab, binary.label_blobs(bw, eight))
        ccl, _ = native.ccl(bw.numpy(), eight)
        np.testing.assert_array_equal(binary.relabel_compact(lab), ccl)
        thin = binary.thin(bw.to(cuda)).cpu()
        assert torch.equal(thin, binary.thin(bw))


def test_fiducial_detectors_on_card_equal_cpu(cuda):
    """``detect``, ``detect_image`` and ``estimate_pose`` on the card and
    the CPU: ids and rotations equal, corners within 1e-4 px, poses 1e-9."""
    import chip_smoke as cs
    from boofcv_tpu_torch.recognition import fiducial_square as fid
    frame, _, patterns = cs.fiducial_scene()
    out = {}
    for dev in ("cpu", cuda):
        img = torch.from_numpy(frame).to(dev)
        dets = fid.detect(img)
        out[str(dev)] = (dets, fid.detect_image(img, patterns),
                         fid.estimate_pose(dets[0]["corners"], cs.FID_SIDE,
                                           cs.REC_K, device=dev))
    assert len(out["cpu"][0]) == 8 and len(out["cpu"][1]) == 2
    assert cs._same_detection(out["cpu"][:2], out[str(cuda)][:2], 1e-4)
    assert cs._same_detection(out["cpu"][2], out[str(cuda)][2], 1e-9)


@pytest.mark.parametrize("version", [2, 10])
def test_qr_on_card_equals_cpu(cuda, version):
    import chip_smoke as cs
    from boofcv_tpu_torch.recognition.qr import detector
    frame, text = cs.qr_scene(version)
    got = detector.detect_and_decode(torch.from_numpy(frame).to(cuda))
    want = detector.detect_and_decode(frame, device="cpu")
    assert got[0] == want[0] == text.encode()
    assert cs._same_detection(got, want, 1e-4)


@pytest.mark.parametrize("target", ["chessboard", "square_grid",
                                    "circle_grid", "hex_grid"])
def test_calib_targets_on_card_equal_cpu(cuda, target):
    """Each target detector on two views on both devices: lattices equal,
    points within 1e-4 px."""
    import chip_smoke as cs
    from boofcv_tpu_torch.recognition import calib_targets as ct
    from boofcv_tpu_torch.recognition import chessboard as cb
    views, _, _ = cs.calib_scene(target)
    fns = {"chessboard": [cb.detect_chessboard_auto,
                          lambda im: cb.detect_chessboard(im, 7, 9)],
           "square_grid": [ct.detect_square_grid_auto,
                           lambda im: ct.detect_square_grid(im, 5, 7)],
           "circle_grid": [ct.detect_circle_regular_grid_auto,
                           lambda im: ct.detect_circle_regular_grid(im, 6,
                                                                    8)],
           "hex_grid": [ct.detect_circle_hexagonal_grid_auto,
                        lambda im: ct.detect_circle_hexagonal_grid(im, 9,
                                                                   13)]}
    for v in (2, 9):
        for fn in fns[target]:
            cpu = fn(torch.from_numpy(views[v]))
            card = fn(torch.from_numpy(views[v]).to(cuda))
            assert cpu is not None
            assert cs._same_detection(card, cpu, 1e-4)


# ---- the rest of ip/ and feature/ ------------------------------------------

def _both(fn, cuda, *arrays):
    """fn of the same numpy inputs on the CPU and on the card (back on the
    host)."""
    cpu = fn(*[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])
    card = fn(*[torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                for a in arrays])
    return cpu, card


def test_ip_rest_on_card_matches_cpu(cuda):
    """Colour, equalization (no host sync), wavelets, FFT filtering and
    MLS on the card against the CPU at 240x320."""
    import chip_smoke as cs
    from boofcv_tpu_torch.ip import color, enhance, fft, mls, wavelet
    rgb = cs.smooth_rgb(240, 320, seed=1)
    cpu, card = _both(lambda t: color.lab_to_rgb(color.rgb_to_lab(
        t / 255.0)), cuda, rgb)
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), atol=1e-5)
    low = np.round(rgb[..., 0] * 0.3 + 80).astype(np.float32)
    cpu, card = _both(enhance.equalize_histogram, cuda, low)
    assert torch.equal(card.cpu(), cpu)
    on_card = torch.from_numpy(low).to(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        enhance.equalize_histogram(on_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    clean, noisy = cs.denoise_scene(240, 320)
    for rule in ("denoise_visu", "denoise_bayes", "denoise_sure"):
        cpu, card = _both(lambda t, r=rule: getattr(wavelet, r)(t, levels=3),
                          cuda, noisy)
        np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(),
                                   atol=0.05)
    gray = rgb[..., 0]
    tr = fft.gaussian_lowpass_transfer(240, 320, 0.2, device="cpu")
    cpu, card = _both(lambda t: fft.filter_frequency(t, tr.to(t.device)),
                      cuda, gray)
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), atol=1e-3)
    src = np.array([[30.0, 40], [200, 50], [120, 180], [280, 200]],
                   np.float32)
    dst = src + np.array([[3.0, -2], [-4, 1], [0, 5], [2, 2]], np.float32)
    cpu, card = _both(lambda t: mls.deform(t, src, dst), cuda, gray)
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), atol=0.05)


def test_background_models_on_card_equal_cpu(cuda):
    import chip_smoke as cs
    from boofcv_tpu_torch.feature import background as bg
    frames, hs, masks, home = cs.moving_background_scene(12, 8, h=120,
                                                         w=160)
    out = []
    for dev in ("cpu", cuda):
        model = bg.moving_gmm_init(home, device=dev)
        segs = []
        for f, hm in zip(frames, hs):
            segs.append(bg.moving_gmm_segment(model, f, hm).cpu())
            model = bg.moving_gmm_update(model, f, hm)
        out.append(torch.stack(segs))
    assert torch.equal(out[0], out[1])


def test_segmentation_on_card_matches_cpu(cuda):
    """SLIC (agreement share: the centre sums' order), watershed (equal)
    and FH04 (equal) at 240x320 on both devices."""
    import chip_smoke as cs
    from boofcv_tpu_torch.feature import segmentation as seg
    img, _ = cs.segmentation_scene(240, 320)
    cpu, card = _both(lambda t: seg.slic(t, 100), cuda, img)
    assert (card.cpu() == cpu).float().mean() >= 0.99
    gray = img.mean(axis=2).astype(np.float32)
    markers = np.zeros((240, 320), np.int32)
    markers[::60, ::80] = np.arange(1, 17).reshape(4, 4)
    cpu, card = _both(seg.watershed, cuda, gray, markers)
    assert torch.equal(card.cpu(), cpu)
    (lc, nc), (lg, ng) = _both(lambda t: seg.segment_fh04(t, min_size=100),
                               cuda, img)
    assert nc == ng and (lc == lg).mean() >= 0.99


def test_lines_template_dense_on_card_match_cpu(cuda):
    import chip_smoke as cs
    from boofcv_tpu_torch.feature import dense, lines, template
    img, _ = cs.polygon_scene(240, 320)
    cpu, card = _both(lambda t: lines.hough_gradient(t, max_lines=5), cuda,
                      img)
    same_count, gap = cs._line_gap(cpu, card, 2 * 199.6 / 180)
    assert same_count and gap <= 1.0
    pairs = torch.randint(0, 48, (70, 64, 2),
                          generator=torch.Generator().manual_seed(0))
    cpu, card = _both(lambda t: lines.grid_ransac_lines(
        t, pair_idx=pairs.to(t.device)), cuda, img)
    assert torch.equal(cpu.valid, card.valid.cpu())
    assert torch.equal(cpu.inliers, card.inliers.cpu())
    noisy, tmpl, where = cs.template_scene()
    for fn in (template.match_ssd, template.match_sad, template.match_ncc):
        cpu, card = _both(fn, cuda, noisy, tmpl)
        det = template.find_matches(card, max_matches=1)
        assert (int(det.ys[0]), int(det.xs[0])) == where
        span = float(cpu.max() - cpu.min())
        assert float((card.cpu() - cpu).abs().max()) <= 1e-5 * span
    cpu, card = _both(dense.hog, cuda, noisy[:240, :320])
    assert float((card.cpu() - cpu).abs().max()) <= 1e-5


def test_trackers_on_card_match_cpu(cuda):
    """Ten frames of ``chip_smoke.tracker_scene`` through each tracker on
    both devices; SFOT launches ``klt_track`` once a frame."""
    import chip_smoke as cs
    from boofcv_tpu_torch.feature import trackers as tr
    frames, centres = cs.tracker_scene(n=11)
    half = (cs.TRACK_SIDE - 1) / 2.0
    runs = {}
    for dev in ("cpu", cuda):
        imgs = [torch.from_numpy(f).to(dev) for f in frames]
        kt.reset_launch_count()
        states = [tr.circulant_init(imgs[0], *centres[0], size=96),
                  tr.meanshift_init(imgs[0], *centres[0], radius=24),
                  tr.sfot_init(*centres[0], cs.TRACK_SIDE, cs.TRACK_SIDE,
                               device=dev),
                  tr.comaniciu_init(imgs[0], *centres[0], half, half)]
        for i in range(10):
            states = [tr.circulant_track(states[0], imgs[i + 1]),
                      tr.meanshift_track(states[1], imgs[i + 1]),
                      tr.sfot_track(imgs[i], imgs[i + 1], states[2])[0],
                      tr.comaniciu_track(states[3], imgs[i + 1])]
        runs[str(dev)] = [(float(s.cy), float(s.cx)) for s in states]
        if dev != "cpu":
            assert kt.launch_count() == 10
    for (a, b), tol in zip(zip(runs["cpu"], runs[str(cuda)]),
                           (1e-3, 1e-3, 0.05, 2.0)):
        assert np.hypot(a[0] - b[0], a[1] - b[1]) <= tol


def test_tld_on_card_matches_cpu(cuda):
    """The reference TLD test's reacquisition scene at 120x160 on both
    devices: found flags equal on every frame, boxes within
    ``chip_smoke.TLD_BOX_TOL``, two ``klt_track`` launches a frame."""
    import chip_smoke as cs
    from boofcv_tpu_torch.recognition import tld
    rng = np.random.default_rng(5)
    obj = lambda cy, cx, s: cs._tld_object(rng, cy, cx, s, 120, 160)
    f0 = obj(40, 50, 1.0)
    frames = [obj(43, 55, 1.0), obj(46, 60, 1.0)]
    frames += [rng.normal(100, 3, (120, 160)).astype(np.float32)
               for _ in range(2)]
    frames += [obj(78, 112, 1.7) for _ in range(3)]
    runs = {}
    for dev in ("cpu", cuda):
        t = tld.make_tracker(device=dev)
        t.initialize(torch.from_numpy(f0).to(dev), 40, 50, 24, 24)
        kt.reset_launch_count()
        runs[str(dev)] = [t.process(torch.from_numpy(f).to(dev))
                          for f in frames]
        if dev != "cpu":
            assert kt.launch_count() == 2 * len(frames)
    for (a_ok, a), (b_ok, b) in zip(runs["cpu"], runs[str(cuda)]):
        assert a_ok == b_ok
        assert np.abs(np.subtract(a, b)).max() <= cs.TLD_BOX_TOL
    ok, box = runs[str(cuda)][4]
    assert ok and abs(box[0] - 78) < 8 and abs(box[1] - 112) < 8


def test_scene_and_deepboof_on_card_match_cpu(cuda):
    """Bag of words (same ``init_idx``) and both networks' logits on both
    devices."""
    import chip_smoke as cs
    from boofcv_tpu_torch.examples.classify_scene_knn import texture
    from boofcv_tpu_torch.feature import dense
    from boofcv_tpu_torch.recognition import deepboof, scene
    rng = np.random.default_rng(19)
    train = [(texture(rng, k), k) for k in range(3) for _ in range(4)]
    test = [(texture(rng, k), k) for k in range(3) for _ in range(3)]
    labels, preds = [k for _, k in train], {}
    for dev in ("cpu", cuda):
        f = [dense.dense_sift(img, device=dev)[2] for img, _ in train]
        idx = np.arange(0, sum(len(x) for x in f), 7)[:24]
        clf = scene.train_bow(None, f, labels, vocab_size=24, init_idx=idx,
                              device=dev)
        preds[str(dev)] = [scene.classify_bow(
            clf, dense.dense_sift(img, device=dev)[2]) for img, _ in test]
    assert preds["cpu"] == preds[str(cuda)]
    assert np.mean(np.equal(preds["cpu"], [k for _, k in test])) >= 0.8
    params = cs._numpy_params("vgg", np.random.default_rng(3))
    x = np.random.default_rng(4).uniform(0, 1, (16, 32, 32, 3)).astype(
        np.float32)
    cpu, card = _both(lambda t: deepboof.vgg_cifar10_forward(
        deepboof.params_from_numpy(params, device=t.device), t), cuda, x)
    assert float((card.cpu() - cpu).abs().max()) <= \
        1e-3 * float(cpu.abs().max())
    ch = (16, 24, 32)
    nin = deepboof.init_nin(torch.Generator().manual_seed(5), num_classes=7,
                            channels=ch, device="cpu")
    x = np.random.default_rng(6).uniform(0, 1, (2, 67, 67, 3)).astype(
        np.float32)
    cpu, card = _both(lambda t: deepboof.nin_forward(
        {k: v.to(t.device) for k, v in nin.items()}, t, channels=ch),
        cuda, x)
    assert float((card.cpu() - cpu).abs().max()) <= \
        1e-3 * float(cpu.abs().max())


def test_ip_more_on_card_matches_cpu(cuda):
    """The functions the port's modules lacked, at 240x320 on an
    integer-valued image, and the PnP solvers, on both devices."""
    import chip_smoke as cs
    from boofcv_tpu_torch.core.pyramid import PyramidConfig
    from boofcv_tpu_torch.feature import intensity
    from boofcv_tpu_torch.geo import pnp
    from boofcv_tpu_torch.ip import convolve, derivative, interpolate
    from boofcv_tpu_torch.ip import pyramid_ops
    img = np.round(simulate.checker_texture(np.random.default_rng(1),
                                            size=320, square=20))[:240]
    img = np.clip(img, 0, 255).astype(np.float32)
    exact = {
        "prewitt": derivative.prewitt, "laplacian": derivative.laplacian,
        "hessian_three": derivative.hessian_three,
        "convolve_down": lambda t: convolve.convolve_down(
            t, torch.tensor([0.25, 0.5, 0.25]), 2, 0),
        "fast": intensity.fast, "hessian_det": intensity.hessian_det,
        "median_intensity": intensity.median_intensity}
    for name, fn in exact.items():
        cpu, card = _both(fn, cuda, img)
        for a, b in zip(cpu if isinstance(cpu, tuple) else (cpu,),
                        card if isinstance(card, tuple) else (card,)):
            assert torch.equal(b.cpu(), a), name
    close = {
        "pyramid_discrete": lambda t: pyramid_ops.pyramid_discrete(
            t, PyramidConfig((1, 2, 4), sigma=1.0)),
        "harris_weighted": lambda t: (intensity.harris(t, weighted=True),),
        "kitros": lambda t: (intensity.kitros(t),),
        "bicubic": lambda t: (interpolate.bicubic(
            t, torch.linspace(-2, 241, 999, dtype=torch.float64,
                              device=t.device),
            torch.linspace(-2, 321, 999, dtype=torch.float64,
                           device=t.device)),)}
    for name, fn in close.items():
        cpu, card = _both(fn, cuda, img)
        for a, b in zip(cpu, card):
            assert float((b.cpu() - a).abs().max()) <= \
                1e-4 * float(a.abs().max()), name
    world, obs, (R, t) = cs._pnp_scenes(n=64)["general"]
    for fn in (pnp.epnp, pnp.pnp_dlt):
        cpu, card = _both(fn, cuda, world, obs)
        assert max(float((x.cpu() - y).abs().max())
                   for x, y in zip(card, cpu)) <= 1e-6
        assert np.abs(cpu[0].numpy() - R).max() < 1e-2


# --- the commands and the kernel-path examples -----------------------------

EXAMPLE_PROBES = {
    # example -> (port class to watch, method, what to keep after a call,
    #             tolerance)
    "visual_odometry_stereo": ("sfm.stereo_vo.StereoVisualOdometry",
                               "camera_to_world", "result", 1e-5),
    "visual_odometry_depth": ("sfm.depth_vo.DepthVisualOdometry",
                              "camera_to_world", "result", 1e-5),
    "visual_odometry_mono_plane": (
        "sfm.mono_plane_vo.MonoPlaneVisualOdometry", "camera_to_world",
        "result", 1e-5),
    "point_feature_tracker": ("feature.point_tracker.PointTrackerKlt",
                              "active_tracks", "tracks", 1e-3),
    "video_stabilization": ("sfm.stitch2d.Stitcher", "process", "H", 1e-5),
    "video_mosaic": ("sfm.stitch2d.Stitcher", "process", "H", 1e-5),
    "image_stitching": ("sfm.stitch2d.Stitcher", "process", "H", 1e-5),
}
# and relative to each entry: the mosaic's homography accumulates
# translations of up to 150 px over 14 frames, where float32 rounding of
# the tracks moves an entry by 1e-5 (the family tests' 1e-5 is absolute
# on 3 frames and translations under 40 px)
EXAMPLE_RTOL = 1e-6


def _probe_example(name, monkeypatch, argv):
    """Run the port's example ``name`` with ``argv`` and keep, after each
    call of its probe (``EXAMPLE_PROBES``), the pose, the homography or the
    tracks (uid, x, y); returns (stdout, kept arrays)."""
    import contextlib
    import importlib
    import io
    path, method, what, _ = EXAMPLE_PROBES[name]
    mod, cls = path.rsplit(".", 1)
    owner = getattr(importlib.import_module(f"boofcv_tpu_torch.{mod}"), cls)
    real = getattr(owner, method)
    kept = []

    def probe(self, *args):
        out = real(self, *args)
        if what == "result":
            kept.append(np.concatenate([np.ravel(a) for a in out]))
        elif what == "H":
            kept.append(np.array(self.H_mosaic_from_frame).ravel())
        else:
            kept.append(np.array([(t.uid, t.x, t.y) for t in out]))
        return out
    monkeypatch.setattr(owner, method, probe)
    ex = importlib.import_module(f"boofcv_tpu_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ex.main(argv) == 0, buf.getvalue()
    monkeypatch.setattr(owner, method, real)
    return buf.getvalue(), kept


@pytest.mark.parametrize("name", sorted(EXAMPLE_PROBES))
def test_kernel_path_example_on_card_matches_cpu(cuda, name, monkeypatch):
    """Each example that reaches a hand kernel, with the same RANSAC index
    sets on both devices: run with no ``--device`` it goes to the card and
    launches ``klt_track`` (and ``window_gather`` where its path spawns
    stereo tracks), and every pose / homography it reads matches the CPU
    run's within 1e-5 and 1e-6 of itself (the tracks within 1e-3 px), as
    the family tests hold the front ends."""
    start = _same_draws(monkeypatch)
    start()
    cpu_out, cpu = _probe_example(name, monkeypatch, ["--device", "cpu"])
    start()
    kt.reset_launch_count()
    wg.reset_launch_count()
    card_out, card = _probe_example(name, monkeypatch, [])
    torch.cuda.synchronize()
    assert "device: cuda" in card_out and "device: cpu" in cpu_out
    assert kt.launch_count() > 0
    if name == "visual_odometry_stereo":
        assert wg.launch_count() > 0
    tol = EXAMPLE_PROBES[name][3]
    assert len(card) == len(cpu) > 0
    for a, b in zip(card, cpu):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=tol, rtol=EXAMPLE_RTOL)


def test_stereo_vo_demo_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """``cli.stereo_vo_demo`` on five 240x320 frames of the reference
    scene, with and without ``--calib``: the card's trajectory (the
    default device) within 1e-5 of the CPU's with the same index sets, and
    both kernels launched."""
    import chip_smoke as cs
    from boofcv_tpu_torch.cli import stereo_vo_demo
    from boofcv_tpu_torch.io import calibration_io as cio
    h, w = 240, 320
    k = np.array([[240.0, 0.0, 160.0], [0.0, 240.0, 120.0], [0.0, 0.0, 1.0]])
    _, frames = cs._scene(5, k, h, w, seed=0)
    ld, rd = cs.write_stereo_dirs(str(tmp_path), frames)
    cam = cio.CameraPinholeBrown(w, h, 240.0, 240.0, 0.0, 160.0, 120.0)
    calib = str(tmp_path / "stereo.yaml")
    cio.save_stereo(cio.StereoParameters(cam, cam, np.eye(3),
                                         np.array([cs.BASELINE, 0, 0])),
                    calib)
    start = _same_draws(monkeypatch)
    for extra in (["--fx", "240", "--baseline", str(cs.BASELINE)],
                  ["--calib", calib]):
        trajs = []
        for device in (["--device", "cpu"], []):
            start()
            kt.reset_launch_count()
            wg.reset_launch_count()
            out = str(tmp_path / f"traj{len(trajs)}.txt")
            assert stereo_vo_demo.main(["--left", ld, "--right", rd,
                                        "--output", out] + extra
                                       + device) == 0
            trajs.append(np.loadtxt(out))
        torch.cuda.synchronize()
        assert kt.launch_count() == 4 and wg.launch_count() >= 2
        assert trajs[0].shape == (5, 12)
        np.testing.assert_allclose(trajs[1], trajs[0], atol=1e-5, rtol=0)


def test_comaniciu_lattice_on_card_equals_cpu(cuda):
    """Comaniciu's sample lattice is the same IEEE formula on the card as
    on the CPU, bit for bit (a quotient by a Python scalar would be a
    multiply by its reciprocal on the card)."""
    from boofcv_tpu_torch.feature import trackers
    for n in (7, 24, 100):
        for got, want in zip(trackers._unit_lattice(n, "cuda"),
                             trackers._unit_lattice(n, "cpu")):
            assert torch.equal(got.cpu(), want)


@pytest.fixture
def nccl_group(cuda):
    """No process group before the test; whatever it starts is torn down
    after it."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("solver", ("cholesky", "pcg"))
def test_sharded_ba_on_one_nccl_rank_matches_optimize(cuda, nccl_group,
                                                       solver):
    """``optimize_sharded`` on the one-rank NCCL group ``make_mesh`` starts
    on the card, against ``ba.optimize`` on the card: costs within 1e-6
    relative ("cholesky"; the same arithmetic) or 1e-4 ("pcg", 120
    iterations on 30 views); no host sync inside the solve."""
    import warnings
    import torch.distributed as dist
    from boofcv_tpu_torch.dist import ba_sharded, make_mesh
    from boofcv_tpu_torch.geo import ba
    mesh = make_mesh()
    assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
    prob = _ba_scene(torch.float32, cuda, V=30, P=1500, L=8, seed=1)
    ref, info_ref = ba.optimize(prob, iterations=8)
    solve = lambda: ba_sharded.optimize_sharded(
        prob, mesh, iterations=8, reduced_solver=solver, pcg_iterations=120)
    solve()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out, info = solve()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs, syncs
    rtol = 1e-6 if solver == "cholesky" else 1e-4
    np.testing.assert_allclose(info["costs"].cpu().numpy(),
                               info_ref["costs"].cpu().numpy(), rtol=rtol)
    assert float(info["final_cost"]) < 1e-2 * float(info["initial_cost"])
    assert out.R.shape == ref.R.shape and out.points.shape == ref.points.shape


def test_cuda_mesh_with_a_failed_nccl_start_raises(cuda, nccl_group,
                                                   monkeypatch):
    """A failed NCCL start reaches the caller: no gloo group, no CPU run."""
    import torch.distributed as dist
    from boofcv_tpu_torch.dist import make_mesh

    def refuse(*args, **kwargs):
        raise dist.DistBackendError("NCCL communicator failed to start")
    monkeypatch.setattr(dist, "init_process_group", refuse)
    with pytest.raises(dist.DistBackendError):
        make_mesh()
    assert not dist.is_initialized()


# ---- the pose refine's kernel (kernels/gn_pose.py) ------------------------
# The kernel's float32 sums run in another order than the plain version's
# GEMMs, so the two agree to float32 resolution: 1e-5 on R and t, the
# tolerance test_torch_geo.py::test_gauss_newton_pose[0-1e-05] holds the
# port's float32 loop to against the reference.
GN_TOL = 1e-5
GN_DAMPING = 1e-9    # robust.ransac_pnp's
GN_STEP_TOL = 1e-6   # the float32 stage's, geo/pnp.gauss_newton_pose


def _rotation(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th ** 2 * K @ K)


def _gn_scene(lead=(), n=600, seed=0):
    """Problems as ``robust.ransac_pnp`` hands them to the refine: R, t
    float32 (a P3P hypothesis about 0.03 rad and 5 cm off the truth), and
    float64 world points 3-12 m ahead, their normalized projections with
    1e-3 noise and weights, a fifth of the rows masked (weight 0, world
    1.0, obs 0).  Each problem its own truth, points and start."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(np.prod(lead))):
        R = _rotation(rng.normal(0, 0.1, 3))
        t = rng.normal(0, 0.5, 3)
        world = np.concatenate([rng.uniform(-4, 4, (n, 2)),
                                rng.uniform(3, 12, (n, 1))], -1)
        cam = world @ R.T + t
        obs = cam[:, :2] / cam[:, 2:] + rng.normal(0, 1e-3, (n, 2))
        keep = rng.uniform(size=n) > 0.2
        R0 = _rotation(rng.normal(0, 0.03 / 3 ** 0.5, 3)) @ R
        t0 = t + rng.normal(0, 0.05 / 3 ** 0.5, 3)
        out.append((R0, t0, np.where(keep[:, None], world, 1.0),
                    np.where(keep[:, None], obs, 0.0), keep.astype(float)))
    dtypes = (torch.float32, torch.float32) + (torch.float64,) * 3
    return [torch.from_numpy(np.stack([o[i] for o in out]).reshape(
        lead + out[0][i].shape)).to(d) for i, d in enumerate(dtypes)]


def _gn_both(args, iterations, damping=GN_DAMPING):
    """(the kernel's R, t; the plain version's) on the same tensors, and
    the kernel's launches in between (1)."""
    before = gp.launch_count()
    kernel = gp.gn_pose_cuda(*args, iterations, damping, GN_STEP_TOL)
    launches = gp.launch_count() - before
    plain = pnp._gn_pose_f32(*args, iterations, damping, GN_STEP_TOL)
    torch.cuda.synchronize()
    return kernel, plain, launches


@pytest.mark.parametrize("lead", [(), (16,)])
@pytest.mark.parametrize("iterations", [10, 50])
def test_gn_pose_kernel_matches_plain_version(cuda, lead, iterations):
    """The kernel against the plain route (the float32 loop and the float64
    Newton-polar steps) on the same CUDA tensors, with masked rows: R and t
    within GN_TOL, float64, R a rotation; ``gauss_newton_pose`` on the card
    is one launch of the kernel, bit for bit."""
    args = [x.to(cuda) for x in _gn_scene(lead)]
    (R, t), (Rp, tp), launches = _gn_both(args, iterations)
    assert launches == 1
    assert R.dtype == t.dtype == torch.float64
    assert R.shape == lead + (3, 3) and t.shape == lead + (3,)
    np.testing.assert_allclose(R.cpu(), Rp.cpu(), atol=GN_TOL, rtol=0)
    np.testing.assert_allclose(t.cpu(), tp.cpu(), atol=GN_TOL, rtol=0)
    eye = torch.eye(3, dtype=torch.float64, device=cuda)
    assert float((R @ R.transpose(-1, -2) - eye).abs().max()) < 1e-12
    before = gp.launch_count()
    Rr, tr = pnp.gauss_newton_pose(*args, iterations=iterations,
                                   damping=GN_DAMPING, polish_iterations=0)
    assert gp.launch_count() == before + 1
    assert torch.equal(Rr, R) and torch.equal(tr, t)


def test_gn_pose_stream_equals_its_single_stream_bit_for_bit(cuda):
    """One block a problem: a stream's result does not depend on its
    batch-mates, so each of 16 equals its own single-stream launch bit for
    bit."""
    args = [x.to(cuda) for x in _gn_scene((16,), seed=1)]
    R, t = gp.gn_pose_cuda(*args, 50, GN_DAMPING, GN_STEP_TOL)
    for b in range(16):
        R1, t1 = gp.gn_pose_cuda(*(x[b] for x in args), 50, GN_DAMPING,
                                 GN_STEP_TOL)
        assert torch.equal(R1, R[b]) and torch.equal(t1, t[b])


def test_gn_pose_freezes_each_stream_on_its_own_step(cuda):
    """test_gn_refine_freezes_each_stream_on_its_own_step on the card:
    stream 0 starts at its optimum and stops after one step, stream 1 far
    off keeps stepping; each agrees with the plain route and with its
    single-stream launch, stream 0 beside a copy of itself is the same
    bits, and stream 1 reaches the optimum."""
    R0, t0, world, obs, wgt = _gn_scene(seed=2)
    Ro, to = pnp.gauss_newton_pose(R0.double(), t0.double(), world, obs,
                                   wgt, iterations=12)     # on the CPU
    far = torch.from_numpy(_rotation(np.array([0.05, -0.04, 0.03])))
    Rb = torch.stack([Ro, Ro @ far]).float().to(cuda)
    tb = torch.stack([to, to + 0.1]).float().to(cuda)
    wb, ob, gb = (torch.stack([x] * 2).to(cuda) for x in (world, obs, wgt))
    (R, t), (Rp, tp), _ = _gn_both([Rb, tb, wb, ob, gb], 10)
    np.testing.assert_allclose(R.cpu(), Rp.cpu(), atol=GN_TOL, rtol=0)
    np.testing.assert_allclose(t.cpu(), tp.cpu(), atol=GN_TOL, rtol=0)
    for b in range(2):
        R1, t1 = gp.gn_pose_cuda(Rb[b], tb[b], wb[b], ob[b], gb[b], 10,
                                 GN_DAMPING, GN_STEP_TOL)
        assert torch.equal(R1, R[b]) and torch.equal(t1, t[b])
    np.testing.assert_allclose(R[1].cpu(), Ro, atol=GN_TOL)
    np.testing.assert_allclose(t[1].cpu(), to, atol=GN_TOL)
    twin = lambda a: torch.stack([a[0], a[0]])
    Rs, ts = gp.gn_pose_cuda(twin(Rb), twin(tb), wb, ob, gb, 10, GN_DAMPING,
                             GN_STEP_TOL)
    assert torch.equal(Rs[0], R[0]) and torch.equal(ts[0], t[0])
    assert torch.equal(Rs[1], R[0]) and torch.equal(ts[1], t[0])


def test_gn_pose_edge_cases_match_plain_version(cuda):
    """No iterations (the Newton-polar steps alone; ``gauss_newton_pose``
    then launches nothing and returns the start), a point behind the
    camera, NaN in R or in one point (NaN in the same places: the whole
    problem), and a singular H (no damping, every weight 0: NaN, as
    ``cholesky_ex``'s failure gives)."""
    args = [x.to(cuda) for x in _gn_scene((5,), n=200, seed=3)]
    (R, t), (Rp, tp), launches = _gn_both(args, 0)
    assert launches == 1
    np.testing.assert_allclose(R.cpu(), Rp.cpu(), atol=1e-12, rtol=0)
    assert torch.equal(t, tp)
    before = gp.launch_count()
    Rz, tz = pnp.gauss_newton_pose(*args, iterations=0, polish_iterations=0)
    assert gp.launch_count() == before
    assert torch.equal(Rz, args[0].double()) and torch.equal(tz,
                                                             args[1].double())
    R0, t0, world, obs, wgt = (x.clone() for x in args)
    world[0, 3] = world[0, 3] * torch.tensor([1.0, 1.0, -1.0], device=cuda)
    wgt[0, 3] = 1.0                                # behind the camera
    R0[1, 0, 0] = float("nan")
    world[2, 7, 1] = float("nan")
    wgt[3] = 0.0
    (R, t), (Rp, tp), _ = _gn_both([R0, t0, world, obs, wgt], 10,
                                   damping=0.0)
    for a, b in ((R, Rp), (t, tp)):
        nan = torch.isnan(a)
        assert torch.equal(nan, torch.isnan(b))
        assert bool(nan[1:4].all()) and not bool(nan[0].any() | nan[4].any())
        np.testing.assert_allclose(a[~nan].cpu(), b[~nan].cpu(), atol=GN_TOL,
                                   rtol=0)


def test_gn_pose_makes_no_host_sync(cuda):
    """``gauss_newton_pose`` on the card reads nothing on the host (an
    error under the debug mode), with weights given and without."""
    args = [x.to(cuda) for x in _gn_scene((16,), seed=4)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pnp.gauss_newton_pose(*args, iterations=50, damping=GN_DAMPING,
                              polish_iterations=0)
        pnp.gauss_newton_pose(*args[:4], iterations=10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_gn_pose_route_takes_what_the_cpu_route_takes(cuda):
    """``gauss_newton_pose`` on the card accepts what the plain loop
    accepts: R and t of one problem beside world [B, N, 3], obs and
    weights of one problem, t in float16 and weights as integers.  One
    launch, within GN_TOL of the same call on the CPU."""
    R0, t0, world, obs, wgt = _gn_scene(n=200, seed=5)
    world = world + 1e-3 * torch.arange(3.0, dtype=world.dtype)[:, None,
                                                                 None]
    args = (R0, t0.half(), world, obs, (wgt > 0).long())
    before = gp.launch_count()
    R, t = pnp.gauss_newton_pose(*(x.to(cuda) for x in args),
                                 iterations=10, damping=GN_DAMPING,
                                 polish_iterations=0)
    assert gp.launch_count() == before + 1
    Rc, tc = pnp.gauss_newton_pose(*args, iterations=10, damping=GN_DAMPING,
                                   polish_iterations=0)
    assert R.shape == (3, 3, 3) and t.shape == (3, 3)
    np.testing.assert_allclose(R.cpu(), Rc, atol=GN_TOL, rtol=0)
    np.testing.assert_allclose(t.cpu(), tc, atol=GN_TOL, rtol=0)


# ---- the RANSAC bank's kernel (kernels/pnp_bank.py) -----------------------
# The kernel solves and scores in the plain route's precision, but sums its
# rows and the MSAC in another order, so the two agree to rounding:
# ``chip_smoke.bank_verdict`` holds the criteria, which ``chip_smoke.py``'s
# own check of the kernel applies too (counts equal; the plain route's
# winner within float32 resolution, or a near-tie).
BANK_THR = (1.5 / 480.0) ** 2      # 1.5 px at fx 480, as the VO cells


def _bank_scene(lead=(), n=600, seed=0, holes=0.2, outliers=0.2):
    """B streams of a PnP problem as the VO hands RANSAC them: float64
    world points 3-12 m ahead, their normalized projections through each
    stream's pose with 1e-3 noise, ``outliers`` of them replaced by random
    observations, and a mask with ``holes`` of the points off."""
    rng = np.random.default_rng(seed)
    worlds, obss, masks = [], [], []
    for _ in range(int(np.prod(lead))):
        R = _rotation(rng.normal(0, 0.1, 3))
        t = rng.normal(0, 0.5, 3)
        world = np.concatenate([rng.uniform(-4, 4, (n, 2)),
                                rng.uniform(3, 12, (n, 1))], -1)
        cam = world @ R.T + t
        obs = cam[:, :2] / cam[:, 2:] + rng.normal(0, 1e-3, (n, 2))
        bad = rng.uniform(size=n) < outliers
        obs[bad] = rng.uniform(-0.6, 0.6, (int(bad.sum()), 2))
        worlds.append(world)
        obss.append(obs)
        masks.append(rng.uniform(size=n) >= holes)
    as_t = lambda xs: torch.from_numpy(np.stack(xs).reshape(
        lead + xs[0].shape))
    return as_t(worlds), as_t(obss), as_t(masks)


def _check_bank(kernel, world, obs, idx, valid):
    """The kernel's result against the plain route's bank on the same
    tensors (``chip_smoke.bank_verdict``), stream by stream."""
    import chip_smoke as cs
    cs.bank_verdict(kernel, world, obs, idx, valid, BANK_THR)


def _bank_launch(world, obs, idx, valid):
    """pnp_bank_cuda once, and its launches (1)."""
    from boofcv_tpu_torch.kernels import pnp_bank
    before = pnp_bank.launch_count()
    out = pnp_bank.pnp_bank_cuda(world, obs, idx, valid, BANK_THR)
    torch.cuda.synchronize()
    return out, pnp_bank.launch_count() - before


@pytest.mark.parametrize("lead,n,k", [((), 600, 200), ((16,), 600, 200),
                                      ((), 8, 16), ((3,), 2000, 64),
                                      ((), 97, 50)])
def test_pnp_bank_matches_the_plain_route(cuda, lead, n, k):
    """One stream and sixteen, 8 to 2,000 points with holes in the mask and
    a fifth of outliers, index sets drawn on the card: the kernel against
    the plain route's bank on the same tensors and index sets (counts
    equal; the same winner within float32 rounding, or a near-tie); one
    launch; two launches bit-equal."""
    from boofcv_tpu_torch.geo import robust
    world, obs, valid = (x.to(cuda) for x in _bank_scene(lead, n, seed=n))
    gens = [torch.Generator(device=cuda).manual_seed(b)
            for b in range(int(np.prod(lead)))]
    idx = robust.sample_indices(gens if lead else gens[0], k, 3, n, valid)
    out, launches = _bank_launch(world, obs, idx, valid)
    assert launches == 1
    (R, t, ok), inl, count, err = out
    assert (R.shape, t.shape, ok.shape, inl.shape, count.shape,
            err.shape) == (lead + (3, 3), lead + (3,), lead, lead + (n,),
                           lead, lead)
    assert (R.dtype, t.dtype, ok.dtype, inl.dtype, count.dtype,
            err.dtype) == (torch.float32, torch.float32, torch.bool,
                           torch.bool, torch.int64, torch.float32)
    _check_bank(out, world, obs, idx, valid)
    again, _ = _bank_launch(world, obs, idx, valid)
    for a, b in zip(torch.utils._pytree.tree_leaves(out),
                    torch.utils._pytree.tree_leaves(again)):
        assert torch.equal(a, b)
    if n >= 600:
        # a well-posed bank finds the pose: most of the good points agree
        assert bool(ok.all()) and int(count.min()) > 0.5 * n * 0.8 * 0.8


def _no_real_root_sample(world, obs, first):
    """Indices, from ``first`` on, of a triple of ``world``/``obs`` whose
    P3P quartic has no real root (found on the CPU by watching
    ``pnp.quartic_roots``)."""
    seen = []
    real_roots = pnp.quartic_roots

    def watch(*a):
        roots, real = real_roots(*a)
        seen.append(real)
        return roots, real
    rng = np.random.default_rng(7)
    n = world.shape[0]
    for _ in range(200):
        cand = torch.from_numpy(np.stack([
            rng.choice(np.arange(first, n), 3, replace=False)
            for _ in range(64)]))
        pnp.quartic_roots = watch
        try:
            pnp.p3p_grunert(world[cand], obs[cand], dtype=torch.float32)
        finally:
            pnp.quartic_roots = real_roots
        none = ~seen.pop().any(-1)
        if bool(none.any()):
            return cand[int(torch.nonzero(none)[0, 0])]
    raise AssertionError("no triple without a real root")


def test_pnp_bank_degenerate_samples(cuda):
    """Samples that give no usable pose mixed into a bank, and as a bank of
    their own: three collinear points, points behind the camera, a NaN
    observation, a triple whose quartic has no real root.  The mixed bank
    meets the plain route's criteria; the NaN sample, and the rootless one,
    alone as a bank give the plain route's count (0), mask (empty) and
    MSAC (no pose is usable, so the pose is not compared)."""
    import chip_smoke as cs
    world, obs, valid = _bank_scene(n=300, seed=3, outliers=0.3)
    world, obs = world.clone(), obs.clone()
    # 0-2 collinear, with their true projections kept consistent
    world[1] = world[0] + 0.5 * (world[2] - world[0])
    obs[1] = world[1, :2] / world[1, 2]
    # 3-5 behind the camera
    world[3:6, 2] *= -1.0
    # 6: a NaN observation
    obs[6] = float("nan")
    valid[:7] = True
    none = _no_real_root_sample(world, obs, 11)
    special = torch.stack([torch.tensor([0, 1, 2]), torch.tensor([3, 4, 5]),
                           torch.tensor([3, 9, 10]), torch.tensor([6, 7, 8]),
                           none])
    from boofcv_tpu_torch.geo import robust
    drawn = robust.sample_indices(torch.Generator().manual_seed(0), 40, 3,
                                  300, valid)
    idx = torch.cat([special, drawn]).to(cuda)
    world, obs, valid = world.to(cuda), obs.to(cuda), valid.to(cuda)
    out, launches = _bank_launch(world, obs, idx, valid)
    assert launches == 1
    _check_bank(out, world, obs, idx, valid)
    # the NaN observation's sample and the one with no real root alone
    for row in special[3:]:
        one = row[None].to(cuda)
        (R, t, ok), inl, count, err = _bank_launch(world, obs, one, valid)[0]
        _, _, is_in, counts, msac, order = cs.bank_table(world, obs, one,
                                                         valid, BANK_THR)
        jp = int(order.argmax())
        assert int(count) == int(counts[jp]) == 0 and not bool(ok)
        assert torch.equal(inl, is_in[jp]) and not bool(inl.any())
        np.testing.assert_allclose(float(err), float(msac[jp]), rtol=1e-5)


def test_ransac_pnp_on_the_card_is_one_bank_launch(cuda):
    """``ransac_pnp(p3p="grunert")`` on the card: the generators draw as on
    the plain route, one ``pnp_bank`` launch a call (one stream or B), the
    route counted; Finsterwalder keeps the plain route.  The bank's result
    meets the plain route's criteria, and the refine runs on its inliers."""
    from boofcv_tpu_torch.geo import robust
    from boofcv_tpu_torch.kernels import pnp_bank
    for lead in ((), (16,)):
        world, obs, valid = (x.to(cuda) for x in _bank_scene(lead, 600,
                                                             seed=11))
        seeds = range(int(np.prod(lead)))
        gen = lambda: ([torch.Generator(device=cuda).manual_seed(s)
                        for s in seeds] if lead else
                       torch.Generator(device=cuda).manual_seed(0))
        robust.reset_bank_routes()
        before = pnp_bank.launch_count()
        res, (Rr, tr) = robust.ransac_pnp(gen(), world, obs,
                                          num_hypotheses=200,
                                          inlier_threshold=BANK_THR,
                                          valid_mask=valid,
                                          refine_iterations=50)
        torch.cuda.synchronize()
        assert pnp_bank.launch_count() == before + 1
        assert robust.bank_routes() == {"kernel": 1, "plain": 0}
        g = gen()
        idx = robust.sample_indices(g, 200, 3, 600, valid)
        _check_bank((res.model, res.inliers, res.num_inliers,
                     res.best_error), world, obs, idx, valid)
        assert Rr.shape == lead + (3, 3) and tr.dtype == torch.float64
        robust.ransac_pnp(gen(), world, obs, num_hypotheses=200,
                          inlier_threshold=BANK_THR, valid_mask=valid,
                          p3p="finsterwalder")
        assert pnp_bank.launch_count() == before + 1
        assert robust.bank_routes() == {"kernel": 1, "plain": 1}


def test_ransac_pnp_on_the_card_checks_a_callers_index_sets(cuda):
    """Index sets a caller hands in are read as the plain route reads them
    (any integer dtype, from the CPU) and refused, with no launch, when an
    index lies outside the points or the bank's size is not
    ``num_hypotheses``."""
    from boofcv_tpu_torch.geo import robust
    from boofcv_tpu_torch.kernels import pnp_bank
    world, obs, valid = (x.to(cuda) for x in _bank_scene(n=50, seed=2))
    idx = torch.randint(0, 50, (20, 3), generator=torch.Generator(
        ).manual_seed(1), dtype=torch.int32)
    res, _ = robust.ransac_pnp(None, world, obs, num_hypotheses=20,
                               inlier_threshold=BANK_THR, valid_mask=valid,
                               idx=idx)
    _check_bank((res.model, res.inliers, res.num_inliers, res.best_error),
                world, obs, idx.long().to(cuda), valid)
    before = pnp_bank.launch_count()
    for bad, words in ((idx.clone().fill_(50), r"outside \[0, 50\)"),
                       (-idx - 1, "outside"), (idx[:10], "must be")):
        with pytest.raises(ValueError, match=words):
            robust.ransac_pnp(None, world, obs, num_hypotheses=20,
                              inlier_threshold=BANK_THR, valid_mask=valid,
                              idx=bad)
    assert pnp_bank.launch_count() == before


def test_pnp_bank_makes_no_host_sync(cuda):
    """The bank with index sets drawn by ``ransac_pnp`` itself reads
    nothing back: no host sync under the debug mode's error."""
    from boofcv_tpu_torch.geo import robust
    world, obs, valid = (x.to(cuda) for x in _bank_scene((4,), 600, seed=5))
    gens = [torch.Generator(device=cuda).manual_seed(s) for s in range(4)]
    robust.ransac_pnp(gens, world, obs, num_hypotheses=200,
                      inlier_threshold=BANK_THR, valid_mask=valid,
                      refine_iterations=10)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        robust.ransac_pnp(gens, world, obs, num_hypotheses=200,
                          inlier_threshold=BANK_THR, valid_mask=valid,
                          refine_iterations=10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_ransac_pnp_reads_a_card_index_set_unchecked(cuda):
    """Index sets a caller hands in on the card (int64) are not read back:
    no host sync, one launch, and a sample with an index outside the
    points is unusable, so a bank with it wins as the bank without it
    does, bit for bit, and alone it finds no pose."""
    from boofcv_tpu_torch.geo import robust
    from boofcv_tpu_torch.kernels import pnp_bank
    world, obs, valid = (x.to(cuda) for x in _bank_scene(n=600, seed=9))
    rest = robust.sample_indices(torch.Generator(device=cuda).manual_seed(4),
                                 199, 3, 600, valid)
    bad = torch.tensor([[5, 600, 7]], device=cuda)
    call = lambda idx: robust.ransac_pnp(
        None, world, obs, num_hypotheses=idx.shape[0],
        inlier_threshold=BANK_THR, valid_mask=valid, refine_iterations=10,
        idx=idx)
    want, _ = call(rest)
    torch.cuda.synchronize()
    before = pnp_bank.launch_count()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _ = call(torch.cat([bad, rest]))
        alone, _ = call(bad)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert pnp_bank.launch_count() == before + 2
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)
    assert int(alone.num_inliers) == 0 and not bool(alone.model[2])
    assert not bool(alone.inliers.any())


def test_ransac_pnp_sharded_bank_makes_no_host_sync(cuda, nccl_group):
    """``ransac_pnp_sharded`` on the one-rank NCCL group ``make_mesh``
    starts on the card: its bank, drawn on the card and handed to
    ``ransac_pnp`` as index sets, is one ``pnp_bank`` launch a call, and
    the call reads nothing back; the pose is found."""
    import warnings
    from boofcv_tpu_torch.dist import make_mesh
    from boofcv_tpu_torch.dist.ransac_sharded import ransac_pnp_sharded
    from boofcv_tpu_torch.kernels import pnp_bank
    mesh = make_mesh()
    world, obs, _ = (x.to(cuda) for x in _bank_scene(n=512, seed=6))
    gen = torch.Generator(device=cuda).manual_seed(1)
    call = lambda: ransac_pnp_sharded(mesh, gen, world, obs,
                                      num_hypotheses_per_device=256,
                                      inlier_threshold=BANK_THR)
    call()
    torch.cuda.synchronize()
    before = pnp_bank.launch_count()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res, (R, t) = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs, syncs
    assert pnp_bank.launch_count() == before + 1
    assert int(res.num_inliers) > 0.5 * 512 * 0.8
