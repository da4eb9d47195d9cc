"""Tests that need the card.  They skip without a CUDA device; on the card,
where JAX is absent, run them without the JAX conftest:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.feature import klt
from boofcv_tpu_torch.io import simulate
from boofcv_tpu_torch.ip import pyramid_ops
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
