"""Pyramidal KLT, windowed method: the port against the JAX package on a
noise texture shifted by an integer offset (features move by -shift)."""

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
    f0, _ = _frames((0, 0))
    p = tpyr.pyramid_average(torch.from_numpy(f0), PyramidConfig(SCALES))
    t = tklt.sample_templates(p, tpyr.gradient(p), torch.zeros(2),
                              torch.zeros(2), SCALES, 3)
    with pytest.raises(ValueError, match="ROADMAP"):
        tklt.track_pyramid(p, t, torch.zeros(2), torch.zeros(2), SCALES,
                           tklt.KltConfig(method="gather"))
