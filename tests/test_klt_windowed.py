"""JAX reference: KLT's windowed level method (one window gather per level,
in-window resampling) against the per-iteration flat-gather method, which
the reference keeps as its equivalence oracle.  Covers ``gather_windows``,
``track_pyramid`` and ``KltConfig`` directly."""

import numpy as np
import jax.numpy as jnp
import pytest

from boofcv_tpu.core.pyramid import PyramidConfig
from boofcv_tpu.feature import klt
from boofcv_tpu.io import simulate
from boofcv_tpu.ip import pyramid_ops

SCALES = (1, 2, 4)
H, W = 128, 160


def _track(shift, method, n=160, **cfg_kw):
    tex = simulate.noise_texture(np.random.default_rng(5), size=256)
    sy, sx = shift
    f0 = jnp.asarray(tex[30:30 + H, 40:40 + W])
    f1 = jnp.asarray(tex[30 + sy:30 + sy + H, 40 + sx:40 + sx + W])
    rng = np.random.default_rng(2)
    ys = jnp.asarray(rng.uniform(12, H - 13, n).astype(np.float32))
    xs = jnp.asarray(rng.uniform(12, W - 13, n).astype(np.float32))
    p0 = pyramid_ops.pyramid_average(f0, PyramidConfig(SCALES))
    p1 = pyramid_ops.pyramid_average(f1, PyramidConfig(SCALES))
    tm = klt.sample_templates(p0, pyramid_ops.gradient(p0), ys, xs, SCALES, 3)
    cy, cx, f = klt.track_pyramid(p1, tm, ys, xs, SCALES,
                                  klt.KltConfig(method=method, **cfg_kw))
    return np.asarray(ys), np.asarray(xs), np.asarray(cy), np.asarray(cx), \
        np.asarray(f)


@pytest.mark.parametrize("shift", [(1, -2), (3, 2), (0, 0)])
def test_windowed_matches_gather(shift):
    """Where both methods accept a track, they agree to 1e-3 px on at least
    95% of the tracks and to 0.02 px on all, and both recover the shift.

    The two disagree in a known way (ROADMAP queue 3): near the bottom and
    right borders the windowed method's clamped, 8-row-aligned window
    origin leaves the patch outside the window margin at coarse levels, so
    it faults (out of bounds) tracks the gather method follows."""
    ys, xs, wy, wx, wf = _track(shift, "windowed")
    _, _, gy, gx, gf = _track(shift, "gather")
    both = (wf == klt.TRACK_OK) & (gf == klt.TRACK_OK)
    assert both.mean() > 0.8
    d = np.maximum(np.abs(wy - gy), np.abs(wx - gx))[both]
    assert (d <= 1e-3).mean() >= 0.95
    assert d.max() <= 0.02
    for cy, cx in ((wy, wx), (gy, gx)):
        assert abs(np.median(cy[both] - ys[both]) + shift[0]) < 0.1
        assert abs(np.median(cx[both] - xs[both]) + shift[1]) < 0.1
    only_gather = (gf == klt.TRACK_OK) & (wf != klt.TRACK_OK)
    assert np.all(wf[only_gather] == klt.FAULT_OUT_OF_BOUNDS)
    reach = 6 * SCALES[-1]
    near = (ys >= H - reach) | (xs >= W - reach)
    assert np.all(near[only_gather])
    assert not ((wf == klt.TRACK_OK) & (gf != klt.TRACK_OK)).any()


def test_unknown_method_rejected():
    with pytest.raises(ValueError, match="windowed"):
        _track((0, 0), "pallas", n=4)
