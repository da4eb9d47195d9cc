"""Object trackers: circulant, mean-shift likelihood, SFOT and Comaniciu
2003; the port against the JAX package on the same seeded numpy inputs,
on the CPU.

Tolerances: the circulant tracker's integer peak moves and the window
taper is exact, the target response (float32 exp) to 3e-7
relative, its template to 1e-5 and its filter
alphaf (float32 FFTs with other plans, divided by fft(k) + 1e-4) to 2e-3
of its largest entry; the mean-shift histogram is exact and its
float64 centre to 1e-9 px; SFOT (the port's KLT against the reference's,
float32) to 1e-3 px and 1e-4 in scale and yaw; Comaniciu's histogram to
1e-6 and up to three mean-shift iterations to 1e-4 px (float32 sums in
another order), its whole runs against the truth (see the test).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.feature import trackers as jtr
from boofcv_tpu_torch.feature import trackers as ttr

torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _blobs(n_frames=6, start=(30.0, 40.0), vel=(1.5, 2.0), shape=(80, 100)):
    rng = np.random.default_rng(2)
    bgtex = rng.uniform(0, 40, shape).astype(np.float32)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    frames, traj = [], []
    cy, cx = start
    for _ in range(n_frames):
        blob = 200 * np.exp(-0.5 * (((yy - cy) / 6) ** 2
                                    + ((xx - cx) / 6) ** 2))
        frames.append((bgtex + blob).astype(np.float32))
        traj.append((cy, cx))
        cy, cx = cy + vel[0], cx + vel[1]
    return frames, traj


# --------------------------------------------------------------- circulant

@pytest.mark.parametrize("n", [16, 48, 63])
def test_circulant_taper_and_response_equal_jax(n):
    np.testing.assert_array_equal(
        _np(ttr._hann2d(n, "cpu")) * np.ones((n, n), np.float32),
        _np(jtr._hann2d(n).astype(jnp.float32)))
    # float32 exp: XLA's and PyTorch's differ in the last bit
    np.testing.assert_allclose(_np(ttr._gauss_response(n, "cpu")),
                               _np(jtr._gauss_response(n)), rtol=3e-7)


def test_circulant_tracker_matches_jax_and_follows_the_blob():
    frames, traj = _blobs()
    st = ttr.circulant_init(_t(frames[0]), *traj[0], size=48)
    js = jtr.circulant_init(jnp.asarray(frames[0]), *traj[0], size=48)
    for i in range(1, len(frames)):
        st = ttr.circulant_track(st, _t(frames[i]))
        js = jtr.circulant_track(js, jnp.asarray(frames[i]))
        assert float(st.cy) == float(js.cy) and float(st.cx) == float(js.cx)
        assert abs(float(st.cy) - traj[i][0]) < 3.0
        assert abs(float(st.cx) - traj[i][1]) < 3.0
    assert st.alphaf.dtype == torch.complex64
    np.testing.assert_allclose(_np(st.template), _np(js.template),
                               atol=1e-5)
    # alphaf = yf / (fft(k) + lambda) magnifies rounding where fft(k) is
    # small: held relative to its largest entry
    want = _np(js.alphaf)
    np.testing.assert_allclose(_np(st.alphaf), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


# -------------------------------------------------------------- mean shift

def test_meanshift_tracker_matches_jax():
    frames, traj = _blobs(vel=(1.0, 1.5))
    st = ttr.meanshift_init(_t(frames[0]), *traj[0], radius=10)
    js = jtr.meanshift_init(jnp.asarray(frames[0]), *traj[0], radius=10)
    assert st.hist.dtype == torch.float64
    np.testing.assert_array_equal(_np(st.hist), _np(js.hist))
    for i in range(1, len(frames)):
        st = ttr.meanshift_track(st, _t(frames[i]))
        js = jtr.meanshift_track(js, jnp.asarray(frames[i]))
        assert st.cy.dtype == torch.float64
        assert abs(float(st.cy) - float(js.cy)) < 1e-9
        assert abs(float(st.cx) - float(js.cx)) < 1e-9
        assert abs(float(st.cy) - traj[i][0]) < 4.0
        assert abs(float(st.cx) - traj[i][1]) < 4.0


# -------------------------------------------------------------------- SFOT

def _sfot_pair(dy, dx, seed=11):
    rng = np.random.default_rng(seed)
    big = rng.uniform(0, 255, (140, 160)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25])
    big = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, big)
    big = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, big)
    big = big.astype(np.float32)
    return (big[20:120, 20:140],
            big[20 + dy:120 + dy, 20 + dx:140 + dx])


def test_sfot_matches_jax_and_tracks_translation():
    i1, i2 = _sfot_pair(3, -4)
    st, ok = ttr.sfot_track(_t(i1), _t(i2),
                            ttr.sfot_init(50.0, 60.0, 40.0, 50.0,
                                          device="cpu"))
    js, jok = jtr.sfot_track(jnp.asarray(i1), jnp.asarray(i2),
                             jtr.sfot_init(50.0, 60.0, 40.0, 50.0))
    assert bool(ok) == bool(jok) is True
    np.testing.assert_allclose([float(st.cy), float(st.cx)],
                               [float(js.cy), float(js.cx)], atol=1e-3)
    np.testing.assert_allclose([float(st.height), float(st.width),
                                float(st.yaw)],
                               [float(js.height), float(js.width),
                                float(js.yaw)], atol=1e-4)
    assert abs(float(st.cy) - 47.0) < 0.5 and abs(float(st.cx) - 64.0) < 0.5


def test_sfot_region_too_small_for_pairs_holds_scale():
    i1, i2 = _sfot_pair(1, 1, seed=12)
    st, ok = ttr.sfot_track(_t(i1), _t(i2),
                            ttr.sfot_init(50.0, 60.0, 3.0, 3.0, device="cpu"),
                            grid=3)
    js, jok = jtr.sfot_track(jnp.asarray(i1), jnp.asarray(i2),
                             jtr.sfot_init(50.0, 60.0, 3.0, 3.0), grid=3)
    assert bool(ok) == bool(jok)
    np.testing.assert_allclose([float(st.width), float(st.yaw)],
                               [float(js.width), float(js.yaw)], atol=1e-5)


@pytest.mark.parametrize("mask", [[1, 1, 1, 1, 1, 1], [1, 0, 1, 1, 0, 1],
                                  [0, 0, 0, 1, 0, 0], [0] * 6])
def test_masked_median_takes_the_middle_pair(mask):
    v = np.array([4.0, -1.0, 7.5, 2.0, 9.0, 3.0], np.float32)
    m = np.array(mask, bool)
    got = float(ttr._masked_median(_t(v), _t(m)))
    if m.any():
        assert got == float(np.median(v[m]))
    else:
        # the two sentinels' float32 sum overflows, as in the reference
        assert got == float("inf")


# --------------------------------------------------------------- Comaniciu

def test_comaniciu_lattice_is_jnp_linspace_to_an_ulp():
    # XLA's eager linspace rounds a few lattice points one ulp off the
    # same formula's IEEE result; the port computes that formula
    uu, vv = ttr._unit_lattice(24, "cpu")
    u = np.asarray(jnp.linspace(-1.0, 1.0, 24, dtype=jnp.float32))
    np.testing.assert_allclose(_np(uu[:, 0]), u, rtol=0, atol=1.2e-7)
    np.testing.assert_array_equal(_np(uu[:, 0]), _np(vv[0]))


def _growing_target(seed):
    rng = np.random.default_rng(seed)

    def frame(cy, cx, r):
        h, w = 120, 160
        yy, xx = np.mgrid[0:h, 0:w]
        bg = rng.normal(60, 2, (h, w))
        d2 = ((yy - cy) / r) ** 2 + ((xx - cx) / r) ** 2
        obj = np.where(d2 < 1.0, 170.0 + 20 * np.cos(3 * d2), 0.0)
        return (bg + obj).astype(np.float32)
    path = [(44, 56, 13), (48, 62, 14), (52, 68, 16), (56, 74, 18)]
    return frame(40, 50, 12), [(frame(*p), p) for p in path]


def test_comaniciu_histogram_and_one_shift_match_jax():
    f0, frames = _growing_target(4)
    st = ttr.comaniciu_init(_t(f0), 40, 50, 14, 14)
    js = jtr.comaniciu_init(f0, 40, 50, 14, 14)
    np.testing.assert_allclose(_np(st.q), _np(js.q), atol=1e-6)
    assert st.max_value == js.max_value == 256.0
    f = frames[0][0]
    for s in (0.9, 1.0, 1.1):
        for iters in (1, 3):
            got = ttr._comaniciu_shift(_t(f), st.q, st.cy, st.cx, st.ry * s,
                                       st.rx * s, 32, iters, 1e-2)
            want = jtr._comaniciu_shift(jnp.asarray(f), js.q, js.cy, js.cx,
                                        js.ry * s, js.rx * s, 32, iters,
                                        1e-2)
            np.testing.assert_allclose([float(x) for x in got[:2]],
                                       [float(x) for x in want[:2]],
                                       atol=1e-4)
            # the similarity counts whole samples a bin: one that sits
            # on a bin boundary moves it by up to 1e-2
            assert abs(float(got[2]) - float(want[2])) < 1e-2


def test_comaniciu_follows_a_growing_target():
    """30 mean-shift iterations a scale on bin-quantized histograms amplify
    float32 rounding (one sample crossing a bin boundary moves the
    centroid), so whole runs are held to the truth, not to the reference:
    the reference meets its own test's 4 px bar on this scene's seed 4
    only (ROADMAP queue 3); both packages stay within 8 px (the
    ``tracker_mean_shift`` example's bar)."""
    f0, frames = _growing_target(4)
    st = ttr.comaniciu_init(_t(f0), 40, 50, 14, 14)
    for f, (cy, cx, r) in frames:
        st = ttr.comaniciu_track(st, _t(f), update_histogram=True)
        assert np.hypot(float(st.cy) - cy, float(st.cx) - cx) < 8.0
    assert 0.25 * 14 <= float(st.ry) <= 1.5 * 18


def test_comaniciu_reads_a_unit_range_key_frame():
    img = np.random.default_rng(5).uniform(0, 1, (40, 50)).astype(
        np.float32)
    st = ttr.comaniciu_init(_t(img), 20, 25, 6, 6)
    js = jtr.comaniciu_init(img, 20, 25, 6, 6)
    assert st.max_value == js.max_value == 1.0
    np.testing.assert_allclose(_np(st.q), _np(js.q), atol=1e-6)


def test_tracker_example_passes_on_the_cpu():
    from boofcv_tpu_torch.examples import tracker_mean_shift
    assert tracker_mean_shift.main(["--device", "cpu"]) == 0


def test_trackers_ask_for_the_card_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.circulant_init(np.zeros((20, 20), np.float32), 10.0, 10.0,
                           size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.sfot_init(1.0, 2.0, 3.0, 4.0)
