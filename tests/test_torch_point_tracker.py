"""The port's point trackers against the JAX package's on the JAX tests'
scenes (``tests/test_seg_trackers.py``), on the CPU: KLT, DDA, combined and
two-pass.

Each tracker is held twice: to the JAX test's own bars on the port alone,
and from the same pool (the reference's, put into the port's tracker with
``load_pool``) on the same next frame.  Tolerances: KLT spawns (integer
Shi-Tomasi corners) and uids exact; KLT positions within 1e-3 px with the
same alive mask; SURF positions within 0.01 px (float32 integral images
summed in another order), on the tracks that sit on the DDA scene's
blobs."""

import numpy as np
import pytest
import torch

from boofcv_tpu.feature import point_tracker as jpt
from boofcv_tpu.io.simulate import noise_texture
from boofcv_tpu_torch.feature import point_tracker as tpt

torch.set_num_threads(1)


def klt_pool(t):
    """A reference KLT tracker's pool as numpy."""
    pool = {"xs": np.asarray(t.xs), "ys": np.asarray(t.ys),
            "alive": np.asarray(t.alive), "uid": t.uid.copy(),
            "next_uid": t._next_uid,
            "templates": {k: [np.asarray(a) for a in getattr(t._tmpl, k)]
                          for k in ("desc", "grad_x", "grad_y")}}
    if hasattr(t, "has_desc"):
        pool.update(desc=t.desc.copy(), has_desc=t.has_desc.copy())
    return pool


def active(t):
    return {tr.uid: (tr.x, tr.y) for tr in t.active_tracks()}


def assert_same_tracks(out, ref, atol):
    assert sorted(out) == sorted(ref)
    for u, (x, y) in ref.items():
        assert abs(out[u][0] - x) <= atol and abs(out[u][1] - y) <= atol, u


@pytest.fixture(scope="module")
def klt_frames():
    big = np.array(noise_texture(np.random.default_rng(7), size=200))
    return big[20:120, 20:150].copy(), big[23:123, 24:154].copy()


def test_klt_tracker_matches_jax(klt_frames):
    f0, f1 = klt_frames
    ref = jpt.PointTrackerKlt(max_tracks=100)
    out = tpt.PointTrackerKlt(max_tracks=100, device="cpu")
    for t in (ref, out):
        t.process(f0)
        t.spawn()
    assert active(out) == active(ref) and len(active(ref)) > 30
    before = active(out)
    ref.process(f1)
    out.process(f1)
    assert_same_tracks(active(out), active(ref), 1e-3)
    # the reference test's bars: most tracks survive, moved by (-4, -3)
    after = active(out)
    assert len(after) > 0.7 * len(before)
    moves = np.array([(x - before[u][0], y - before[u][1])
                      for u, (x, y) in after.items()])
    np.testing.assert_allclose(np.median(moves, 0), (-4.0, -3.0), atol=0.2)


def test_klt_tracker_from_loaded_pool(klt_frames):
    """The reference's pool loaded into the port: the same step."""
    f0, f1 = klt_frames
    ref = jpt.PointTrackerKlt(max_tracks=100)
    ref.process(f0)
    ref.spawn()
    out = tpt.PointTrackerKlt(max_tracks=100, device="cpu")
    out.load_pool(klt_pool(ref), image=f0)
    assert active(out) == active(ref)
    ref.process(f1)
    out.process(f1)
    assert_same_tracks(active(out), active(ref), 1e-3)
    ref.spawn()
    out.spawn()
    assert_same_tracks(active(out), active(ref), 1e-3)
    assert out._next_uid == ref._next_uid


@pytest.fixture(scope="module")
def blob_frames():
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[0:150, 0:200]
    img = np.zeros((150, 200), np.float32)
    centres = np.stack([rng.uniform(25, 125, 12),
                        rng.uniform(25, 175, 12)], 1)
    for cy, cx in centres:
        img += 200 * np.exp(-0.5 * (((yy - cy) / 4) ** 2
                                    + ((xx - cx) / 4) ** 2))
    shifted = np.zeros_like(img)
    shifted[:-5, :-7] = img[5:, 7:]
    return img, shifted, centres[:, ::-1]          # centres as (x, y)


def on_blobs(tracks, centres, tol=1.5):
    """The tracks within ``tol`` px of a blob centre.  The rest of the
    blob scene's responses are weak spurious ones, from the rounding of
    float32 integral images over the flat background and from overlapping
    blobs: where they lie, and which of their near-equal descriptors
    mutual-NN association pairs, rounding decides, differently in each
    library."""
    return {u: p for u, p in tracks.items()
            if np.abs(centres - p).max(1).min() < tol}


def moved(before, after, dx, dy, tol):
    """The uids in ``after`` that moved by (dx, dy) within ``tol``."""
    return {u for u, (x, y) in after.items() if u in before
            and abs(x - before[u][0] - dx) < tol
            and abs(y - before[u][1] - dy) < tol}


def test_dda_tracker_matches_jax(blob_frames):
    img, shifted, centres = blob_frames
    ref = jpt.PointTrackerDda(max_tracks=50)
    out = tpt.PointTrackerDda(max_tracks=50, device="cpu")
    for t in (ref, out):
        t.process(img)
        t.spawn()
    before = active(out)
    assert len(on_blobs(before, centres)) >= 8
    assert_same_tracks(on_blobs(before, centres),
                       on_blobs(active(ref), centres), 0.01)
    for t in (ref, out):
        t.process(shifted)
    after = active(out)
    moved_c = centres - (7, 5)
    assert_same_tracks(on_blobs(after, moved_c),
                       on_blobs(active(ref), moved_c), 0.01)
    # the reference test's bars
    assert len(after) >= 0.6 * len(before)
    assert len(moved(before, after, -7, -5, 2.0)) >= 0.9 * len(after)


def test_dda_tracker_from_loaded_pool(blob_frames):
    img, shifted, centres = blob_frames
    ref = jpt.PointTrackerDda(max_tracks=50)
    ref.process(img)
    ref.spawn()
    out = tpt.PointTrackerDda(max_tracks=50, device="cpu")
    out.load_pool({"xs": ref.xs, "ys": ref.ys, "alive": ref.alive,
                   "uid": ref.uid, "next_uid": ref._next_uid,
                   "desc": ref.desc})
    assert active(out) == active(ref)
    ref.process(shifted)
    out.process(shifted)
    moved_c = centres - (7, 5)
    assert len(on_blobs(active(ref), moved_c)) >= 8
    assert_same_tracks(on_blobs(active(out), moved_c),
                       on_blobs(active(ref), moved_c), 0.01)


@pytest.fixture(scope="module")
def jump_frames():
    img = np.array(noise_texture(np.random.default_rng(9), size=256)
                   )[:200, :230].copy()
    small = np.zeros_like(img)
    small[:-2, :-1] = img[2:, 1:]
    jump = np.zeros_like(img)
    jump[:-25, :-30] = img[25:, 30:]
    return img, small, jump


def test_combined_tracker_reacquires_after_jump(jump_frames):
    """The reference test's bars on the port, and the same tracks as the
    reference after the spawn and after the small move."""
    img, small, jump = jump_frames
    ref = jpt.PointTrackerCombined(max_tracks=60, scales=(1, 2))
    t = tpt.PointTrackerCombined(max_tracks=60, scales=(1, 2), device="cpu")
    for tr in (ref, t):
        tr.process(img)
        tr.spawn()
    before = active(t)
    assert len(before) >= 8
    assert_same_tracks(before, active(ref), 0.01)
    for tr in (ref, t):
        tr.process(small)
    assert len(active(t)) >= 0.7 * len(before)
    assert_same_tracks(active(t), active(ref), 0.01)
    t.process(jump)
    after = active(t)
    recovered = [u for u in after if u in before]
    assert len(recovered) >= 5, len(recovered)
    good = sum(1 for u in recovered
               if abs(after[u][0] - before[u][0] + 30) < 3.0
               and abs(after[u][1] - before[u][1] + 25) < 3.0)
    assert good >= 0.6 * len(recovered), (good, len(recovered))


def test_combined_tracker_from_loaded_pool(jump_frames):
    """The re-association pass from the reference's pool: the same tracks
    recovered at the same places."""
    img, small, jump = jump_frames
    ref = jpt.PointTrackerCombined(max_tracks=60, scales=(1, 2))
    ref.process(img)
    ref.spawn()
    ref.process(small)
    out = tpt.PointTrackerCombined(max_tracks=60, scales=(1, 2),
                                   device="cpu")
    out.load_pool(klt_pool(ref), image=small)
    ref.process(jump)
    out.process(jump)
    assert_same_tracks(active(out), active(ref), 0.01)
    assert len(active(ref)) >= 5


def test_two_pass_tracker_recovers_with_hints():
    """The reference test's bars on the port, and the same committed tracks
    as the reference from the same pool and hints."""
    big = np.array(noise_texture(np.random.default_rng(12), size=256))
    dy, dx = 14, 10
    i1 = big[20:140, 20:180].copy()
    i2 = big[20 + dy:140 + dy, 20 + dx:180 + dx].copy()
    ref = jpt.PointTrackerTwoPassKlt(max_tracks=80, scales=(1, 2))
    t = tpt.PointTrackerTwoPassKlt(max_tracks=80, scales=(1, 2),
                                   device="cpu")
    for tr in (ref, t):
        tr.process(i1)
        tr.spawn()
    before = active(t)
    assert active(t) == active(ref) and len(before) >= 20
    for tr in (ref, t):
        tr.process(i2)
    n_first = int(t._pending[2].sum())
    assert n_first == int(np.asarray(ref._pending[2]).sum())
    ref.second_pass(np.asarray(ref.ys) - dy, np.asarray(ref.xs) - dx)
    t.second_pass(t.ys.numpy() - dy, t.xs.numpy() - dx)
    for tr in (ref, t):
        tr.finish()
    after = active(t)
    assert_same_tracks(after, active(ref), 1e-3)
    assert len(after) > max(n_first, 0.5 * len(before))
    good = sum(1 for u in after if u in before
               and abs(after[u][0] - before[u][0] + dx) < 0.5
               and abs(after[u][1] - before[u][1] + dy) < 0.5)
    assert good >= 0.8 * len(after), (good, len(after))


@pytest.mark.parametrize("cls", ["PointTrackerKlt", "PointTrackerDda",
                                 "PointTrackerCombined",
                                 "PointTrackerTwoPassKlt"])
def test_default_device_is_the_card(cls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(tpt, cls)(max_tracks=4)
    assert getattr(tpt, cls)(max_tracks=4, device="cpu").n == 4
