"""The slice end to end: the port's stereo VO against the JAX package's on
the same rendered, integer-valued (camera-like) frames."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.core.pyramid import PyramidConfig as JPyramidConfig
from boofcv_tpu.feature import klt as jklt
from boofcv_tpu.io import simulate as jsim
from boofcv_tpu.ip import pyramid_ops as jpyr
from boofcv_tpu.sfm import stereo_vo as jvo
from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.feature import klt as tklt
from boofcv_tpu_torch.io import simulate as tsim
from boofcv_tpu_torch.ip import pyramid_ops as tpyr
from boofcv_tpu_torch.sfm import stereo_vo as tvo

torch.set_num_threads(1)

H, W = 120, 160
K = np.array([[150.0, 0.0, W / 2], [0.0, 150.0, H / 2], [0.0, 0.0, 1.0]])
BASELINE = 0.3
N_FRAMES = 7
CFG_KW = dict(num_tracks=256, pyramid_scales=(1, 2, 4), max_disparity=48,
              ransac_hypotheses=192, detect_radius=4)
JCFG = jvo.StereoVoConfig(**CFG_KW)
TCFG = tvo.StereoVoConfig(**CFG_KW)


def _poses(n):
    """world->camera poses: forward creep with gentle yaw (as the
    reference's VO test)."""
    poses = []
    for i in range(n):
        a = 0.004 * i
        Rcw = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                        [-np.sin(a), 0.0, np.cos(a)]])
        c = np.array([0.015 * i, 0.0, 0.06 * i])
        R = Rcw.T
        poses.append((R, -R @ c))
    return poses


def _to_numpy_state(s):
    a = np.asarray
    return {"xs": a(s.xs), "ys": a(s.ys), "world": a(s.world),
            "alive": a(s.alive), "R": a(s.R), "t": a(s.t), "key": a(s.key),
            "uid": a(s.uid), "next_uid": a(s.next_uid),
            "templates": {k: [a(x) for x in getattr(s.templates, k)]
                          for k in ("desc", "grad_x", "grad_y")}}


@pytest.fixture(scope="module")
def scene():
    poses = _poses(N_FRAMES)
    frames = tsim.render_stereo_sequence(np.random.default_rng(0), K,
                                         BASELINE, poses, H, W)
    frames = [(np.round(l), np.round(r)) for l, r in frames]
    return poses, frames


@pytest.fixture(scope="module")
def jax_run(scene):
    """The reference's bootstrap and steps (one compile each)."""
    poses, frames = scene
    boot = jvo.make_bootstrap(JCFG, K, BASELINE)
    step = jvo.make_step(JCFG, K, BASELINE)
    s = boot(jvo.init_state(JCFG, H, W), jnp.asarray(frames[0][0]),
             jnp.asarray(frames[0][1]))
    states, centres, oks = [s], [], []
    for left, right in frames[1:]:
        s, m = step(s, jnp.asarray(left), jnp.asarray(right))
        states.append(s)
        oks.append(bool(m["pose_ok"]))
        centres.append(-np.asarray(s.R).T @ np.asarray(s.t))
    return states, np.stack(centres), oks


def test_renderer_matches_jax():
    poses = _poses(3)
    ref = jsim.render_stereo_sequence(
        np.random.default_rng(4), K, BASELINE,
        [(jnp.asarray(R), jnp.asarray(t)) for R, t in poses], H, W)
    out = tsim.render_stereo_sequence(np.random.default_rng(4), K, BASELINE,
                                      poses, H, W)
    for (jl, jr), (tl, tr) in zip(ref, out):
        assert tl.dtype == np.float32
        np.testing.assert_allclose(tl, np.asarray(jl), atol=1e-3, rtol=0)
        np.testing.assert_allclose(tr, np.asarray(jr), atol=1e-3, rtol=0)


def test_bootstrap_matches_jax(scene, jax_run):
    """Same first pair: same slots alive, same positions, world points to
    1e-6 (float64 lift of float32 subpixel disparities)."""
    _, frames = scene
    ref = _to_numpy_state(jax_run[0][0])
    s = tvo.bootstrap(tvo.init_state(TCFG, H, W, device="cpu"),
                      torch.from_numpy(frames[0][0]),
                      torch.from_numpy(frames[0][1]), K, BASELINE, TCFG)
    out = tvo.state_to_numpy(s)
    assert ref["alive"].sum() > 60
    assert np.array_equal(out["alive"], ref["alive"])
    assert np.array_equal(out["xs"], ref["xs"])
    assert np.array_equal(out["ys"], ref["ys"])
    assert np.array_equal(out["uid"], ref["uid"])
    assert int(out["next_uid"]) == int(ref["next_uid"])
    np.testing.assert_allclose(out["world"], ref["world"], atol=1e-6, rtol=0)
    for k in ("desc", "grad_x", "grad_y"):
        for a, b in zip(out["templates"][k], ref["templates"][k]):
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)


def test_state_numpy_roundtrip(jax_run):
    boot = tvo.state_from_numpy(_to_numpy_state(jax_run[0][0]),
                                device="cpu")
    assert boot.rng.initial_seed() == 0     # PRNGKey(0) -> seed 0
    s = tvo.state_from_numpy(_to_numpy_state(jax_run[0][1]), device="cpu")
    back = tvo.state_to_numpy(
        tvo.state_from_numpy(tvo.state_to_numpy(s), device="cpu"))
    ref = tvo.state_to_numpy(s)
    for k in ("xs", "ys", "world", "alive", "R", "t", "uid", "next_uid",
              "key", "rng_state"):
        assert np.array_equal(back[k], ref[k]), k


def test_track_from_converted_state_matches_jax(scene, jax_run):
    """One frame of KLT from the same (converted) reference state: the
    tracked positions to 1e-3 px and the ``tracked`` mask equal."""
    _, frames = scene
    js = jax_run[0][1]                      # after the first step
    left = frames[2][0]
    jp = jpyr.pyramid_average(jnp.asarray(left, jnp.float32),
                              JPyramidConfig(JCFG.pyramid_scales))
    jy, jx, jf = jklt.track_pyramid(jp, js.templates, js.ys, js.xs,
                                    JCFG.pyramid_scales, JCFG.klt)
    jtracked = np.asarray(js.alive) & (np.asarray(jf) == jklt.TRACK_OK)

    ts = tvo.state_from_numpy(_to_numpy_state(js), device="cpu")
    tp = tpyr.pyramid_average(torch.from_numpy(left).float(),
                              PyramidConfig(TCFG.pyramid_scales))
    ty, tx, tf = tklt.track_pyramid(tp, ts.templates, ts.ys, ts.xs,
                                    TCFG.pyramid_scales, TCFG.klt)
    ttracked = ts.alive.numpy() & (tf.numpy() == tklt.TRACK_OK)
    assert jtracked.sum() > 40
    assert np.array_equal(ttracked, jtracked)
    np.testing.assert_allclose(ty.numpy()[jtracked], np.asarray(jy)[jtracked],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(tx.numpy()[jtracked], np.asarray(jx)[jtracked],
                               atol=1e-3, rtol=0)

    # the port's whole track+estimate half-step from the same state: the
    # same tracks survive KLT (RANSAC then draws from another generator)
    track_estimate, _ = tvo._make_step_parts(TCFG, K, BASELINE)
    _, _, _, _, _, (n_tracked, n_inl, ok) = track_estimate(
        ts, torch.from_numpy(left), torch.from_numpy(frames[2][1]))
    assert int(n_tracked) == int(jtracked.sum())
    assert bool(ok) and int(n_inl) > 0.9 * int(n_tracked)


@pytest.fixture(scope="module")
def torch_run(scene):
    poses, frames = scene
    vo = tvo.StereoVisualOdometry(TCFG, K, BASELINE, H, W, device="cpu")
    oks, centres, rots = [], [], []
    for left, right in frames:
        oks.append(vo.process(left, right))
        R, c = vo.camera_to_world()
        centres.append(c)
        rots.append(R)
    return oks, np.stack(centres), rots, vo


def test_vo_run_tracks_ground_truth(scene, torch_run):
    """Every frame's pose accepted; ATE and final rotation within the
    bounds of the reference's own VO test."""
    poses, _ = scene
    oks, centres, rots, vo = torch_run
    assert all(oks)
    assert vo.metrics["inliers"] > 30
    gt = np.stack([-R.T @ t for R, t in poses])
    ate = float(np.mean(np.linalg.norm(centres - gt, axis=1)))
    total = np.linalg.norm(gt[-1])
    assert ate < 0.15 * max(total, 0.1), ate
    dR = rots[-1].T @ poses[-1][0].T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 2.0, ang


def test_vo_run_matches_jax(jax_run, torch_run):
    """Per-frame camera centres within 0.05 of the reference's run (the
    two RANSAC streams differ, so not bit for bit)."""
    _, jcentres, joks = jax_run
    oks, centres, _, _ = torch_run
    assert all(joks) and all(oks)
    err = np.linalg.norm(centres[1:] - jcentres, axis=1)
    assert err.max() < 0.05, err


def test_sequence_runner_matches_stepwise(scene):
    """make_sequence_runner is the step in a loop: identical results."""
    _, frames = scene
    boot = tvo.make_bootstrap(TCFG, K, BASELINE)
    s0 = boot(tvo.init_state(TCFG, H, W, seed=3, device="cpu"),
              torch.from_numpy(frames[0][0]), torch.from_numpy(frames[0][1]))
    step = tvo.make_step(TCFG, K, BASELINE)
    s = s0
    Rs, ts = [], []
    for left, right in frames[1:]:
        s, _ = step(s, torch.from_numpy(left), torch.from_numpy(right))
        Rs.append(s.R)
        ts.append(s.t)
    run = tvo.make_sequence_runner(TCFG, K, BASELINE)
    lefts = torch.stack([torch.from_numpy(l) for l, _ in frames[1:]])
    rights = torch.stack([torch.from_numpy(r) for _, r in frames[1:]])
    s2, ((Rr, tr), ms) = run(s0, lefts, rights)
    assert torch.equal(Rr, torch.stack(Rs))
    assert torch.equal(tr, torch.stack(ts))
    assert torch.equal(s2.alive, s.alive)
    assert ms["pose_ok"].shape == (len(frames) - 1,)
    assert bool(ms["pose_ok"].all())


@pytest.mark.parametrize("entry", ["init_state", "state_from_numpy",
                                   "StereoVisualOdometry"])
def test_default_device_is_the_card(entry, monkeypatch):
    """With no ``device`` the entry points run on the card: without one
    they raise a RuntimeError that names CUDA, and move nothing to the
    CPU; with ``device="cpu"`` they behave as before."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = tvo.StereoVoConfig(num_tracks=8, pyramid_scales=(1, 2))
    calls = {
        "init_state": lambda **kw: tvo.init_state(small, H, W, **kw),
        "state_from_numpy": lambda **kw: tvo.state_from_numpy(
            tvo.state_to_numpy(tvo.init_state(small, H, W, device="cpu")),
            **kw),
        "StereoVisualOdometry": lambda **kw: tvo.StereoVisualOdometry(
            small, K, BASELINE, H, W, **kw).state,
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    state = calls[entry](device="cpu")
    assert state.xs.device.type == "cpu" and state.xs.shape == (8,)
    assert state.rng.device.type == "cpu"


def test_port_imports_no_jax():
    code = ("import sys, boofcv_tpu_torch.sfm.stereo_vo, "
            "boofcv_tpu_torch.io.simulate, boofcv_tpu_torch.kernels._nvcc, "
            "boofcv_tpu_torch.kernels.klt_track; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'boofcv_tpu.'))); print(bad); "
            "sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
