"""The port's depth, dual-track, quad and overhead VO against the JAX
package's on the JAX tests' scenes (120x160, ``tests/test_vo_variants.py``
and ``tests/test_depth_direct_vo.py``), on the CPU.

RANSAC is made the same in both: the port's ``robust.sample_indices`` is
replaced by the reference's draw from the reference's key chain (one split
a step), fed the port's own valid mask.  Tolerances: a bootstrap's
positions and alive mask exact and ``world`` within 1e-6 (the right
camera's x, which carries the float32 subpixel disparity, within 1e-4 px);
one step from a converted reference state within 1e-3 px, the same alive
mask, and ``R, t`` within ``POSE_TOL``: the pose ends in a float32
Gauss-Newton refine whose sums over the tracks run in another order in
each library, which moves its fixed point by a few 1e-6 (the quad step's
SURF positions, from float32 prefix sums of another order, move by up to
1e-3 px, so 1e-4 there); whole trajectories within the JAX tests' own bars
and within 1e-4 of the reference's run; ``ransac_se2`` within 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from boofcv_tpu.geo import robust as jrobust
from boofcv_tpu.geo import se3 as jse3
from boofcv_tpu.io import simulate as jsim
from boofcv_tpu.sfm import depth_vo as jdepth
from boofcv_tpu.sfm import dual_track_vo as jdual
from boofcv_tpu.sfm import overhead_vo as jover
from boofcv_tpu.sfm import quad_vo as jquad
from boofcv_tpu.sfm import stereo_vo as jsvo
from boofcv_tpu_torch.geo import robust as trobust
from boofcv_tpu_torch.sfm import depth_vo as tdepth
from boofcv_tpu_torch.sfm import dual_track_vo as tdual
from boofcv_tpu_torch.sfm import overhead_vo as tover
from boofcv_tpu_torch.sfm import quad_vo as tquad
from boofcv_tpu_torch.sfm import stereo_vo as tsvo

torch.set_num_threads(1)

H, W = 120, 160
K = np.array([[150.0, 0.0, W / 2], [0.0, 150.0, H / 2], [0.0, 0.0, 1.0]])
BASELINE = 0.3
POSE_TOL = 1e-5


def numpy_state(s):
    """A reference state (NamedTuple of arrays, nested NamedTuples as
    dicts, KltTemplates as dicts of per-level lists) as numpy."""
    out = {}
    for k, v in s._asdict().items():
        if hasattr(v, "_asdict"):
            v = {f: ([np.asarray(x) for x in a] if isinstance(a, tuple)
                     else np.asarray(a)) for f, a in v._asdict().items()}
        else:
            v = np.asarray(v)
        out[k] = v
    return out


def use_jax_draws(monkeypatch, key):
    """The port's RANSAC draws what the reference draws: each call splits
    ``key`` as the reference's step does and takes its index sets, on the
    port's own valid mask."""
    chain = {"key": key}

    def sample(generator, k, s, n, valid_mask=None):
        chain["key"], sub = jax.random.split(chain["key"])
        vm = None if valid_mask is None else jnp.asarray(valid_mask.numpy())
        return torch.from_numpy(np.asarray(
            jrobust.sample_indices(sub, k, s, n, vm))).long()

    monkeypatch.setattr(trobust, "sample_indices", sample)


def assert_pose_close(family, frame, out, ref, tol):
    """``R, t`` of a converted step within ``tol`` of the reference's; the
    gap is printed (``pytest -s -k converted`` lists every family's)."""
    dR = float(np.abs(out["R"] - ref["R"]).max())
    dt = float(np.abs(out["t"] - ref["t"]).max())
    print(f"converted step {family} frame {frame}: max|dR|={dR:.3e} "
          f"max|dt|={dt:.3e} (tol {tol:g})")
    assert dR <= tol and dt <= tol, (dR, dt)


def centres_err(traj, poses):
    return [float(np.linalg.norm(c - (-np.asarray(R).T @ np.asarray(t))))
            for (_, c), (R, t) in zip(traj, poses)]


# ---------------------------------------------------------------------------
# depth VO (tests/test_depth_direct_vo.py's scene)
# ---------------------------------------------------------------------------

def render_rgbd(rng, poses):
    """Gray + exact depth of the reference test's plane world (the plane
    6 m ahead, tilted as ``render_plane``'s default)."""
    tex = jsim.noise_texture(rng)
    grays = [np.array(jsim.render_plane(tex, K, R, t, H, W,
                                        plane_origin=(0.0, 0.0, 6.0)))
             for R, t in poses]
    return list(zip(grays, chip_smoke.plane_depths(poses, K, H, W,
                                                   origin=(0.0, 0.0, 6.0))))


def make_traj(n=6, step=0.05):
    poses = []
    for i in range(n):
        R = np.asarray(jse3.exp_so3(jnp.asarray([0.0, 0.003 * i, 0.0])))
        c = np.array([0.01 * i, 0.0, step * i])
        poses.append((R, -R @ c))
    return poses


DEPTH_KW = dict(num_tracks=256, pyramid_scales=(1, 2, 4),
                ransac_hypotheses=192, detect_radius=4)


@pytest.fixture(scope="module")
def depth_scene():
    poses = make_traj()
    return poses, render_rgbd(np.random.default_rng(0), poses)


@pytest.fixture(scope="module")
def depth_jax(depth_scene):
    """The reference's run: its state after every frame, and its pose
    errors."""
    poses, frames = depth_scene
    vo = jdepth.DepthVisualOdometry(jsvo.StereoVoConfig(**DEPTH_KW), K, H, W)
    states, traj = [], []
    for gray, depth in frames:
        assert vo.process(gray, depth)
        states.append(vo.state)
        traj.append(vo.camera_to_world())
    return states, centres_err(traj, poses)


def test_depth_bootstrap_matches_jax(depth_scene, depth_jax):
    _, frames = depth_scene
    ref = numpy_state(depth_jax[0][0])
    cfg = tsvo.StereoVoConfig(**DEPTH_KW)
    _, boot = tdepth.make_step(cfg, K)
    s = boot(tsvo.init_state(cfg, H, W, device="cpu"),
             torch.from_numpy(frames[0][0]), torch.from_numpy(frames[0][1]))
    out = tsvo.state_to_numpy(s)
    assert ref["alive"].sum() > 60
    for k in ("alive", "xs", "ys"):
        assert np.array_equal(out[k], ref[k]), k
    np.testing.assert_allclose(out["world"], ref["world"], atol=1e-6, rtol=0)
    # the port numbers the spawned tracks (the reference leaves -1)
    assert sorted(out["uid"][out["alive"]]) == list(range(ref["alive"].sum()))


@pytest.mark.parametrize("frame", [2, 4])
def test_depth_step_from_converted_state_matches_jax(depth_scene, depth_jax,
                                                     frame, monkeypatch):
    _, frames = depth_scene
    states, _ = depth_jax
    ref_before, ref = states[frame - 1], numpy_state(states[frame])
    use_jax_draws(monkeypatch, ref_before.key)
    step, _ = tdepth.make_step(tsvo.StereoVoConfig(**DEPTH_KW), K)
    s, m = step(tsvo.state_from_numpy(numpy_state(ref_before), device="cpu"),
                torch.from_numpy(frames[frame][0]),
                torch.from_numpy(frames[frame][1]))
    out = tsvo.state_to_numpy(s)
    assert bool(m["pose_ok"])
    assert np.array_equal(out["alive"], ref["alive"])
    a = ref["alive"]
    np.testing.assert_allclose(out["xs"][a], ref["xs"][a], atol=1e-3, rtol=0)
    np.testing.assert_allclose(out["ys"][a], ref["ys"][a], atol=1e-3, rtol=0)
    assert_pose_close("depth", frame, out, ref, POSE_TOL)


def test_depth_vo_recovers_trajectory(depth_scene, depth_jax, monkeypatch):
    """The reference test's bar (mean centre error < 0.05), and the
    reference's own draws give the reference's trajectory within 1e-4."""
    poses, frames = depth_scene
    use_jax_draws(monkeypatch, jax.random.PRNGKey(0))
    vo = tdepth.DepthVisualOdometry(tsvo.StereoVoConfig(**DEPTH_KW), K, H, W,
                                    device="cpu")
    traj = []
    for gray, depth in frames:
        assert vo.process(gray, depth)
        traj.append(vo.camera_to_world())
    errs = centres_err(traj, poses)
    assert np.mean(errs) < 0.05, errs
    np.testing.assert_allclose(errs, depth_jax[1], atol=1e-4)


# ---------------------------------------------------------------------------
# stereo scene of tests/test_vo_variants.py: dual-track and quad VO
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stereo_scene():
    poses = []
    for i in range(6):
        c = np.array([0.01 * i, 0.0, 0.06 * i])
        poses.append((np.eye(3), -c))
    frames = jsim.render_stereo_sequence(np.random.default_rng(3), K,
                                         BASELINE, poses, H, W)
    return poses, [(np.array(l), np.array(r)) for l, r in frames]


DUAL_KW = dict(num_tracks=256, pyramid_scales=(1, 2, 4), max_disparity=48,
               ransac_hypotheses=192, detect_radius=4)


def _run_jax(vo, frames, poses):
    states, traj, oks = [], [], []
    for left, right in frames:
        oks.append(vo.process(left, right))
        states.append(vo.state)
        traj.append(vo.camera_to_world())
    return states, centres_err(traj, poses), oks


@pytest.fixture(scope="module")
def dual_jax(stereo_scene):
    poses, frames = stereo_scene
    return _run_jax(jdual.DualTrackVisualOdometry(
        jdual.DualTrackVoConfig(**DUAL_KW), K, BASELINE), frames, poses)


def test_dual_bootstrap_matches_jax(stereo_scene, dual_jax):
    _, frames = stereo_scene
    ref = numpy_state(dual_jax[0][0])
    cfg = tdual.DualTrackVoConfig(**DUAL_KW)
    boot = tdual.make_bootstrap(cfg, K, BASELINE)
    out = tdual.state_to_numpy(boot(tdual.init_state(cfg, device="cpu"),
                                    torch.from_numpy(frames[0][0]),
                                    torch.from_numpy(frames[0][1])))
    assert ref["alive"].sum() > 60
    for k in ("alive", "lxs", "lys", "rys"):
        assert np.array_equal(out[k], ref[k]), k
    np.testing.assert_allclose(out["rxs"], ref["rxs"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(out["world"], ref["world"], atol=1e-6, rtol=0)
    for side in ("tmpl_l", "tmpl_r"):
        for k in ("desc", "grad_x", "grad_y"):
            for a, b in zip(out[side][k], ref[side][k]):
                np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)


def test_dual_state_numpy_roundtrip(dual_jax):
    s = tdual.state_from_numpy(numpy_state(dual_jax[0][2]), device="cpu")
    assert s.rng.initial_seed() == tsvo._key_to_seed(dual_jax[0][2].key)
    ref = tdual.state_to_numpy(s)
    back = tdual.state_to_numpy(tdual.state_from_numpy(ref, device="cpu"))
    for k in ("lxs", "lys", "rxs", "rys", "world", "alive", "R", "t", "key",
              "rng_state"):
        assert np.array_equal(back[k], ref[k]), k


@pytest.mark.parametrize("frame", [2, 4])
def test_dual_step_from_converted_state_matches_jax(stereo_scene, dual_jax,
                                                    frame, monkeypatch):
    _, frames = stereo_scene
    states = dual_jax[0]
    ref_before, ref = states[frame - 1], numpy_state(states[frame])
    use_jax_draws(monkeypatch, ref_before.key)
    step = tdual.make_step(tdual.DualTrackVoConfig(**DUAL_KW), K, BASELINE)
    s, m = step(tdual.state_from_numpy(numpy_state(ref_before),
                                       device="cpu"),
                torch.from_numpy(frames[frame][0]),
                torch.from_numpy(frames[frame][1]))
    out = tdual.state_to_numpy(s)
    assert bool(m["pose_ok"]) and int(m["inliers"]) > 30
    assert np.array_equal(out["alive"], ref["alive"])
    a = ref["alive"]
    for k in ("lxs", "lys", "rxs", "rys"):
        np.testing.assert_allclose(out[k][a], ref[k][a], atol=1e-3, rtol=0)
    assert_pose_close("dual", frame, out, ref, POSE_TOL)


def test_dual_track_vo_recovers_motion(stereo_scene, dual_jax, monkeypatch):
    """The reference test's bars (every pose, > 30 inliers, ATE < 0.15 x
    motion), and within 1e-4 of the reference's run on its draws."""
    poses, frames = stereo_scene
    use_jax_draws(monkeypatch, jax.random.PRNGKey(0))
    vo = tdual.DualTrackVisualOdometry(tdual.DualTrackVoConfig(**DUAL_KW), K,
                                       BASELINE, device="cpu")
    _, errs, oks = _run_jax(vo, frames, poses)
    assert all(oks), oks
    assert vo.metrics["inliers"] > 30
    total = np.linalg.norm(poses[-1][1])
    assert np.mean(errs) < 0.15 * max(total, 0.1)
    np.testing.assert_allclose(errs, dual_jax[1], atol=1e-4)


QUAD_KW = dict(num_features=192, max_disparity=48, ransac_hypotheses=192)


@pytest.fixture(scope="module")
def quad_jax(stereo_scene):
    poses, frames = stereo_scene
    return _run_jax(jquad.QuadVisualOdometry(jquad.QuadVoConfig(**QUAD_KW),
                                             K, BASELINE), frames, poses)


def _same_set(a, b, tol):
    """Rows of a and b pair up within ``tol`` (max norm), but for 1 % of
    either (a response that float32 rounding moves across the threshold or
    a nonmax neighbour)."""
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    spare = max(len(a), len(b)) // 100
    return bool((d.min(1) > tol).sum() <= spare
                and (d.min(0) > tol).sum() <= spare)


def test_quad_bootstrap_matches_jax(stereo_scene, quad_jax):
    """Detections as sets (``topk`` and ``top_k`` order ties apart; the
    float32 integral images sum in another order, so positions agree to
    0.01 px), and the same stereo pairs between them."""
    _, frames = stereo_scene
    ref = numpy_state(quad_jax[0][0])
    cfg = tquad.QuadVoConfig(**QUAD_KW)
    out = tquad.state_to_numpy(tquad.make_bootstrap(cfg)(
        tquad.init_state(cfg, device="cpu"), torch.from_numpy(frames[0][0]),
        torch.from_numpy(frames[0][1])))

    def points(f):
        return np.stack([f["ys"], f["xs"]], 1)[f["valid"]]

    def pairs(st):
        ok = st["lr_ok"]
        return np.stack([st["left"]["ys"][ok], st["left"]["xs"][ok],
                         st["right"]["xs"][st["lr_dst"][ok]]], 1)

    for side in ("left", "right"):
        assert len(points(ref[side])) > 100
        assert _same_set(points(out[side]), points(ref[side]), 0.01)
    assert len(pairs(ref)) > 30
    assert _same_set(pairs(out), pairs(ref), 0.01)


def test_quad_state_numpy_roundtrip(quad_jax):
    s = tquad.state_from_numpy(numpy_state(quad_jax[0][1]), device="cpu")
    ref = tquad.state_to_numpy(s)
    back = tquad.state_to_numpy(tquad.state_from_numpy(ref, device="cpu"))
    for side in ("left", "right"):
        for k in ("ys", "xs", "desc", "valid"):
            assert np.array_equal(back[side][k], ref[side][k])
    for k in ("lr_dst", "lr_ok", "R", "t", "key", "rng_state"):
        assert np.array_equal(back[k], ref[k]), k


@pytest.mark.parametrize("frame", [2, 4])
def test_quad_step_from_converted_state_matches_jax(stereo_scene, quad_jax,
                                                    frame, monkeypatch):
    _, frames = stereo_scene
    states = quad_jax[0]
    ref_before, ref = states[frame - 1], numpy_state(states[frame])
    use_jax_draws(monkeypatch, ref_before.key)
    step = tquad.make_step(tquad.QuadVoConfig(**QUAD_KW), K, BASELINE)
    s, m = step(tquad.state_from_numpy(numpy_state(ref_before),
                                       device="cpu"),
                torch.from_numpy(frames[frame][0]),
                torch.from_numpy(frames[frame][1]))
    out = tquad.state_to_numpy(s)
    assert bool(m["pose_ok"]) and int(m["quads"]) > 20
    assert_pose_close("quad", frame, out, ref, 10 * POSE_TOL)


def test_quad_vo_recovers_motion(stereo_scene, quad_jax, monkeypatch):
    """The reference test's bars (every pose after the first, ATE < 0.25 x
    motion), and within 1e-3 of the reference's run on its draws (SURF
    positions differ by up to 1e-3 px, see the module docstring)."""
    poses, frames = stereo_scene
    use_jax_draws(monkeypatch, jax.random.PRNGKey(0))
    vo = tquad.QuadVisualOdometry(tquad.QuadVoConfig(**QUAD_KW), K, BASELINE,
                                  device="cpu")
    _, errs, oks = _run_jax(vo, frames, poses)
    assert all(oks[1:]), oks
    total = np.linalg.norm(poses[-1][1])
    assert np.mean(errs) < 0.25 * max(total, 0.1)
    np.testing.assert_allclose(errs, quad_jax[1], atol=1e-3)


# ---------------------------------------------------------------------------
# overhead VO and ransac_se2
# ---------------------------------------------------------------------------

def _se2_points(rng):
    ang, tx, ty = 0.3, 4.0, -2.0
    p = rng.uniform(-50, 50, (64, 2))
    ca, sa = np.cos(ang), np.sin(ang)
    q = np.stack([ca * p[:, 0] - sa * p[:, 1] + tx,
                  sa * p[:, 0] + ca * p[:, 1] + ty], -1)
    q[:12] += rng.uniform(20, 40, (12, 2))         # 20 % outliers
    return (ang, tx, ty), p, q


def test_ransac_se2_matches_jax():
    """The reference's index sets through ``idx=``: the same model to 1e-9
    and the same inliers; the reference test's exactness bars; B = 2
    streams at once give each stream's result."""
    truth, p, q = _se2_points(np.random.default_rng(0))
    valid = np.ones(64, bool)
    valid[20:24] = False
    key = jax.random.PRNGKey(0)
    ref = jover.ransac_se2(key, jnp.asarray(p), jnp.asarray(q),
                           inlier_threshold_px=1.0,
                           valid_mask=jnp.asarray(valid))
    idx = torch.from_numpy(np.asarray(jrobust.sample_indices(
        key, 256, 2, 64, jnp.asarray(valid)))).long()
    out = tover.ransac_se2(None, torch.from_numpy(p), torch.from_numpy(q),
                           inlier_threshold_px=1.0,
                           valid_mask=torch.from_numpy(valid), idx=idx)
    np.testing.assert_allclose(out.model.numpy(), np.asarray(ref.model),
                               atol=1e-9, rtol=0)
    assert np.array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    assert int(out.num_inliers) >= 48
    np.testing.assert_allclose(out.model.numpy(), truth, atol=1e-5)
    both = tover.ransac_se2(
        None, torch.from_numpy(np.stack([p, p[::-1].copy()])),
        torch.from_numpy(np.stack([q, q[::-1].copy()])),
        inlier_threshold_px=1.0, idx=torch.stack([idx, 63 - idx]))
    np.testing.assert_allclose(both.model[0].numpy(), truth, atol=1e-5)
    np.testing.assert_allclose(both.model[1].numpy(), truth, atol=1e-5)


def test_ransac_se2_draws_from_the_generator():
    truth, p, q = _se2_points(np.random.default_rng(1))
    g = torch.Generator().manual_seed(5)
    out = tover.ransac_se2(g, torch.from_numpy(p), torch.from_numpy(q),
                           inlier_threshold_px=1.0)
    assert int(out.num_inliers) >= 48
    np.testing.assert_allclose(out.model.numpy(), truth, atol=1e-5)


OVER_H = 1.5
PITCH = 0.6


def _plane_extrinsics():
    c_, s_ = np.cos(PITCH), np.sin(PITCH)
    Rp = np.array([[1.0, 0, 0], [0, c_, -s_], [0, s_, c_]])
    return Rp, Rp @ np.array([0.0, OVER_H, 0.0])


def test_overhead_map_and_render_match_jax():
    Rp, tp = _plane_extrinsics()
    args = (K, Rp, tp, H, W, 160, 160, 0.05, -4.0, 1.0)
    ref = jover.create_overhead_map(*args)
    out = tover.create_overhead_map(*args, device="cpu")
    assert np.array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert out.valid.numpy().mean() > 0.3
    np.testing.assert_allclose(out.map_x.numpy(), np.asarray(ref.map_x),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.map_y.numpy(), np.asarray(ref.map_y),
                               atol=1e-4, rtol=0)
    img = np.random.default_rng(2).uniform(0, 255, (H, W)).astype(np.float32)
    np.testing.assert_allclose(
        tover.render_overhead(torch.from_numpy(img), out).numpy(),
        np.asarray(jover.render_overhead(jnp.asarray(img), ref)),
        atol=1e-2, rtol=0)


@pytest.fixture(scope="module")
def overhead_scene():
    """tests/test_vo_variants.py's scene: forward motion over a textured
    ground plane, camera 1.5 m up, pitched down 0.6 rad."""
    rng = np.random.default_rng(5)
    Rp, tp = _plane_extrinsics()
    tex = jsim.noise_texture(rng)
    frames = []
    for i in range(6):
        t = -Rp @ np.array([0.0, 0.0, 0.08 * i])
        frames.append(np.array(jsim.render_plane(
            tex, K, jnp.asarray(Rp), jnp.asarray(t), H, W,
            plane_origin=(0.0, OVER_H, 0.0), plane_x=(1.0, 0.0, 0.0),
            plane_y=(0.0, 0.0, 1.0), texture_scale=60.0)))
    return Rp, tp, frames


OVER_KW = dict(overhead_shape=(192, 192), cell=0.02, center_z=1.0,
               num_tracks=256)


def test_overhead_vo_recovers_forward_motion(overhead_scene, monkeypatch):
    """The reference test's bars (|z - 0.4| < 25 %, |x| < 0.1, |yaw| <
    0.05), and the reference's own run on the same draws within 1e-6."""
    Rp, tp, frames = overhead_scene
    ref = jover.MonoOverheadVisualOdometry(K, Rp, tp, H, W, **OVER_KW)
    for img in frames:
        assert ref.process(img)
    use_jax_draws(monkeypatch, jax.random.PRNGKey(0))
    vo = tover.MonoOverheadVisualOdometry(K, Rp, tp, H, W, device="cpu",
                                          **OVER_KW)
    for img in frames:
        assert vo.process(img)
    x, z, yaw = vo.plane_motion()
    assert abs(z - 0.4) < 0.25 * 0.4, (x, z, yaw)
    assert abs(x) < 0.1 and abs(yaw) < 0.05
    np.testing.assert_allclose(vo.plane_motion(), ref.plane_motion(),
                               atol=1e-6)
    for a, b in zip(vo.camera_to_world(), ref.camera_to_world()):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("entry", ["depth", "dual", "quad", "overhead"])
def test_default_device_is_the_card(entry, monkeypatch):
    """Asked for the card without one, each front end raises a RuntimeError
    that names CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Rp, tp = _plane_extrinsics()
    make = {
        "depth": lambda: tdepth.DepthVisualOdometry(
            tsvo.StereoVoConfig(num_tracks=8), K, H, W),
        "dual": lambda: tdual.DualTrackVisualOdometry(
            tdual.DualTrackVoConfig(num_tracks=8), K, BASELINE),
        "quad": lambda: tquad.QuadVisualOdometry(
            tquad.QuadVoConfig(num_features=8), K, BASELINE),
        "overhead": lambda: tover.MonoOverheadVisualOdometry(
            K, Rp, tp, H, W, overhead_shape=(16, 16)),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        make[entry]()
