"""The port's sliding-window BA (``boofcv_tpu_torch/sfm/window_ba.py``), its
BAL and checkpoint codecs and the bundle-adjustment example against the JAX
package on the CPU.

The window gets the same seven VO states in both packages: the port's VO
runs on the CPU (120x160, 256 tracks, the reference test's configuration)
and each state is carried over with ``state_to_numpy``.  Tolerances are
stated in each test.
"""

import gzip
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boofcv_tpu.geo import ba as jba
from boofcv_tpu.io import bal as jbal
from boofcv_tpu.io import checkpoint as jckpt
from boofcv_tpu.sfm import window_ba as jwba
from boofcv_tpu_torch.examples import bundle_adjustment as tex
from boofcv_tpu_torch.io import bal as tbal
from boofcv_tpu_torch.io import checkpoint as tckpt
from boofcv_tpu_torch.io import simulate as tsim
from boofcv_tpu_torch.sfm import stereo_vo as tvo
from boofcv_tpu_torch.sfm import window_ba as twba
from test_torch_ba import both, scene

torch.set_num_threads(1)

H, W = 120, 160
FX = 150.0
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
N = 7


def _rot_y(a):
    return np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                     [-np.sin(a), 0.0, np.cos(a)]])


@pytest.fixture(scope="module")
def vo_run():
    """(ground-truth poses, the seven VO states as numpy dicts, the VO's
    last camera centre): the reference test's sequence through the port's
    VO on the CPU."""
    poses = []
    for i in range(N):
        R = _rot_y(0.004 * i)           # exp_so3([0, 0.004 i, 0])
        c = np.array([0.015 * i, 0.0, 0.06 * i])
        poses.append((R, -R @ c))
    frames = tsim.render_stereo_sequence(np.random.default_rng(0), K, 0.3,
                                         poses, H, W)
    cfg = tvo.StereoVoConfig(num_tracks=256, pyramid_scales=(1, 2, 4),
                             max_disparity=48, ransac_hypotheses=192,
                             detect_radius=4)
    vo = tvo.StereoVisualOdometry(cfg, K, 0.3, H, W, device="cpu")
    states = []
    for left, right in frames:
        assert vo.process(left, right)
        states.append(tvo.state_to_numpy(vo.state))
    return poses, states, vo.camera_to_world()[1]


def _push_all(wba, states, make_state):
    for d in states:
        wba.push(make_state(d), FX, FX, W / 2, H / 2)


def _jax_state(d):
    """What the reference's ``push`` reads: seven array fields."""
    return types.SimpleNamespace(**{k: jnp.asarray(d[k]) for k in
                                    ("alive", "uid", "xs", "ys", "world",
                                     "R", "t")})


def _port_state(d):
    return tvo.state_from_numpy(d, device="cpu")


def test_read_state_is_the_state(vo_run):
    """``push`` brings the seven fields over in one packed transfer: they
    come back exactly (float32 positions, int32 ids and the mask are exact
    in float64)."""
    d = vo_run[1][-1]
    alive, uid, xs, ys, world, R, t = twba._read_state(_port_state(d))
    for got, key in ((alive, "alive"), (uid, "uid"), (xs, "xs"), (ys, "ys"),
                     (world, "world"), (R, "R"), (t, "t")):
        assert got.dtype == d[key].dtype, key
        np.testing.assert_array_equal(got, d[key])


def test_window_assembly_equals_jax(vo_run, monkeypatch):
    """The same seven states pushed into both packages: the assembled
    ``obs_xy``, ``obs_view``, ``obs_valid``, the points in their order, the
    fixed views and the observations kept after the 6 x median trim are
    equal exactly; the refined poses agree within 1e-4; of the refined
    points more than 98 % agree within 1e-3 and all within 5e-2 (float32
    solves on two back ends: a point seen twice at a small angle has a depth
    that the data barely holds); the final costs agree within 1 %; the
    reference test's own assertions hold for the port."""
    poses, states, c_vo = vo_run
    seen = {}
    real_make, real_opt = jba.make_problem, jba.optimize

    def make(*a, **k):
        seen["args"], seen["fixed"] = a, k["fixed_views"]
        assert k["dtype"] == jnp.float32
        return real_make(*a, **k)

    def opt(prob, **k):
        seen["keep"], seen["iterations"] = np.asarray(prob.obs_valid), k
        return real_opt(prob, **k)

    monkeypatch.setattr(jwba.ba, "make_problem", make)
    monkeypatch.setattr(jwba.ba, "optimize", opt)
    jw = jwba.SlidingWindowBA(window=N)
    tw = twba.SlidingWindowBA(window=N, device="cpu")
    _push_all(jw, states, _jax_state)
    _push_all(tw, states, _port_state)
    assert list(jw.world) == list(tw.world)

    track_ids, Rs, ts, pts, obs_xy, obs_view, obs_valid, fixed = tw.assemble()
    jref, jinfo = jw.optimize()
    jRs, jts, jpts, jxy, jview, jvalid = seen["args"]
    for got, want in ((Rs, jRs), (ts, jts), (pts, jpts), (obs_xy, jxy),
                      (obs_view, jview), (obs_valid, jvalid),
                      (fixed, seen["fixed"])):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert len(track_ids) >= 12 and obs_xy.shape == (len(track_ids), N, 2)
    assert fixed.tolist() == [True, True] + [False] * (N - 2)

    tref, tinfo = tw.optimize()
    np.testing.assert_array_equal(tinfo["keep"], seen["keep"])
    assert seen["iterations"] == {"iterations": tw.iterations}
    assert tinfo["tracks"] == len(track_ids)
    assert tinfo["observations"] == seen["keep"].sum()
    assert (seen["keep"].sum(axis=1) != 1).all()      # 0, or at least 2
    assert len(tref) == N
    for (tR, tt), (jR, jt) in zip(tref, jref):
        assert tR.dtype == np.float32 and tR.shape == (3, 3)
        np.testing.assert_allclose(tR, jR, atol=1e-4)
        np.testing.assert_allclose(tt, jt, atol=1e-4)
    assert list(jw.world) == list(tw.world)
    diff = np.abs(np.stack(list(tw.world.values()))
                  - np.stack(list(jw.world.values()))).max(axis=1)
    assert (diff < 1e-3).mean() > 0.98 and diff.max() < 5e-2, (
        (diff < 1e-3).mean(), diff.max())
    np.testing.assert_allclose(float(tinfo["final_cost"]),
                               float(jinfo["final_cost"]), rtol=1e-2)

    # the reference test's assertions (tests/test_window_ba.py), on the port
    assert float(tinfo["final_cost"]) <= float(tinfo["initial_cost"])
    Rr, tr = tref[-1]
    c_gt = -poses[-1][0].T @ poses[-1][1]
    err_ba = np.linalg.norm(-Rr.T @ tr - c_gt)
    err_vo = np.linalg.norm(c_vo - c_gt)
    assert err_ba < 0.02, (err_ba, err_vo)
    assert err_ba < err_vo, (err_ba, err_vo)
    # the refined poses are written back into the window
    np.testing.assert_array_equal(tw.frames[-1]["R"], Rr)


def test_window_ring_buffer_and_underconstrained(vo_run):
    """Fewer than three frames, or fewer than twelve shared tracks, give
    None; the buffer keeps the newest ``window`` frames; a long
    ``min_track_len`` drops the short tracks, as in the reference."""
    _, states, _ = vo_run
    tw = twba.SlidingWindowBA(window=4, device="cpu")
    jw = jwba.SlidingWindowBA(window=4)
    for i, d in enumerate(states):
        tw.push(_port_state(d), FX, FX, W / 2, H / 2)
        jw.push(_jax_state(d), FX, FX, W / 2, H / 2)
        assert len(tw.frames) == min(i + 1, 4) == len(jw.frames)
        if i < 2:
            assert tw.optimize() is None and jw.optimize() is None
    np.testing.assert_array_equal(tw.frames[0]["uids"], jw.frames[0]["uids"])
    np.testing.assert_array_equal(tw.frames[0]["obs"], jw.frames[0]["obs"])
    assert tw.frames[0]["obs"].dtype == jw.frames[0]["obs"].dtype
    assert tw.assemble()[4].shape[1] == 4
    few = {**states[0], "alive": states[0]["alive"]
           & (np.cumsum(states[0]["alive"]) <= 11)}
    tw = twba.SlidingWindowBA(window=4, device="cpu")
    for _ in range(3):
        tw.push(_port_state(few), FX, FX, W / 2, H / 2)
    assert tw.optimize() is None
    long = twba.SlidingWindowBA(window=N, min_track_len=N, device="cpu")
    short = twba.SlidingWindowBA(window=N, device="cpu")
    _push_all(long, states, _port_state)
    _push_all(short, states, _port_state)
    assert 12 <= len(long.assemble()[0]) < len(short.assemble()[0])
    assert long.assemble()[6].all()          # every slot of every track


def _snavely_problems():
    return both(scene(11, "snavely", V=5, P=30, L=4))


def test_bal_round_trip_equals_jax_codec(tmp_path, capsys):
    """Write, read and ``to_problem`` through both codecs.  Both writers
    give files that parse to the same observations and points exactly and
    the same cameras within 1e-14 (the rotation vector comes from each
    package's own ``log_so3``); one file read by both readers gives equal
    arrays; ``to_problem`` agrees exactly but for R (each package's
    ``exp_so3``: 1e-14)."""
    jp, tp = _snavely_problems()
    pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jbal.write_bal(pj, jp)
    tbal.write_bal(pt, tp)
    dj, dt = tbal.read_bal(pj), tbal.read_bal(pt)
    for k in ("camera_index", "point_index", "obs", "points"):
        np.testing.assert_array_equal(dj[k], dt[k])
    np.testing.assert_allclose(dt["cameras"], dj["cameras"], atol=1e-14)
    ref = jbal.read_bal(pt)
    assert set(ref) == set(dt)
    for k, v in ref.items():
        assert dt[k].dtype == v.dtype and dt[k].shape == v.shape, k
        np.testing.assert_array_equal(dt[k], v)
    jq, tq = jbal.to_problem(ref), tbal.to_problem(dt, device="cpu")
    assert tq.model == jq.model == "snavely"
    for k in jba.BAProblem._fields[:-1]:
        got, want = getattr(tq, k).numpy(), np.asarray(getattr(jq, k))
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k == "R":
            np.testing.assert_allclose(got, want, atol=1e-14)
        else:
            np.testing.assert_array_equal(got, want)
    # and back to where it started
    np.testing.assert_allclose(tq.R.numpy(), tp.R.numpy(), atol=1e-12)
    np.testing.assert_array_equal(tq.points.numpy(), tp.points.numpy())
    np.testing.assert_array_equal(tq.obs_valid.numpy(), tp.obs_valid.numpy())
    np.testing.assert_array_equal(tq.obs_xy.numpy(), tp.obs_xy.numpy())
    # a slot limit drops the later observations and says how many
    capsys.readouterr()
    cut = tbal.to_problem(dt, max_obs_per_point=3, device="cpu")
    err_t = capsys.readouterr().err
    jcut = jbal.to_problem(ref, max_obs_per_point=3)
    assert capsys.readouterr().err == err_t and "dropped" in err_t
    np.testing.assert_array_equal(cut.obs_valid.numpy(),
                                  np.asarray(jcut.obs_valid))
    np.testing.assert_array_equal(cut.obs_xy.numpy(), np.asarray(jcut.obs_xy))
    # gzip, and a file shorter than its header says
    with open(pt) as f:
        text = f.read()
    gz = str(tmp_path / "t.txt.gz")
    with gzip.open(gz, "wt") as f:
        f.write(text)
    np.testing.assert_array_equal(tbal.read_bal(gz)["cameras"], dt["cameras"])
    short = str(tmp_path / "short.txt")
    with open(short, "w") as f:
        f.write(" ".join(text.split()[:-2]))
    with pytest.raises(ValueError, match="tokens"):
        tbal.read_bal(short)


def test_checkpoint_round_trip_equals_jax_codec(tmp_path):
    """A problem saved by either package loads in the other, array for
    array; named arrays and trajectories likewise."""
    jp, tp = _snavely_problems()
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_ba_problem(pj, jp)
    tckpt.save_ba_problem(pt, tp)
    zj, zt = tckpt.load_arrays(pj), jckpt.load_arrays(pt)
    assert set(zj) == set(zt)
    for k in zj:
        assert zj[k].dtype == zt[k].dtype, k
        np.testing.assert_array_equal(zj[k], zt[k])
    for path in (pj, pt):
        got, want = tckpt.load_ba_problem(path, device="cpu"), \
            jckpt.load_ba_problem(path)
        assert got.model == want.model == "snavely"
        for k in jba.BAProblem._fields[:-1]:
            a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, getattr(tp, k).numpy())
    rng = np.random.default_rng(0)
    arrays = {"a": rng.normal(size=(3, 4)), "b": np.arange(5, dtype=np.int32)}
    tckpt.save_arrays(str(tmp_path / "ta.npz"), a=torch.from_numpy(arrays["a"]),
                      b=arrays["b"])
    jckpt.save_arrays(str(tmp_path / "ja.npz"), **arrays)
    for name in ("ta.npz", "ja.npz"):
        back = tckpt.load_arrays(str(tmp_path / name))
        assert set(back) == {"a", "b"}
        for k, v in arrays.items():
            assert back[k].dtype == v.dtype
            np.testing.assert_array_equal(back[k], v)
    traj = [(np.eye(3) * (i + 1), np.full(3, float(i))) for i in range(4)]
    tckpt.save_trajectory(str(tmp_path / "tt.npz"),
                          [(torch.from_numpy(R), t) for R, t in traj])
    jckpt.save_trajectory(str(tmp_path / "jt.npz"), traj, frame_ids=[3, 5, 7, 9])
    got, ids = jckpt.load_trajectory(str(tmp_path / "tt.npz"))
    np.testing.assert_array_equal(ids, np.arange(4))
    for (R, t), (R0, t0) in zip(got, traj):
        np.testing.assert_array_equal(R, R0)
        np.testing.assert_array_equal(t, t0)
    got, ids = tckpt.load_trajectory(str(tmp_path / "jt.npz"))
    np.testing.assert_array_equal(ids, [3, 5, 7, 9])
    assert len(got) == 4 and (got[2][0] == traj[2][0]).all()


def test_example_bundle_adjustment_runs_on_the_cpu(capsys):
    """The self-checking demo: exit code 0, last line OK, and the same
    costs as the JAX demo prints (same seed, same file round trip) within
    1e-6 relative."""
    from boofcv_tpu.examples import bundle_adjustment as jex
    assert tex.main(["--device", "cpu"]) == 0
    out_t = capsys.readouterr().out.strip().splitlines()
    assert out_t[-1] == "OK" and out_t[0] == "device: cpu"
    assert jex.main(["--cpu"]) == 0
    out_j = capsys.readouterr().out.strip().splitlines()
    assert out_j[-1] == "OK"
    cost = lambda lines: [float(x) for x in next(
        l for l in lines if l.startswith("cost:")).split("(")[0]
        .replace("cost:", "").split("->")]
    np.testing.assert_allclose(cost(out_t), cost(out_j), rtol=1e-6)


def test_entry_points_raise_without_a_card(tmp_path, monkeypatch):
    """``device=None`` means the card: without one ``to_problem``,
    ``load_ba_problem``, ``SlidingWindowBA`` and the example raise, and
    nothing runs on the CPU unasked."""
    _, tp = _snavely_problems()
    bal_path, npz = str(tmp_path / "p.txt"), str(tmp_path / "p.npz")
    tbal.write_bal(bal_path, tp)
    tckpt.save_ba_problem(npz, tp)
    data = tbal.read_bal(bal_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tbal.to_problem(data),
                 lambda: tckpt.load_ba_problem(npz),
                 lambda: twba.SlidingWindowBA(window=4),
                 lambda: tex.main([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert tckpt.load_ba_problem(npz, device="cpu").R.device.type == "cpu"
    assert twba.SlidingWindowBA(device="cpu").device.type == "cpu"
