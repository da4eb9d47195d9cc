"""The B-stream stereo-VO path of the port, as a whole, on the CPU at the
small size of the reference's own batched test (120x160, 256 tracks, pyramid
1/2/4, disparity 48, 192 hypotheses): against the port's single-stream run,
against the JAX package's batched bootstrap, and stream against stream."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.sfm import stereo_vo as jvo
from boofcv_tpu_torch.io import simulate as tsim
from boofcv_tpu_torch.sfm import stereo_vo as tvo

torch.set_num_threads(1)

H, W = 120, 160
K = np.array([[150.0, 0.0, W / 2], [0.0, 150.0, H / 2], [0.0, 0.0, 1.0]])
BASELINE = 0.3
N_FRAMES = 6
CFG_KW = dict(num_tracks=256, pyramid_scales=(1, 2, 4), max_disparity=48,
              ransac_hypotheses=192, detect_radius=4)
JCFG = jvo.StereoVoConfig(**CFG_KW)
TCFG = tvo.StereoVoConfig(**CFG_KW)
T = torch.from_numpy
TENSORS = ("xs", "ys", "world", "alive", "R", "t", "uid", "next_uid")


@pytest.fixture(scope="module")
def frames():
    """Forward creep with gentle yaw, integer-valued like a camera's:
    (lefts, rights), each [N_FRAMES, H, W] float32."""
    poses = []
    for i in range(N_FRAMES):
        a = 0.004 * i
        Rcw = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                        [-np.sin(a), 0.0, np.cos(a)]])
        c = np.array([0.015 * i, 0.0, 0.06 * i])
        poses.append((Rcw.T, -Rcw.T @ c))
    seq = tsim.render_stereo_sequence(np.random.default_rng(0), K, BASELINE,
                                      poses, H, W)
    return (np.stack([np.round(l) for l, _ in seq]).astype(np.float32),
            np.stack([np.round(r) for _, r in seq]).astype(np.float32))


def _single_run(lefts, rights, seed, n_steps):
    """The port's single-stream bootstrap and steps: the state after the
    bootstrap and after every step."""
    boot = tvo.make_bootstrap(TCFG, K, BASELINE)
    step = tvo.make_step(TCFG, K, BASELINE)
    s = boot(tvo.init_state(TCFG, H, W, seed=seed, device="cpu"),
             T(lefts[0]), T(rights[0]))
    states = [s]
    for i in range(1, n_steps + 1):
        s, _ = step(s, T(lefts[i]), T(rights[i]))
        states.append(s)
    return states


def _batched_run(lefts, rights, offsets, n_steps, seed=0):
    """Batched bootstrap and steps; stream b sees the sequence from frame
    ``offsets[b]`` on."""
    at = lambda a, i: T(np.stack([a[o + i] for o in offsets]))
    boot = tvo.make_batched_bootstrap(TCFG, K, BASELINE, device="cpu")
    step = tvo.make_batched_step(TCFG, K, BASELINE, device="cpu")
    s = boot(tvo.init_batched_state(TCFG, len(offsets), H, W, seed=seed,
                                    device="cpu"),
             at(lefts, 0), at(rights, 0))
    states, metrics = [s], []
    for i in range(1, n_steps + 1):
        s, m = step(s, at(lefts, i), at(rights, i))
        states.append(s)
        metrics.append(m)
    return states, metrics


@pytest.mark.parametrize("offsets", [(0, 0), (0, 1)],
                         ids=["same_frames", "other_frames"])
def test_batched_steps_match_single_stream(frames, offsets):
    """Batched bootstrap + 4 batched steps, B = 2, seeds 0 and 1.

    Each stream against the port's single-stream run on that stream's
    frames with that stream's seed: bootstrap state bit-equal (the spawn has
    no batched matrix product in float32), then per step the same tracks
    alive and the pose within 1e-6 (the float32 RANSAC bank and refine loop
    go through batched products that round otherwise than the single ones).
    With the same frames, stream 1 (another seed) stays within 0.05 of
    stream 0, as the reference's own batched test asks."""
    lefts, rights = frames
    states, metrics = _batched_run(lefts, rights, offsets, 4)
    assert states[-1].R.shape == (2, 3, 3) and states[-1].t.shape == (2, 3)
    for b, off in enumerate(offsets):
        single = _single_run(lefts[off:], rights[off:], b, 4)
        boot_b = tvo.stream_state(states[0], b)
        for k in TENSORS:
            assert torch.equal(getattr(boot_b, k), getattr(single[0], k)), k
        for a, c in zip(boot_b.templates.desc + boot_b.templates.grad_x,
                        single[0].templates.desc + single[0].templates.grad_x):
            assert torch.equal(a, c)
        assert int(boot_b.alive.sum()) > 60
        for i in range(1, 5):
            sb = tvo.stream_state(states[i], b)
            assert torch.equal(sb.alive, single[i].alive), (b, i)
            assert torch.equal(sb.uid, single[i].uid)
            np.testing.assert_allclose(sb.t.numpy(), single[i].t.numpy(),
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(sb.R.numpy(), single[i].R.numpy(),
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(sb.xs.numpy(), single[i].xs.numpy(),
                                       atol=1e-4, rtol=0)
        assert sb.rng.get_state().equal(single[-1].rng.get_state())
    for m in metrics:
        assert m["pose_ok"].shape == (2,) and bool(m["pose_ok"].all())
        assert m["inliers"].shape == (2,) and m["alive"].shape == (2,)
    if offsets == (0, 0):
        for s in states[1:]:
            assert float(torch.linalg.norm(s.t[1] - s.t[0])) < 0.05
            assert not torch.equal(s.t[1], s.t[0])      # another seed


def _jax_numpy_state(s):
    a = np.asarray
    return {"xs": a(s.xs), "ys": a(s.ys), "world": a(s.world),
            "alive": a(s.alive), "R": a(s.R), "t": a(s.t), "key": a(s.key),
            "uid": a(s.uid), "next_uid": a(s.next_uid),
            "templates": {k: [a(x) for x in getattr(s.templates, k)]
                          for k in ("desc", "grad_x", "grad_y")}}


def test_batched_bootstrap_matches_jax(frames):
    """Two streams on two different first pairs through the JAX package's
    ``make_batched_bootstrap`` and the port's: the reference's stacked state
    carried across by ``state_from_numpy`` ([B] on every leaf, ``key``
    [B, 2] -> one generator a stream, seeds 5 and 6) equals the port's:
    slots, positions and ids equal, world points to 1e-6 (float64 lift of
    float32 subpixel disparities), templates to 1e-3."""
    lefts, rights = frames
    l0, r0 = lefts[[0, 3]], rights[[0, 3]]
    jboot = jvo.make_batched_bootstrap(JCFG, K, BASELINE)
    js = jboot(jvo.init_batched_state(JCFG, 2, H, W, seed=5),
               jnp.asarray(l0), jnp.asarray(r0))
    ref = tvo.state_from_numpy(_jax_numpy_state(js), device="cpu")
    assert [g.initial_seed() for g in ref.rng] == [5, 6]
    assert ref.xs.shape == (2, 256) and ref.next_uid.shape == (2,)
    boot = tvo.make_batched_bootstrap(TCFG, K, BASELINE, device="cpu")
    out = boot(tvo.init_batched_state(TCFG, 2, H, W, seed=5, device="cpu"),
               T(l0), T(r0))
    assert int(out.alive[0].sum()) > 60 and int(out.alive[1].sum()) > 60
    assert not torch.equal(out.xs[0], out.xs[1])
    for k in ("alive", "xs", "ys", "uid", "next_uid", "R", "t"):
        assert torch.equal(getattr(out, k), getattr(ref, k)), k
    np.testing.assert_allclose(out.world.numpy(), ref.world.numpy(),
                               atol=1e-6, rtol=0)
    for k in ("desc", "grad_x", "grad_y"):
        for a, b in zip(getattr(out.templates, k), getattr(ref.templates, k)):
            assert a.shape == b.shape and a.shape[:2] == (2, 256)
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-3,
                                       rtol=0)
    # a stacked state survives the round trip, generators' positions too
    out.rng[1].set_state(torch.Generator().manual_seed(77).get_state())
    d = tvo.state_to_numpy(out)
    assert d["key"].shape == (2, 2) and d["rng_state"].shape[0] == 2
    back = tvo.state_to_numpy(tvo.state_from_numpy(d, device="cpu"))
    for k in TENSORS + ("key", "rng_state"):
        assert np.array_equal(back[k], d[k]), k


def test_spawn_in_one_stream_leaves_the_other_alone(frames):
    """Stream 1 loses most of its tracks and must spawn; stream 0 must not.
    The spawn runs for both (one decision a step) and each stream picks its
    own result: stream 0 ends on the same bits as in a step where no stream
    spawned, templates included, and stream 1 refills.  (The spawn
    threshold is lowered to 0.15: at this size a quarter of the slots
    survive a step, which the default 0.6 would refill every time.)"""
    lefts, rights = frames
    states, _ = _batched_run(lefts, rights, (0, 0), 1)
    s = states[-1]
    cfg = tvo.StereoVoConfig(respawn_below=0.15, **CFG_KW)
    step = tvo.make_batched_step(cfg, K, BASELINE, device="cpu")
    l2, r2 = T(np.stack([lefts[2]] * 2)), T(np.stack([rights[2]] * 2))
    calm, _ = step(s, l2, r2)
    assert torch.equal(calm.next_uid, s.next_uid)       # nobody spawned
    alive = s.alive.clone()
    alive[1, 40:] = False
    hit, m = step(s._replace(alive=alive), l2, r2)
    a0, b0 = tvo.stream_state(hit, 0), tvo.stream_state(calm, 0)
    for k in TENSORS:
        assert torch.equal(getattr(a0, k), getattr(b0, k)), k
    for k in ("desc", "grad_x", "grad_y"):
        for x, y in zip(getattr(a0.templates, k), getattr(b0.templates, k)):
            assert torch.equal(x, y)
    assert int(hit.next_uid[1]) > int(s.next_uid[1])
    assert int(hit.alive[1].sum()) > 60 > 40 >= int(alive[1].sum())
    assert int(m["alive"][1]) == int(hit.alive[1].sum())
    # the refilled slots hold new ids, positions and templates
    new = hit.uid[1] >= s.next_uid[1]
    assert int(new.sum()) == int(hit.next_uid[1] - s.next_uid[1])
    assert bool(hit.alive[1][new].all())
    assert not torch.equal(hit.templates.desc[0][1][new],
                           s.templates.desc[0][1][new])


@pytest.mark.parametrize("streams", [1, 3])
def test_batched_sequence_runner_shapes_and_shared_frames(frames, streams):
    """Poses [T, B, 3, 3] and [T, B, 3], every metric [T, B]; one [T, H, W]
    sequence with ``shared_frames=True`` gives the same bits as B copies of
    it stacked, and the runner is the batched step in a loop."""
    lefts, rights = frames
    B, Tn = streams, 3
    boot = tvo.make_batched_bootstrap(TCFG, K, BASELINE, device="cpu")
    s0 = boot(tvo.init_batched_state(TCFG, B, H, W, device="cpu"),
              T(lefts[0]).expand(B, H, W), T(rights[0]).expand(B, H, W))
    shared = tvo.make_batched_sequence_runner(TCFG, K, BASELINE,
                                              shared_frames=True,
                                              device="cpu")
    stacked = tvo.make_batched_sequence_runner(TCFG, K, BASELINE,
                                               device="cpu")
    ls, rs = T(lefts[1:1 + Tn]), T(rights[1:1 + Tn])
    s1, ((R1, t1), m1) = shared(s0, ls, rs)
    rep = lambda a: a[:, None].repeat(1, B, 1, 1)
    s2, ((R2, t2), m2) = stacked(s0, rep(ls), rep(rs))
    assert R1.shape == (Tn, B, 3, 3) and t1.shape == (Tn, B, 3)
    assert R1.dtype == torch.float64
    for k in ("tracked", "inliers", "alive", "pose_ok"):
        assert m1[k].shape == (Tn, B), k
        assert torch.equal(m1[k], m2[k]), k
    assert bool(m1["pose_ok"].all())
    assert torch.equal(R1, R2) and torch.equal(t1, t2)
    assert torch.equal(s1.xs, s2.xs) and torch.equal(s1.alive, s2.alive)
    step = tvo.make_batched_step(TCFG, K, BASELINE, device="cpu")
    s = s0
    for i in range(Tn):
        s, _ = step(s, rep(ls)[i], rep(rs)[i])
        assert torch.equal(s.t, t1[i])
    # the caller's state is a value: running it again replays the draws
    again = shared(s0, ls, rs)[1][0][1]
    assert torch.equal(again, t1)


@pytest.mark.parametrize("entry", ["init_batched_state",
                                   "make_batched_bootstrap",
                                   "make_batched_step",
                                   "make_batched_sequence_runner"])
def test_batched_entry_points_default_to_the_card(entry, monkeypatch):
    """With no ``device`` each batched entry point is for the card: without
    one it raises a RuntimeError that names CUDA when it is built, and runs
    nothing on the CPU; with ``device="cpu"`` it is built."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = tvo.StereoVoConfig(num_tracks=8, pyramid_scales=(1, 2))
    make = {
        "init_batched_state": lambda **kw: tvo.init_batched_state(
            small, 2, H, W, **kw),
        "make_batched_bootstrap": lambda **kw: tvo.make_batched_bootstrap(
            small, K, BASELINE, **kw),
        "make_batched_step": lambda **kw: tvo.make_batched_step(
            small, K, BASELINE, **kw),
        "make_batched_sequence_runner": lambda **kw:
            tvo.make_batched_sequence_runner(small, K, BASELINE,
                                             shared_frames=True, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    made = make(device="cpu")
    if entry == "init_batched_state":
        assert made.xs.shape == (2, 8) and made.xs.device.type == "cpu"
        assert made.next_uid.shape == (2,) and len(made.rng) == 2
        assert [g.initial_seed() for g in made.rng] == [0, 1]
        return
    # a single-stream state is refused, not broadcast
    one = tvo.init_state(small, H, W, device="cpu")
    img = torch.zeros((H, W))
    with pytest.raises(ValueError, match=r"\[B, N\]"):
        made(one, img, img)


def test_port_and_chip_smoke_name_no_jax_module():
    """Every import statement of the port and of ``chip_smoke.py``, read
    from the source: none names ``jax`` or the JAX package (the card's host
    has neither)."""
    import ast
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "boofcv_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "boofcv_tpu"), (path, name)
