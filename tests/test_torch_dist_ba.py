"""The port's ``dist/`` on four CPU ranks: point-sharded BA
(``boofcv_tpu_torch/dist/ba_sharded.py``) against the JAX package's
``shard_map`` solver on a 4-device mesh of the 8-device CPU platform, so the
shards split alike.

One gloo group of four spawned processes serves the whole file: a module
fixture starts it, each rank runs every case and writes its numpy results,
and the parent computes the JAX references meanwhile.  The rendezvous is a
file in the test's own temporary directory (no port, so parallel test
workers cannot collide); each rank runs one thread.  This module imports no
JAX at its top, so the ranks load torch only; ``run_ranks`` is shared with
``test_torch_dist_ransac.py`` and ``test_torch_dist_matching.py``.

Tolerances are the reference's own sharded-vs-single ones: float64 costs
within 1e-6 relative, R within 1e-8, points within 1e-7; the 2-D mesh
within 1e-8 relative of the 1-D; PCG within 1e-4 relative.
"""

import datetime
import importlib
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from boofcv_tpu_torch.dist import ba_sharded
from boofcv_tpu_torch.dist import mesh as tmesh
from boofcv_tpu_torch.geo import ba as tba

WORLD = 4


def _rank_main(rank, world, store, out_dir, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        results = {}
        for name, (module, fn, kwargs) in cases.items():
            results[name] = getattr(importlib.import_module(module),
                                    fn)(**kwargs)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def run_ranks(cases, tmp_dir, world=WORLD, timeout=240):
    """Start ``world`` spawned gloo ranks that each run every case
    ``{name: (module, function, kwargs)}``; returns a function that waits
    for them and returns each rank's ``{name: result}``."""
    store = os.path.join(tmp_dir, "store")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(world, store, str(tmp_dir), cases), nprocs=world,
        join=False, start_method="spawn")

    def wait():
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the {world} ranks did not finish in "
                            f"{timeout} s")
        out = []
        for r in range(world):
            with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    return wait


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


def assert_ranks_agree(ranks, name):
    """Every rank returns the whole answer, and the same bits."""
    for other in ranks[1:]:
        for key, value in ranks[0][name].items():
            assert _same(value, other[name][key]), (name, key)


@pytest.fixture
def one_rank_group():
    """A one-process caller: ``make_mesh`` starts a one-rank group, torn
    down after the test."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _rotation(rng, sigma):
    w = rng.normal(0, sigma, 3)
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * (k @ k)


def build_scene(rng, n_views, n_points, max_obs=None, noise=0.0):
    """``tests/test_ba.py``'s ``build_scene`` for the normalized model, in
    numpy (the same draws in the same order)."""
    max_obs = max_obs or n_views
    pts = np.stack([rng.uniform(-2, 2, n_points),
                    rng.uniform(-2, 2, n_points),
                    rng.uniform(4, 8, n_points)], axis=1)
    Rs = np.stack([_rotation(rng, 0.03) for _ in range(n_views)])
    ts = np.stack([np.array([0.4 * v - 1.0, 0.05 * v, 0.02 * v])
                   for v in range(n_views)])
    obs_xy = np.zeros((n_points, max_obs, 2))
    obs_view = np.zeros((n_points, max_obs), np.int32)
    obs_valid = np.zeros((n_points, max_obs), bool)
    for p in range(n_points):
        views = rng.permutation(n_views)[: rng.integers(3, max_obs + 1)]
        for s, v in enumerate(sorted(views)):
            Xc = Rs[v] @ pts[p] + ts[v]
            obs_xy[p, s] = Xc[:2] / Xc[2] + rng.normal(0, noise, 2)
            obs_view[p, s] = v
            obs_valid[p, s] = True
    return pts, Rs, ts, obs_xy, obs_view, obs_valid


def _problem(seed, n_views, n_points, max_obs=None, noise=1e-4,
             rot=0.0, trans=0.0, point_noise=0.03):
    """A scene of the reference's ``tests/test_dist_ba.py`` as a numpy
    problem: views 2 on perturbed (rotation ``rot``, translation
    ``trans``), points moved by ``point_noise``, views 0 and 1 fixed."""
    rng = np.random.default_rng(seed)
    pts, Rs, ts, oxy, ov, oval = build_scene(rng, n_views, n_points,
                                             max_obs, noise)
    Rp, tp = Rs.copy(), ts.copy()
    for v in range(2, n_views):
        if rot:
            Rp[v] = _rotation(rng, rot) @ Rs[v]
        if trans:
            tp[v] = ts[v] + rng.normal(0, trans, 3)
    fixed = np.zeros(n_views, bool)
    fixed[:2] = True
    prob = tba.make_problem(Rp, tp, pts + rng.normal(0, point_noise,
                                                     pts.shape),
                            oxy, ov, oval, fixed_views=fixed, device="cpu")
    return tba.problem_to_numpy(prob), pts


def solve_case(prob, iterations, mesh="1d", **kw):
    """One rank's ``optimize_sharded`` of a numpy problem, as numpy."""
    m = (tmesh.make_mesh(device="cpu") if mesh == "1d"
         else tmesh.make_mesh_2d(2, 2, device="cpu"))
    out, info = ba_sharded.optimize_sharded(
        tba.problem_from_numpy(prob, device="cpu"), m,
        iterations=iterations, **kw)
    res = {k: getattr(out, k).numpy() for k in ("R", "t", "points")}
    res.update({k: info[k].numpy() for k in ("costs", "initial_cost",
                                              "final_cost")})
    return res


SCENES = {
    # test_sharded_ba_matches_single_device
    "cholesky": (dict(seed=7, n_views=5, n_points=40, rot=0.01,
                      trans=0.02, point_noise=0.05), 8, {}),
    # test_sharded_ba_with_padding: 37 points on 4 ranks pads 3
    "padded": (dict(seed=8, n_views=4, n_points=37, noise=0.0), 8, {}),
    # test_sharded_ba_2d_host_mesh_parity
    "mesh_1d": (dict(seed=12, n_views=6, n_points=64), 5, {}),
    "mesh_2d": (dict(seed=12, n_views=6, n_points=64), 5,
                {"mesh": "2d"}),
    # test_sharded_ba_pcg_matches_cholesky: 66 views pad to 68
    "pcg_cholesky": (dict(seed=13, n_views=66, n_points=256, max_obs=6,
                          trans=0.01, point_noise=0.02), 5, {}),
    "pcg": (dict(seed=13, n_views=66, n_points=256, max_obs=6, trans=0.01,
                 point_noise=0.02), 5,
            {"reduced_solver": "pcg", "pcg_iterations": 200}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the JAX references, the scenes' true
    points)."""
    problems = {name: _problem(**scene) for name, (scene, _, _)
                in SCENES.items()}
    wait = run_ranks({name: (__name__, "solve_case",
                             dict(prob=problems[name][0], iterations=it,
                                  **kw))
                      for name, (_, it, kw) in SCENES.items()},
                     tmp_path_factory.mktemp("dist_ba"))
    import jax.numpy as jnp
    from boofcv_tpu.dist import ba_sharded as jbs
    from boofcv_tpu.dist import make_mesh as jmake_mesh
    from boofcv_tpu.geo import ba as jba
    jmesh = jmake_mesh(WORLD)
    refs = {}
    for name in ("cholesky", "padded", "pcg"):
        prob, _ = problems[name]
        _, it, kw = SCENES[name]
        jprob = jba.BAProblem(*(jnp.asarray(prob[k]) for k in
                                jba.BAProblem._fields[:-1]), prob["model"])
        out, info = jbs.optimize_sharded(jprob, jmesh, iterations=it, **kw)
        refs[name] = {"R": np.asarray(out.R), "t": np.asarray(out.t),
                      "points": np.asarray(out.points),
                      "costs": np.asarray(info["costs"]),
                      "final_cost": np.asarray(info["final_cost"])}
    return wait(), refs, {k: v[1] for k, v in problems.items()}


@pytest.mark.parametrize("name", list(SCENES))
def test_every_rank_returns_the_same_answer(runs, name):
    assert_ranks_agree(runs[0], name)


@pytest.mark.parametrize("name", ["cholesky", "padded"])
def test_sharded_ba_matches_jax_shard_map(runs, name):
    got, want = runs[0][0][name], runs[1][name]
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=1e-6,
                               atol=1e-18)
    np.testing.assert_allclose(got["final_cost"], want["final_cost"],
                               rtol=1e-6, atol=1e-18)
    np.testing.assert_allclose(got["R"], want["R"], atol=1e-8)
    assert got["points"].shape == want["points"].shape
    np.testing.assert_allclose(got["points"], want["points"], atol=1e-7)


def test_sharded_ba_with_padding_converges(runs):
    got, pts = runs[0][0]["padded"], runs[2]["padded"]
    assert got["points"].shape == (40, 3)
    assert float(got["final_cost"]) < 1e-12
    np.testing.assert_allclose(got["points"][:37], pts, atol=1e-5)


def test_2d_host_mesh_matches_1d(runs):
    a, b = runs[0][0]["mesh_1d"], runs[0][0]["mesh_2d"]
    c1, c2 = float(a["final_cost"]), float(b["final_cost"])
    assert abs(c1 - c2) <= 1e-8 * (1.0 + abs(c1))
    np.testing.assert_allclose(b["R"], a["R"], atol=1e-8)


def test_pcg_matches_jax_pcg_and_cholesky(runs):
    got, chol = runs[0][0]["pcg"], runs[0][0]["pcg_cholesky"]
    want = runs[1]["pcg"]
    assert got["R"].shape[0] == 66
    for other in (float(want["final_cost"]), float(chol["final_cost"])):
        c = float(got["final_cost"])
        assert abs(c - other) <= 1e-4 * (1.0 + abs(other)), (c, other)
    np.testing.assert_allclose(got["t"], chol["t"], atol=1e-4)
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("solver", ["cholesky", "pcg"])
def test_one_process_path_matches_ba_optimize(one_rank_group, dtype,
                                              solver):
    """A caller with no group gets a one-rank mesh; there "cholesky" is
    ``ba.optimize`` bit for bit and "pcg" reaches its cost."""
    prob = tba.problem_from_numpy(_problem(**SCENES["mesh_1d"][0])[0],
                                  device="cpu")
    prob = prob._replace(**{k: getattr(prob, k).to(dtype)
                            for k in tba._FLOAT_FIELDS})
    mesh = tmesh.make_mesh(device="cpu")
    assert tmesh.device_count() == 1 and tmesh.shard_index(mesh) == (0, 1)
    ref, info_ref = tba.optimize(prob, iterations=5)
    out, info = ba_sharded.optimize_sharded(prob, mesh, iterations=5,
                                            reduced_solver=solver)
    if solver == "cholesky":
        for k in ("R", "t", "points"):
            assert torch.equal(getattr(out, k), getattr(ref, k)), k
        for k in ("costs", "initial_cost", "final_cost"):
            assert torch.equal(info[k], info_ref[k]), k
    else:
        c, want = float(info["final_cost"]), float(info_ref["final_cost"])
        assert abs(c - want) <= 1e-4 * (1.0 + want)


def test_bad_arguments_raise(one_rank_group):
    prob = tba.problem_from_numpy(_problem(**SCENES["mesh_1d"][0])[0],
                                  device="cpu")
    mesh = tmesh.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="reduced_solver"):
        ba_sharded.optimize_sharded(prob, mesh, reduced_solver="chol")
    with pytest.raises(ValueError, match="not 4"):
        tmesh.make_mesh(4, device="cpu")


def test_cuda_mesh_never_falls_back_to_gloo(one_rank_group, monkeypatch):
    """Without NCCL a CUDA mesh raises: no gloo group, no CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="NCCL"):
        tmesh.make_mesh()
    assert not dist.is_initialized()


def test_a_running_gloo_group_refuses_a_cuda_mesh(one_rank_group,
                                                  monkeypatch):
    tmesh.make_mesh(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="needs nccl"):
        tmesh.make_mesh(device="cuda")


def test_pad_points_and_hvv_diag_chunked_match_jax():
    import jax.numpy as jnp
    from boofcv_tpu.dist import ba_sharded as jbs
    from boofcv_tpu.geo import ba as jba
    prob_np, _ = _problem(**SCENES["padded"][0])
    jprob = jba.BAProblem(*(jnp.asarray(prob_np[k]) for k in
                            jba.BAProblem._fields[:-1]), prob_np["model"])
    prob = tba.problem_from_numpy(prob_np, device="cpu")
    for n in (1, 4, 8):
        got = ba_sharded.pad_points_for_mesh(prob, n)
        want = jbs.pad_points_for_mesh(jprob, n)
        for k in ("points", "obs_xy", "obs_view", "obs_valid"):
            assert np.array_equal(getattr(got, k).numpy(),
                                  np.asarray(getattr(want, k))), (n, k)
    Jv = tba._jacobians(prob)[0]
    for chunk in (8, 16, 8192):
        got = tba.hvv_diag_chunked(prob.obs_view, Jv, 4, chunk=chunk)
        want = jba.hvv_diag_chunked(jnp.asarray(prob_np["obs_view"]),
                                    jnp.asarray(Jv.numpy()), 4, chunk=chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12)


def test_jacobi_eigh_matches_eigh():
    g = torch.Generator().manual_seed(0)
    for n in (6, 7, 9):
        A = torch.randn((40, n, n), generator=g, dtype=torch.float64)
        A = A @ A.mT
        w, Q = ba_sharded._eigh_jacobi(A)
        np.testing.assert_allclose(torch.sort(w).values.numpy(),
                                   torch.linalg.eigh(A)[0].numpy(),
                                   atol=1e-10)
        np.testing.assert_allclose((Q @ torch.diag_embed(w) @ Q.mT).numpy(),
                                   A.numpy(), atol=1e-10)
        np.testing.assert_allclose((Q.mT @ Q).numpy(),
                                   np.broadcast_to(np.eye(n), A.shape),
                                   atol=1e-12)
