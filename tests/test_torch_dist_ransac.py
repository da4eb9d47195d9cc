"""The port's hypothesis-bank-sharded P3P RANSAC
(``boofcv_tpu_torch/dist/ransac_sharded.py``) on four gloo ranks against the
JAX package's ``shard_map`` version on a 4-device CPU mesh.

``jax.random`` cannot be reproduced, so the parity case feeds each rank the
bank the reference's device draws (``idx``: ``jax.random.split`` of the key
a device, then ``robust.sample_indices``, as ``robust.ransac`` draws); the
same winner must come out, and R, t within 1e-6.  One gloo group serves the
file (``test_torch_dist_ba.run_ranks``); JAX is imported in the parent
only.
"""

import numpy as np
import pytest
import torch

from boofcv_tpu_torch.dist import mesh as tmesh
from boofcv_tpu_torch.dist.ransac_sharded import ransac_pnp_sharded

from test_torch_dist_ba import WORLD, assert_ranks_agree, run_ranks

N, N_OUT, HYP, THR = 96, 20, 32, 1e-5


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * (k @ k)


def scene():
    """``tests/test_dist_ransac.py``'s: 96 points, the first 20 moved
    0.05-0.2 in normalized coordinates."""
    rng = np.random.default_rng(0)
    world = np.concatenate([rng.uniform(-2, 2, (N, 2)),
                            rng.uniform(4, 8, (N, 1))], 1)
    R = _rodrigues(np.array([0.1, -0.2, 0.05]))
    t = np.array([0.3, -0.1, 0.5])
    Xc = world @ R.T + t
    obs = Xc[:, :2] / Xc[:, 2:]
    obs[:N_OUT] += rng.uniform(0.05, 0.2, (N_OUT, 2))
    return world, obs, R, t


def ransac_case(world, obs, idx=None, seed=1):
    """One rank's ``ransac_pnp_sharded``, as numpy."""
    mesh = tmesh.make_mesh(device="cpu")
    res, (R, t) = ransac_pnp_sharded(
        mesh, torch.Generator().manual_seed(seed), torch.from_numpy(world),
        torch.from_numpy(obs), num_hypotheses_per_device=HYP,
        inlier_threshold=THR, idx=idx)
    return {"R": R.numpy(), "t": t.numpy(), "R_hyp": res.model[0].numpy(),
            "num_inliers": res.num_inliers.numpy(),
            "best_error": res.best_error.numpy(),
            "inliers": res.inliers.numpy()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the JAX reference, the scene)."""
    world, obs, R, t = scene()
    import jax
    import jax.numpy as jnp
    from boofcv_tpu.dist import make_mesh as jmake_mesh
    from boofcv_tpu.dist.ransac_sharded import ransac_pnp_sharded as jrps
    from boofcv_tpu.geo import robust as jrobust
    key = jax.random.PRNGKey(1)
    idx = np.stack([np.asarray(jrobust.sample_indices(k, HYP, 3, N))
                    for k in jax.random.split(key, WORLD)])
    wait = run_ranks({
        "parity": (__name__, "ransac_case", dict(world=world, obs=obs,
                                                 idx=idx)),
        "drawn": (__name__, "ransac_case", dict(world=world, obs=obs))},
        tmp_path_factory.mktemp("dist_ransac"))
    res, (Rj, tj) = jrps(jmake_mesh(WORLD), key, jnp.asarray(world),
                         jnp.asarray(obs), num_hypotheses_per_device=HYP,
                         inlier_threshold=THR)
    ref = {"R": np.asarray(Rj), "t": np.asarray(tj),
           "R_hyp": np.asarray(res.model[0]),
           "num_inliers": np.asarray(res.num_inliers),
           "inliers": np.asarray(res.inliers)}
    return wait(), ref, (R, t)


@pytest.mark.parametrize("name", ["parity", "drawn"])
def test_every_rank_returns_the_same_answer(runs, name):
    assert_ranks_agree(runs[0], name)


def test_same_winner_as_jax_with_its_banks(runs):
    got, want = runs[0][0]["parity"], runs[1]
    assert int(got["num_inliers"]) == int(want["num_inliers"])
    assert np.array_equal(got["inliers"], want["inliers"])
    np.testing.assert_allclose(got["R_hyp"], want["R_hyp"], atol=1e-5)
    np.testing.assert_allclose(got["R"], want["R"], atol=1e-6)
    np.testing.assert_allclose(got["t"], want["t"], atol=1e-6)


@pytest.mark.parametrize("name", ["parity", "drawn"])
def test_sharded_ransac_pnp_recovers_pose_with_outliers(runs, name):
    """The reference test's bars, with its banks and with the port's own
    draws."""
    got, (R, t) = runs[0][0][name], runs[2]
    assert int(got["num_inliers"]) >= 70
    assert np.abs(got["R"] - R).max() < 1e-5
    assert np.abs(got["t"] - t).max() < 1e-5
    assert got["inliers"][N_OUT:].mean() > 0.95
    assert got["inliers"][:N_OUT].mean() < 0.2


def test_one_rank_mesh_is_ransac_pnp(monkeypatch):
    """On one rank the sharded call is ``robust.ransac_pnp`` with the same
    bank, and its generator advances as ``ransac_pnp``'s does."""
    import torch.distributed as dist
    from boofcv_tpu_torch.geo import robust
    world, obs, _, _ = scene()
    w, o = torch.from_numpy(world), torch.from_numpy(obs)
    try:
        mesh = tmesh.make_mesh(device="cpu")
        g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
        res, (R, t) = ransac_pnp_sharded(mesh, g1, w, o,
                                         num_hypotheses_per_device=HYP,
                                         inlier_threshold=THR)
        ref, (Rr, tr) = robust.ransac_pnp(g2, w, o, num_hypotheses=HYP,
                                          inlier_threshold=THR)
    finally:
        dist.destroy_process_group()
    assert torch.equal(res.inliers, ref.inliers)
    assert torch.equal(res.num_inliers, ref.num_inliers)
    assert torch.equal(R, Rr) and torch.equal(t, tr)
    assert torch.equal(g1.get_state(), g2.get_state())
