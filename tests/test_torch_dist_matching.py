"""The port's sharded pair matching (``boofcv_tpu_torch/dist/
matching_sharded.py``), structure2's ``mesh=`` fan-out and the uncalibrated
demo's ``--mesh`` on four gloo ranks.

``match_pairs_sharded`` is held against the JAX package's ``shard_map``
version on a 4-device CPU mesh with the reference's draws injected
(``idx``: the key of each pair, ``robust.sample_indices`` over the pair's
mutual matches, as ``robust.ransac`` draws): the same inlier counts and
sets, R within 1e-6.  ``generate_pairwise_graph(mesh=)`` must give the
unsharded call's graph exactly.  One gloo group serves the file
(``test_torch_dist_ba.run_ranks``); JAX is imported in the parent only.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

from boofcv_tpu_torch.dist import mesh as tmesh
from boofcv_tpu_torch.dist.matching_sharded import match_pairs_sharded
from boofcv_tpu_torch.examples import uncalibrated_reconstruction
from boofcv_tpu_torch.sfm import structure2
from boofcv_tpu_torch.sfm.reconstruction import ImageFeatures

from test_torch_dist_ba import WORLD, assert_ranks_agree, run_ranks

K = np.array([[200.0, 0, 160], [0, 200.0, 120], [0, 0, 1.0]])
HYP = 256


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * (k @ k)


def match_scene(V=4, N=80):
    """``tests/test_dist_matching.py``'s: V views of N points, the feature
    order shuffled a view."""
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                    rng.uniform(5, 8, N)], 1)
    desc0 = rng.normal(0, 1, (N, 32)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=1, keepdims=True)
    descs = np.zeros((V, N, 32), np.float32)
    xys = np.zeros((V, N, 2))
    poses = []
    for v in range(V):
        R = _rodrigues(rng.normal(0, 0.02, 3))
        t = np.array([0.4 * v, 0.0, 0.0])
        poses.append((R, t))
        Xc = pts @ R.T + t
        proj = (Xc / Xc[:, 2:]) @ K.T
        perm = rng.permutation(N)
        xys[v] = proj[perm, :2] + rng.normal(0, 0.1, (N, 2))
        descs[v] = desc0[perm] + rng.normal(0, 0.01, (N, 32))
    pairs = np.array([(a, b) for a in range(V) for b in range(a + 1, V)])
    return descs, xys, pairs, poses


def graph_features(n_views=8, n_points=90):
    """``tests/test_dist_matching.py::test_structure2_graph_mesh_parity``'s
    views: (images, features)."""
    rng = np.random.default_rng(11)
    H, W, f = 160, 200, 190.0
    pts = np.stack([rng.uniform(-2, 2, n_points),
                    rng.uniform(-1.5, 1.5, n_points),
                    rng.uniform(5, 9, n_points)], 1)
    desc = rng.normal(0, 1, (n_points, 32))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    Kf = np.array([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1.0]])
    feats = []
    for v in range(n_views):
        R = _rodrigues(rng.normal(0, 0.03, 3))
        t = -R @ np.array([0.4 * v, 0.2 * (v % 2), 0.0])
        pc = pts @ R.T + t
        pr = (pc / pc[:, 2:]) @ Kf.T
        vis = ((pr[:, :2] > 6) & (pr[:, :2] < [W - 6, H - 6])).all(1)
        idx = np.nonzero(vis)[0]
        feats.append(ImageFeatures(
            ys=pr[idx, 1], xs=pr[idx, 0], scales=np.ones(len(idx)),
            desc=desc[idx] + rng.normal(0, 0.02, (len(idx), 32)),
            valid=np.ones(len(idx), bool)))
    return [np.zeros((H, W), np.float32)] * n_views, feats


def match_case(idx=None):
    descs, xys, pairs, _ = match_scene()
    return match_pairs_sharded(tmesh.make_mesh(device="cpu"), descs, xys,
                               pairs, np.linalg.inv(K), num_hypotheses=HYP,
                               idx=idx)


def graph_case(mesh=True):
    """``generate_pairwise_graph`` (seed 3) as {(a, b): edge fields}."""
    images, feats = graph_features()
    it = iter(feats)
    g = structure2.generate_pairwise_graph(
        images, detect=lambda im: next(it), seed=3, device="cpu",
        mesh=tmesh.make_mesh(device="cpu") if mesh else None)
    return {key: {"src": e.src, "dst": e.dst, "f_inliers": e.f_inliers,
                  "score_3d": np.float64(e.score_3d), "F": e.F}
            for key, e in g.edges.items()}


def example_case():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = uncalibrated_reconstruction.main(["--device", "cpu", "--mesh"])
    return {"rc": np.int64(rc), "log": np.array(out.getvalue())}


def _reference_draws(descs, pairs, seed=0):
    """The index sets the reference's ``match_pairs_sharded`` draws for
    each pair: its key of the pair, sampled over the pair's mutual
    matches."""
    import jax
    import jax.numpy as jnp
    from boofcv_tpu.feature import associate as jassoc
    from boofcv_tpu.geo import robust as jrobust
    n_pad = len(pairs) + (-len(pairs)) % WORLD
    keys = jax.random.split(jax.random.PRNGKey(seed), n_pad)
    d = jnp.asarray(descs)
    valid = jnp.linalg.norm(d, axis=-1) > 0.0
    out = []
    for key, (a, b) in zip(keys, pairs):
        m = jassoc.associate_mutual(jassoc.score_euclidean_sq(d[a], d[b]),
                                    max_error=0.35 ** 2, valid_a=valid[a],
                                    valid_b=valid[b])
        out.append(np.asarray(jrobust.sample_indices(
            key, HYP, 5, descs.shape[1], m.valid)))
    return np.stack(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the JAX reference, the unsharded graph)."""
    descs, xys, pairs, _ = match_scene()
    idx = _reference_draws(descs, pairs)
    wait = run_ranks({"parity": (__name__, "match_case", {"idx": idx}),
                      "drawn": (__name__, "match_case", {}),
                      "graph": (__name__, "graph_case", {}),
                      "example": (__name__, "example_case", {})},
                     tmp_path_factory.mktemp("dist_matching"))
    from boofcv_tpu.dist import make_mesh as jmake_mesh
    from boofcv_tpu.dist.matching_sharded import match_pairs_sharded as jmps
    ref = jmps(jmake_mesh(WORLD), descs, xys, pairs, np.linalg.inv(K),
               num_hypotheses=HYP)
    return wait(), ref, graph_case(mesh=False)


@pytest.mark.parametrize("name", ["parity", "drawn", "graph", "example"])
def test_every_rank_returns_the_same_answer(runs, name):
    assert_ranks_agree(runs[0], name)


def test_match_pairs_matches_jax_with_its_draws(runs):
    got, want = runs[0][0]["parity"], runs[1]
    for key in ("src", "dst", "num_inliers", "inliers"):
        assert np.array_equal(got[key], want[key]), key
    np.testing.assert_allclose(got["R"], want["R"], atol=1e-6)
    np.testing.assert_allclose(got["t"], want["t"], atol=1e-6)


@pytest.mark.parametrize("name", ["parity", "drawn"])
def test_sharded_pairwise_matching_recovers_rotations(runs, name):
    """The reference test's bars, with its draws and with the port's."""
    got = runs[0][0][name]
    _, _, pairs, poses = match_scene()
    assert got["num_inliers"].shape == (len(pairs),)
    for k, (a, b) in enumerate(pairs):
        assert got["num_inliers"][k] > 0.7 * 80, (a, b)
        np.testing.assert_allclose(got["R"][k], poses[b][0] @ poses[a][0].T,
                                   atol=1e-2)


def test_structure2_graph_mesh_parity(runs):
    """Four ranks give the unsharded graph edge for edge, bit for bit."""
    got, want = runs[0][0]["graph"], runs[2]
    assert sorted(got) == sorted(want) and len(want) >= 10
    for key, e in want.items():
        for field, value in e.items():
            assert np.array_equal(got[key][field], value), (key, field)


def test_uncalibrated_demo_with_mesh_on_four_ranks(runs):
    got = runs[0][0]["example"]
    log = str(got["log"])
    assert int(got["rc"]) == 0, log
    assert "fanned over 4 ranks" in log
    assert log.strip().splitlines()[-1] == "OK"


def test_uncalibrated_demo_with_mesh_alone(capsys):
    """One process and no group: a one-rank group."""
    try:
        assert uncalibrated_reconstruction.main(
            ["--device", "cpu", "--mesh"]) == 0
    finally:
        dist.destroy_process_group()
    log = capsys.readouterr().out
    assert "fanned over 1 ranks" in log
    assert log.strip().splitlines()[-1] == "OK"


def test_uncalibrated_demo_under_torchrun(tmp_path):
    """Two torchrun ranks: ``make_mesh`` joins the job's group from its
    environment (``--standalone`` takes a free port itself); each rank's
    output goes to its own file."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "--log-dir", str(tmp_path), "--redirects",
         "3", "-m", "boofcv_tpu_torch.examples.uncalibrated_reconstruction",
         "--device", "cpu", "--mesh"], capture_output=True, text=True,
        env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    logs = sorted(tmp_path.rglob("stdout.log"))
    assert len(logs) == 2
    for log in logs:
        lines = log.read_text().splitlines()
        assert lines[0] == "pairwise matching fanned over 2 ranks"
        assert lines[-1] == "OK"
