"""Uncalibrated multi-view reconstruction, structure2 (port of
``boofcv_tpu/sfm/structure2.py``).

Reference analog: boofcv-sfm alg/sfm/structure2/ —
GeneratePairwiseImageGraph.java:44 (pairwise graph with per-edge 3D-vs-
homography scores), ProjectiveInitializeAllCommon, SceneWorkingGraph.
Composed as in the reference:

1. pairwise graph: mutual-NN matches per pair, robust F AND robust H; the
   edge's "3D-ness" = F inliers / H inliers;
2. a shared focal by Sturm's equal-singular-value sweep over the graph's
   fundamental matrices, inlier-weighted median (host numpy);
3. the calibrated graph straight from those F's and inlier sets (E = Kᵀ F
   K, decomposed, cheirality-selected), then ``reconstruction``'s
   incremental growth with the self-calibrated K;
4. a final bundle adjustment with a shared free focal, by golden-section
   search around nested pose/point solves.

The pairs of a chunk are the port's stream axis: one ``torch.Generator``
per pair (F draws first, then H), every reduction per pair, so pair b of a
chunk is the single-pair call with pair b's generator.  With a ``mesh``
each rank fits its slice of a chunk's pairs and the results are
all-gathered: the same graph as without one.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.dist.mesh import all_gather, check_device, shard_index
from boofcv_tpu_torch.geo import ba, robust
from boofcv_tpu_torch.sfm import reconstruction
from boofcv_tpu_torch.sfm.reconstruction import pair_generators


@dataclass
class PairwiseEdge2:
    a: int
    b: int
    src: np.ndarray
    dst: np.ndarray
    f_inliers: np.ndarray      # bool over matches
    score_3d: float            # F inliers / H inliers
    F: np.ndarray = None       # [3, 3] fundamental matrix (pixels)


@dataclass
class PairwiseGraph2:
    features: list
    edges: dict = field(default_factory=dict)


def _batched_fh_ransac(generators, pa, pb, mask, num_hypotheses: int = 256,
                       threshold_px: float = 2.0, idx_f=None, idx_h=None,
                       mesh=None):
    """F-RANSAC and H-RANSAC for a batch of B pairs in one pass over the
    stream axis: pa, pb [B, N, 2] pixels (padded), mask [B, N], one
    generator per pair (F draws, then H draws, from it).  ``idx_f`` [B, K, 7]
    and ``idx_h`` [B, K, 4] replace the draws.  With ``mesh`` (B a multiple
    of its size) each rank fits its slice of the pairs and the results are
    all-gathered.  Returns (F [B, 3, 3], F inliers [B, N], F inlier counts
    [B], H inlier counts [B])."""
    if mesh is not None:
        rank, n = shard_index(mesh)
        if pa.shape[0] % n:
            raise ValueError(f"{pa.shape[0]} pairs do not split over "
                             f"{n} ranks")
        k = pa.shape[0] // n
        mine = slice(rank * k, (rank + 1) * k)
        cut = lambda a: None if a is None else a[mine]
        out = _batched_fh_ransac(generators[mine], pa[mine], pb[mine],
                                 mask[mine], num_hypotheses, threshold_px,
                                 cut(idx_f), cut(idx_h))
        return tuple(all_gather(a, mesh) for a in out)
    rf = robust.ransac_fundamental(generators, pa, pb,
                                   num_hypotheses=num_hypotheses,
                                   inlier_threshold_px=threshold_px,
                                   valid_mask=mask, idx=idx_f)
    rh = robust.ransac_homography(generators, pa, pb,
                                  num_hypotheses=num_hypotheses,
                                  inlier_threshold_px=threshold_px,
                                  valid_mask=mask, idx=idx_h)
    return rf.model[0], rf.inliers, rf.num_inliers, rh.num_inliers


def generate_pairwise_graph(images, max_features: int = 300, detect=None,
                            min_matches: int = 20, seed: int = 0,
                            pair_chunk: int = 64,
                            device=None, mesh=None) -> PairwiseGraph2:
    """All-pairs matching with F-vs-H model scoring
    (GeneratePairwiseImageGraph.process).  Candidate pairs are padded to a
    common match count and their F and H fits run ``pair_chunk`` pairs at a
    time (the last chunk padded with copies of pair 0, as the reference
    pads it, when there is more than one chunk or a mesh).  ``mesh``: a
    ``dist.make_mesh`` mesh on ``device``'s kind; each chunk's pairs are
    split over its ranks (the chunk rounded up to a multiple of its size).
    ``device`` None: the card."""
    dev = resolve_device(device)
    if mesh is not None:
        check_device(mesh, dev)
        n_ranks = shard_index(mesh)[1]
        pair_chunk = -(-pair_chunk // n_ranks) * n_ranks
    detect = detect or (lambda im: reconstruction.detect_describe(
        im, max_features, device=dev))
    feats = [detect(im) for im in images]
    g = PairwiseGraph2(feats)
    n = len(images)

    cands = []
    for a in range(n):
        for b in range(a + 1, n):
            src, dst = reconstruction.match_features(feats[a], feats[b],
                                                     device=dev)
            if len(src) < min_matches:
                continue
            pa = np.stack([feats[a].xs[src], feats[a].ys[src]], 1)
            pb = np.stack([feats[b].xs[dst], feats[b].ys[dst]], 1)
            cands.append((a, b, src, dst, pa, pb))
    if not cands:
        return g

    nmax = max(len(c[4]) for c in cands)
    P = len(cands)
    pa_all = np.zeros((P, nmax, 2))
    pb_all = np.zeros((P, nmax, 2))
    mask_all = np.zeros((P, nmax), bool)
    for i, (_, _, _, _, pa, pb) in enumerate(cands):
        pa_all[i, :len(pa)] = pa
        pb_all[i, :len(pb)] = pb
        mask_all[i, :len(pa)] = True
    gens = pair_generators(seed, P, dev)
    t = lambda a: torch.from_numpy(a).to(dev)

    for lo in range(0, P, pair_chunk):
        hi = min(lo + pair_chunk, P)
        idx = np.arange(lo, hi)
        chunk_gens = gens[lo:hi]
        if hi - lo < pair_chunk and (P > pair_chunk or mesh is not None):
            pad = pair_chunk - (hi - lo)
            idx = np.concatenate([idx, np.zeros(pad, np.int64)])
            # a pad slot draws from a fresh copy of pair 0's generator (the
            # reference's copy of its key), never from a real pair's
            chunk_gens = chunk_gens + pair_generators(seed, 1, dev) * pad
        F_b, inl_b, nf_b, nh_b = _batched_fh_ransac(
            chunk_gens, t(pa_all[idx]), t(pb_all[idx]), t(mask_all[idx]),
            mesh=mesh)
        F_b = F_b.cpu().numpy()
        inl_b = inl_b.cpu().numpy()
        nf_b = nf_b.cpu().numpy()
        nh_b = nh_b.cpu().numpy()
        for j, p in enumerate(range(lo, hi)):
            a, b, src, dst, pa, pb = cands[p]
            nf = int(nf_b[j])
            if nf < min_matches:
                continue
            g.edges[(a, b)] = PairwiseEdge2(
                a, b, src, dst, inl_b[j, :len(pa)],
                nf / max(int(nh_b[j]), 1), F_b[j])
    return g


def focal_from_fundamentals(g: PairwiseGraph2, width: int, height: int):
    """Shared-focal self-calibration by Sturm's equal-singular-value
    criterion: for the right K, E = Kᵀ F K has two equal non-zero singular
    values.  120 candidates from 0.25 w to 5 w, swept over every edge with
    a 3D score >= 1.5 as one batched numpy SVD; the inlier-weighted median
    of the per-edge minima."""
    cands = np.geomspace(0.25 * width, 5.0 * width, 120)
    edges3d = [e for e in g.edges.values()
               if e.F is not None and e.score_3d >= 1.5]
    if not edges3d:
        raise ValueError("no 3D edges for focal self-calibration")
    Fs = np.stack([e.F for e in edges3d])                    # [E, 3, 3]
    Ks = np.zeros((len(cands), 3, 3))
    Ks[:, 0, 0] = Ks[:, 1, 1] = cands
    Ks[:, 0, 2] = (width - 1) / 2
    Ks[:, 1, 2] = (height - 1) / 2
    Ks[:, 2, 2] = 1.0
    E_all = np.einsum("cji,ejk,ckl->ecil", Ks, Fs, Ks)       # [E, C, 3, 3]
    sv = np.linalg.svd(E_all, compute_uv=False)              # [E, C, 3]
    cost = (sv[..., 0] - sv[..., 1]) \
        / np.maximum(sv[..., 0] + sv[..., 1], 1e-12)         # [E, C]
    picks = cands[np.argmin(cost, axis=1)]
    weights = [int(e.f_inliers.sum()) for e in edges3d]
    order = np.argsort(picks)
    cum = np.cumsum(np.asarray(weights)[order])
    return float(np.asarray(picks)[order][np.searchsorted(cum, cum[-1] / 2.0)])


# E = Kᵀ F K decomposed and cheirality-selected for a batch of edges
_poses_from_essentials = reconstruction.poses_from_essentials


def _metric_graph_from_edges(g: PairwiseGraph2, K, device=None):
    """The calibrated pairwise graph from the structure2 graph's own
    fundamental matrices (E = Kᵀ F K, decomposed, cheirality-selected on
    the inlier matches, all edges with >= 16 inliers as one batch); no
    second matching pass."""
    dev = resolve_device(device)
    K = np.asarray(K, np.float64)
    Kinv = np.linalg.inv(K)
    graph = reconstruction.PairwiseGraph(g.features)
    items = [((a, b), e) for (a, b), e in g.edges.items()
             if e.f_inliers.sum() >= 16]
    if not items:
        return graph
    nmax = max(int(e.f_inliers.sum()) for _, e in items)
    M = len(items)
    na_all = np.zeros((M, nmax, 2))
    nb_all = np.zeros((M, nmax, 2))
    mask_all = np.zeros((M, nmax), bool)
    E_all = np.zeros((M, 3, 3))
    for i, ((a, b), e) in enumerate(items):
        inl = e.f_inliers
        src, dst = e.src[inl], e.dst[inl]
        k = len(src)
        na_all[i, :k] = reconstruction._normalized(g.features[a], src, Kinv)
        nb_all[i, :k] = reconstruction._normalized(g.features[b], dst, Kinv)
        mask_all[i, :k] = True
        E_all[i] = K.T @ e.F @ K
    t = lambda a: torch.from_numpy(a).to(dev)
    Rb, tb = _poses_from_essentials(t(E_all), t(na_all), t(nb_all),
                                    t(mask_all))
    Rb = Rb.cpu().numpy()
    tb = tb.cpu().numpy()
    for i, ((a, b), e) in enumerate(items):
        graph.edges[(a, b)] = reconstruction.PairwiseEdge(
            a, b, e.src, e.dst, e.f_inliers, Rb[i], tb[i],
            int(e.f_inliers.sum()))
    return graph


def reconstruct_uncalibrated(images, max_features: int = 300, detect=None,
                             ba_iterations: int = 20, seed: int = 0,
                             device=None, mesh=None):
    """The whole uncalibrated pipeline: pairwise graph with F/H scores ->
    shared focal by Sturm's sweep -> calibrated incremental growth ->
    global BA with a shared free focal (golden-section search over f,
    10 steps in [0.6 f0, 1.7 f0], a pose/point solve of
    max(ba_iterations // 2, 8) iterations nested in each evaluation; the
    costs compare across f in pixel² units).  One view is fixed (6 DoF);
    fixing the seed pair, estimated under the first focal guess, biases
    the focal.

    Returns a dict with "K", "poses" {view: (R, t)}, "points" [M, 3],
    "graph", "ba_info".  ``mesh``: the pairwise graph's fits split over
    its ranks (:func:`generate_pairwise_graph`).  ``device`` None: the
    card."""
    dev = resolve_device(device)
    g = generate_pairwise_graph(images, max_features, detect, seed=seed,
                                device=dev, mesh=mesh)
    if not g.edges:
        raise ValueError("no connected 3D view pairs in the graph")
    h, w = images[0].shape[:2]
    f0 = focal_from_fundamentals(g, w, h)
    K = np.array([[f0, 0.0, (w - 1) / 2.0],
                  [0.0, f0, (h - 1) / 2.0], [0.0, 0.0, 1.0]])
    g1 = _metric_graph_from_edges(g, K, device=dev)
    scene = reconstruction.reconstruct_incremental(
        g1, K, ba_iterations=ba_iterations, seed=seed + 1, device=dev)

    prob = scene["problem"]                 # normalized model, converged
    obs_px = prob.obs_xy.cpu().numpy() * f0  # centred pixels
    R0 = prob.R.cpu().numpy()
    t0 = prob.t.cpu().numpy()
    X0 = prob.points.cpu().numpy()
    ov = prob.obs_view.cpu().numpy()
    oval = prob.obs_valid.cpu().numpy()
    fixed = np.zeros(R0.shape[0], bool)
    fixed[0] = True

    def solve_at(f):
        pf = ba.make_problem(R0, t0, X0, obs_px / f, ov, oval,
                             fixed_views=fixed, device=dev)
        out, info = ba.optimize(pf, iterations=max(ba_iterations // 2, 8))
        return float(info["final_cost"]) * f * f, out

    gr = (np.sqrt(5.0) - 1.0) / 2.0
    lo, hi = 0.6 * f0, 1.7 * f0
    x1 = hi - gr * (hi - lo)
    x2 = lo + gr * (hi - lo)
    c1, o1 = solve_at(x1)
    c2, o2 = solve_at(x2)
    for _ in range(10):
        if c1 < c2:
            hi, x2, c2, o2 = x2, x1, c1, o1
            x1 = hi - gr * (hi - lo)
            c1, o1 = solve_at(x1)
        else:
            lo, x1, c1, o1 = x1, x2, c2, o2
            x2 = lo + gr * (hi - lo)
            c2, o2 = solve_at(x2)
    f_ref, out, info = (x1, o1, {"final_cost": c1}) if c1 < c2 \
        else (x2, o2, {"final_cost": c2})
    K = np.array([[f_ref, 0.0, (w - 1) / 2.0],
                  [0.0, f_ref, (h - 1) / 2.0], [0.0, 0.0, 1.0]])
    vmap_idx = scene["view_index"]
    R_out, t_out = out.R.cpu().numpy(), out.t.cpu().numpy()
    return {
        "K": K,
        "poses": {v: (R_out[vmap_idx[v]], t_out[vmap_idx[v]])
                  for v in sorted(scene["poses"])},
        "points": out.points.cpu().numpy(),
        "graph": g,
        "ba_info": info,
    }
