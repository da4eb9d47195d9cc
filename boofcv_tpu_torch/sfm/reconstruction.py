"""Multi-view metric reconstruction, calibrated (port of
``boofcv_tpu/sfm/reconstruction.py``, whole).

Reference analog: boofcv-sfm alg/sfm/structure/ — PairwiseImageMatching
.java:49,169 (all-pairs detect/describe/associate + robust E -> graph),
PairwiseImageGraph.java, EstimateSceneCalibrated.java:65,111 (seed
selection, essential decomposition :175, incremental growth with PnP and
triangulate-as-you-grow :296-580).

Split as in the reference: detection, description, association, RANSAC,
triangulation and BA run on the device; the graph bookkeeping (track
tables, which view joins next) is numpy on the host.  Random draws come
from explicit ``torch.Generator``s seeded from ``seed``: one a candidate
pair for the essential fits (batched over pairs, see
:func:`build_pairwise_graph`), one for the growth's PnP fits, drawn in the
order the reference splits its keys.

The reference pads the per-view PnP RANSAC and each two-view triangulation
to power-of-two buckets so that XLA compiles O(log N) programs.  The port
drops both pads, because neither changes a result: a triangulation is per
point, and a padded PnP slot is masked out of every vote, refit and sum
(with the same index sets the same model wins).  What does change is the
draw itself (``torch.rand`` over n points, not over the bucket), and the
port cannot reproduce ``jax.random`` anyway.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.feature import associate, describe, fasthessian
from boofcv_tpu_torch.geo import ba, epipolar, robust, triangulate
from boofcv_tpu_torch.ip import integral as ii_ops


@dataclass
class ImageFeatures:
    ys: np.ndarray
    xs: np.ndarray
    scales: np.ndarray
    desc: np.ndarray      # [N, 64]
    valid: np.ndarray


def detect_describe(image, max_features: int = 300,
                    device=None) -> ImageFeatures:
    """SURF detect + describe (WrapDetectDescribeSurf), on ``device``
    (None: the card); the features come back as numpy."""
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(image), dtype=torch.float32, device=dev)
    ii = ii_ops.transform(img)
    det = fasthessian.detect_multi_octave(
        ii, max_features_per_octave=max_features // 2)
    angles = describe.orientation_average_haar(ii, det.ys, det.xs,
                                               det.scales)
    desc = describe.surf(ii, det.ys, det.xs, det.scales, angles)
    host = lambda a: a.cpu().numpy()
    return ImageFeatures(host(det.ys), host(det.xs), host(det.scales),
                         host(desc), host(det.valid))


def match_features(fa: ImageFeatures, fb: ImageFeatures,
                   max_error: float = 0.35, device=None):
    """Mutual-NN association on the [N, M] score matrix (one matmul).
    Returns the matched feature indices (src in a, dst in b) as numpy."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    scores = associate.score_euclidean_sq(t(fa.desc), t(fb.desc))
    big = 1e12
    scores = torch.where(t(fa.valid)[:, None], scores, big)
    scores = torch.where(t(fb.valid)[None, :], scores, big)
    m = associate.associate_mutual(scores, max_error=max_error ** 2)
    ok = m.valid.cpu().numpy()
    return m.src.cpu().numpy()[ok], m.dst.cpu().numpy()[ok]


@dataclass
class PairwiseEdge:
    view_a: int
    view_b: int
    matches_a: np.ndarray     # feature indices in view a
    matches_b: np.ndarray
    inliers: np.ndarray       # bool over matches
    R: np.ndarray             # relative pose: x_b = R x_a + t (unit t)
    t: np.ndarray
    score: int


@dataclass
class PairwiseGraph:
    features: List[ImageFeatures]
    edges: Dict[Tuple[int, int], PairwiseEdge] = field(default_factory=dict)


def _normalized(feat: ImageFeatures, idx, Kinv):
    p = np.stack([feat.xs[idx], feat.ys[idx], np.ones(len(idx))], 1)
    return (p @ Kinv.T)[:, :2]


def pair_generators(seed: int, count: int, device) -> list:
    """One generator per candidate pair p, seeded ``seed * 1_000_003 + p``
    (the reference splits one key per pair)."""
    return [torch.Generator(device=device).manual_seed(seed * 1_000_003 + p)
            for p in range(count)]


def poses_from_essentials(E_mats, na, nb, mask):
    """Essential decomposition + masked cheirality selection for a batch of
    M pairs (the reference's ``select_pose_cheirality`` on each pair's
    inliers, and structure2's ``_poses_from_essentials``): E_mats
    [M, 3, 3], na/nb [M, N, 2] normalized coordinates (padded), mask
    [M, N].  Returns (R [M, 3, 3], t [M, 3]); the choice is made on the
    device."""
    R4, t4 = epipolar.decompose_essential(E_mats)       # [M, 4, ...]
    X = triangulate.triangulate_two_view_linear(
        na[:, None].expand(-1, 4, -1, -1), nb[:, None].expand(-1, 4, -1, -1),
        R4, t4)                                         # [M, 4, N, 3]
    z2 = (X @ R4.transpose(-1, -2) + t4[..., None, :])[..., 2]
    counts = torch.sum((X[..., 2] > 0) & (z2 > 0) & mask[:, None], dim=-1)
    best = torch.argmax(counts, dim=-1)                 # [M]
    R = torch.take_along_dim(R4, best[:, None, None, None], dim=1)[:, 0]
    t = torch.take_along_dim(t4, best[:, None, None], dim=1)[:, 0]
    return R, t


# candidate pairs a chunk of essential fits: a chunk's Sampson scoring holds
# [16, 2560, N] float64 errors and a few times that in temporaries (about
# 5-9 GB at N = 1,500 on the card)
PAIR_CHUNK = 16


def build_pairwise_graph(images, K, max_features: int = 300,
                         min_inliers: int = 20, seed: int = 0,
                         detect=None, device=None) -> PairwiseGraph:
    """All-pairs matching + robust essential (PairwiseImageMatching.process):
    every pair with 16 matches or more is a candidate; Nister RANSAC (256
    hypotheses) on normalized coordinates and the cheirality-selected pose,
    kept where 20 inliers or more remain.  ``detect``: optional override
    returning ImageFeatures (the tests' synthetic detections).  ``device``
    None: the card.

    The reference runs one RANSAC a pair; here the candidates are padded to
    a common match count and go ``PAIR_CHUNK`` at a time through the stream
    axis of ``robust.ransac_essential`` (one generator a pair, every
    reduction per pair), as structure2 fits its F and H: pair b of a chunk
    gives what a chunk of pair b alone gives, and a Nister call costs the
    same ~24,000 launches for one pair or 16."""
    dev = resolve_device(device)
    detect = detect or (lambda im: detect_describe(im, max_features,
                                                   device=dev))
    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    feats = [detect(im) for im in images]
    graph = PairwiseGraph(feats)
    n = len(images)
    cands = []
    for a in range(n):
        for b in range(a + 1, n):
            src, dst = match_features(feats[a], feats[b], device=dev)
            if src.size >= 16:
                cands.append((a, b, src, dst))
    if not cands:
        return graph
    nmax = max(len(c[2]) for c in cands)
    P = len(cands)
    na_all = np.zeros((P, nmax, 2))
    nb_all = np.zeros((P, nmax, 2))
    mask_all = np.zeros((P, nmax), bool)
    for i, (a, b, src, dst) in enumerate(cands):
        na_all[i, :len(src)] = _normalized(feats[a], src, Kinv)
        nb_all[i, :len(src)] = _normalized(feats[b], dst, Kinv)
        mask_all[i, :len(src)] = True
    gens = pair_generators(seed, P, dev)
    t = lambda a: torch.from_numpy(a).to(dev)
    for lo in range(0, P, PAIR_CHUNK):
        hi = min(lo + PAIR_CHUNK, P)
        na, nb = t(na_all[lo:hi]), t(nb_all[lo:hi])
        res = robust.ransac_essential(gens[lo:hi], na, nb,
                                      num_hypotheses=256,
                                      inlier_threshold=2e-5,
                                      valid_mask=t(mask_all[lo:hi]))
        R, tr = poses_from_essentials(res.model, na, nb, res.inliers)
        inl = res.inliers.cpu().numpy()
        R, tr = R.cpu().numpy(), tr.cpu().numpy()
        for j, (a, b, src, dst) in enumerate(cands[lo:hi]):
            ok = inl[j, :len(src)]
            if ok.sum() >= min_inliers:
                graph.edges[(a, b)] = PairwiseEdge(a, b, src, dst, ok, R[j],
                                                   tr[j], int(ok.sum()))
    return graph


def _tri2(na, nb, R, t, device):
    """Two-view linear triangulation of numpy inputs on ``device``, camera-a
    frame, back as numpy (the reference's ``_tri2_padded`` without its
    power-of-two pad: each point is solved on its own)."""
    tt = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    return triangulate.triangulate_two_view_linear(
        tt(na), tt(nb), tt(R), tt(t)).cpu().numpy()


def reconstruct_incremental(graph: PairwiseGraph, K, ba_iterations: int = 15,
                            seed: int = 1, device=None):
    """Incremental metric growth + final BA (EstimateSceneCalibrated).

    Returns a dict: ``views`` (sorted), ``poses`` {view: (R, t)} numpy,
    ``points`` [M, 3] numpy, ``problem`` (the solved BAProblem),
    ``view_index`` {view: row of the problem}, ``ba_info``.  ``device``
    None: the card."""
    dev = resolve_device(device)
    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    if not graph.edges:
        raise ValueError("empty pairwise graph")

    def norm_coords(view, idxs):
        return _normalized(graph.features[view], idxs, Kinv)

    # --- seed: the best edge (defineCoordinateSystem :671); world = view a
    seed_edge = max(graph.edges.values(), key=lambda e: e.score)
    a, b = seed_edge.view_a, seed_edge.view_b
    poses = {a: (np.eye(3), np.zeros(3)), b: (seed_edge.R, seed_edge.t)}

    # track table: per point its observations (view, feature, normalized)
    obs_of_point: List[list] = []
    point_xyz: List[np.ndarray] = []
    # per view: feature index -> point id (-1 = none)
    point_of_feat = [np.full(len(f.xs), -1, np.int64)
                     for f in graph.features]

    ia = seed_edge.matches_a[seed_edge.inliers]
    ib = seed_edge.matches_b[seed_edge.inliers]
    na = norm_coords(a, ia)
    nb = norm_coords(b, ib)
    X = _tri2(na, nb, seed_edge.R, seed_edge.t, dev)
    for i in np.nonzero(X[:, 2] > 0)[0]:
        pid = len(point_xyz)
        point_xyz.append(X[i])
        obs_of_point.append([(a, ia[i], na[i]), (b, ib[i], nb[i])])
        point_of_feat[a][ia[i]] = pid
        point_of_feat[b][ib[i]] = pid

    # --- grow (estimateAllFeatures :402)
    edges_by_view: Dict[int, list] = {}
    for (x, y), e in graph.edges.items():
        edges_by_view.setdefault(x, []).append((x, y, e))
        edges_by_view.setdefault(y, []).append((x, y, e))

    def correspondences(v):
        """All (point id, own feature idx) links from registered views."""
        pid_list, own_list = [], []
        for x, y, e in edges_by_view.get(v, ()):
            if x == v and y in poses:
                known, own = e.matches_b[e.inliers], e.matches_a[e.inliers]
                kv = y
            elif y == v and x in poses:
                known, own = e.matches_a[e.inliers], e.matches_b[e.inliers]
                kv = x
            else:
                continue
            pids = point_of_feat[kv][known]
            has = pids >= 0
            pid_list.append(pids[has])
            own_list.append(own[has])
        if not pid_list:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(pid_list), np.concatenate(own_list)

    gen = torch.Generator(device=dev).manual_seed(seed)
    remaining = set(range(len(graph.features))) - set(poses)
    while remaining:
        best_view, best_pairs = None, (np.zeros(0, np.int64),) * 2
        for v in remaining:
            pids, own = correspondences(v)
            if len(pids) > len(best_pairs[0]):
                best_view, best_pairs = v, (pids, own)
        pids, fidx = best_pairs
        if best_view is None or len(pids) < 6:
            break  # disconnected remainder
        world = np.stack([point_xyz[p] for p in pids])
        obs = norm_coords(best_view, fidx)
        res, (R, t) = robust.ransac_pnp(
            gen, torch.from_numpy(world).to(dev),
            torch.from_numpy(obs).to(dev), num_hypotheses=256,
            inlier_threshold=2e-5)
        poses[best_view] = (R.cpu().numpy(), t.cpu().numpy())
        remaining.discard(best_view)
        # register this view's observations of existing points; a point
        # reached through several registered neighbours keeps ONE
        # observation per view (else the final BA counts it twice)
        seen_pid = set()
        inl = res.inliers.cpu().numpy()
        for i in np.nonzero(inl)[0]:
            if pids[i] in seen_pid:
                continue
            seen_pid.add(pids[i])
            obs_of_point[pids[i]].append((best_view, fidx[i], obs[i]))
        point_of_feat[best_view][fidx[inl]] = pids[inl]
        # triangulate brand-new tracks with already-registered views
        for x, y, e in edges_by_view.get(best_view, ()):
            if not (x in poses and y in poses):
                continue
            Rx, tx = poses[x]
            Ry, ty = poses[y]
            Rrel = Ry @ Rx.T                      # relative pose x -> y
            trel = ty - Rrel @ tx
            ia_all = e.matches_a[e.inliers]
            ib_all = e.matches_b[e.inliers]
            fresh = (point_of_feat[x][ia_all] < 0) \
                & (point_of_feat[y][ib_all] < 0)
            if not fresh.any():
                continue
            ia = ia_all[fresh]
            ib = ib_all[fresh]
            na = norm_coords(x, ia)
            nb = norm_coords(y, ib)
            Xl = _tri2(na, nb, Rrel, trel, dev)
            Xw = (Xl - tx) @ Rx                   # X_w = Rxᵀ (X_x - tx)
            zok = Xl[:, 2] > 0
            base = len(point_xyz)
            new_ids = np.full(len(ia), -1, np.int64)
            new_ids[zok] = base + np.arange(int(zok.sum()))
            point_xyz.extend(Xw[zok])
            obs_of_point.extend(
                [(x, iai, nai), (y, ibi, nbi)]
                for iai, nai, ibi, nbi in zip(ia[zok], na[zok], ib[zok],
                                              nb[zok]))
            point_of_feat[x][ia[zok]] = new_ids[zok]
            point_of_feat[y][ib[zok]] = new_ids[zok]

    # --- final BA (convertToOutput :240 + bundleSparseMetric)
    views = sorted(poses)
    vmap_idx = {v: i for i, v in enumerate(views)}
    P = len(point_xyz)
    if P == 0:
        raise ValueError(
            "reconstruction failed: the seed pair triangulated no "
            "cheirality-positive points (degenerate geometry)")
    L = max(len(o) for o in obs_of_point)
    obs_xy = np.zeros((P, L, 2))
    obs_view = np.zeros((P, L), np.int32)
    obs_valid = np.zeros((P, L), bool)
    for p, olist in enumerate(obs_of_point):
        for s, (v, _, xy) in enumerate(olist[:L]):
            obs_xy[p, s] = xy
            obs_view[p, s] = vmap_idx[v]
            obs_valid[p, s] = True
    Rs = np.stack([poses[v][0] for v in views])
    ts = np.stack([poses[v][1] for v in views])
    fixed = np.zeros(len(views), bool)
    fixed[0] = True
    # pin scale: also fix the seed partner's pose
    if len(views) > 1:
        fixed[vmap_idx.get(b, 1)] = True
    prob = ba.make_problem(Rs, ts, np.stack(point_xyz), obs_xy, obs_view,
                           obs_valid, fixed_views=fixed, device=dev)
    # prune gross-outlier observations before the final BA
    # (PruneStructureFromSceneMetric): gate at max(10 x median, 3e-3
    # normalized units); a point left with < 2 observations is dropped
    # whole (unconstrained in the solve, its updates damped to 0)
    errs = torch.linalg.vector_norm(ba.residuals(prob), dim=-1).cpu().numpy()
    valid = prob.obs_valid.cpu().numpy()
    med = float(np.median(errs[valid])) if valid.any() else 0.0
    keep = valid & (errs <= max(10.0 * med, 3e-3))
    keep[keep.sum(axis=1) < 2] = False
    prob = prob._replace(obs_valid=torch.from_numpy(keep).to(dev))
    out, info = ba.optimize(prob, iterations=ba_iterations)
    R_out, t_out = out.R.cpu().numpy(), out.t.cpu().numpy()
    return {
        "views": views,
        "poses": {v: (R_out[vmap_idx[v]], t_out[vmap_idx[v]])
                  for v in views},
        "points": out.points.cpu().numpy(),
        "problem": out,
        "view_index": dict(vmap_idx),
        "ba_info": info,
    }
