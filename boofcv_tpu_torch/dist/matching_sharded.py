"""Pair-parallel matching and robust geometry over a mesh (port of
``boofcv_tpu/dist/matching_sharded.py``).

Reference analog: none (BoofCV's PairwiseImageMatching is sequential).
The K image pairs are padded to a multiple of the mesh's size and split on
their leading axis; every rank runs its pairs through the same program
(descriptor scores, mutual nearest neighbours, essential RANSAC,
decomposition and cheirality) on the pair axis, ``PAIR_CHUNK`` pairs a
batch (the reference runs a device's shard as one batch: a chunk of 16
Nister fits holds gigabytes at a thousand matches), and the results are
all-gathered as fixed-shape arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch.dist.mesh import all_gather, mesh_device, shard_index
from boofcv_tpu_torch.feature import associate
from boofcv_tpu_torch.geo import epipolar, robust
from boofcv_tpu_torch.sfm.reconstruction import PAIR_CHUNK, pair_generators


def _match_chunk(desc, xy, valid_feat, Kinv, pairs, gens, idx,
                 num_hypotheses, inlier_threshold, max_desc_error) -> dict:
    """One batch of pairs [B, 2] through association, essential RANSAC,
    decomposition and cheirality, each pair its own stream."""
    a, b = pairs[:, 0], pairs[:, 1]
    scores = associate.score_euclidean_sq(desc[a], desc[b])      # [B, N, N]
    m = associate.associate_mutual(scores, max_error=max_desc_error ** 2,
                                   valid_a=valid_feat[a],
                                   valid_b=valid_feat[b])

    def normalized(view, slot):
        p = torch.take_along_dim(xy[view], slot.long()[..., None], dim=1)
        h = torch.cat([p, torch.ones_like(p[..., :1])], -1) @ Kinv.T
        return h[..., :2]
    na, nb = normalized(a, m.src), normalized(b, m.dst)
    res = robust.ransac_essential(gens, na, nb,
                                  num_hypotheses=num_hypotheses,
                                  inlier_threshold=inlier_threshold,
                                  valid_mask=m.valid, idx=idx)
    R4, t4 = epipolar.decompose_essential(res.model)
    inl = res.inliers[..., None]
    R, t, _ = epipolar.select_pose_cheirality(
        R4, t4, torch.where(inl, na, 0.0), torch.where(inl, nb, 0.0))
    return {"num_inliers": res.num_inliers, "R": R, "t": t, "src": m.src,
            "dst": m.dst, "inliers": res.inliers & m.valid}


def match_pairs_sharded(mesh, desc, xy, pair_idx, Kinv,
                        num_hypotheses: int = 256,
                        inlier_threshold: float = 2e-5,
                        max_desc_error: float = 0.35, seed: int = 0,
                        idx=None):
    """Matching and essential RANSAC for every (a, b) pair across the mesh.

    desc: [V, N, D] per-view descriptors (fixed capacity, zero-padded);
    xy: [V, N, 2] pixel coords; pair_idx: [K, 2] int; Kinv: [3, 3].  Pair
    p draws from its own generator (``reconstruction.pair_generators``);
    ``idx`` [K, num_hypotheses, 5] replaces the draws.  Every rank returns
    the whole result: a dict of numpy arrays with leading axis K:
    num_inliers, R, t, src, dst, inliers.
    """
    dev = mesh_device(mesh)
    desc = torch.as_tensor(np.asarray(desc), dtype=torch.float32, device=dev)
    xy = torch.as_tensor(np.asarray(xy), dtype=torch.float64, device=dev)
    pair_idx = torch.as_tensor(np.asarray(pair_idx), dtype=torch.long,
                               device=dev)
    Kinv = torch.as_tensor(np.asarray(Kinv), dtype=torch.float64, device=dev)
    k_true = pair_idx.shape[0]
    rank, n = shard_index(mesh)
    pad = (-k_true) % n
    pair_idx = torch.cat([pair_idx, pair_idx.new_zeros((pad, 2))])
    k = pair_idx.shape[0] // n
    mine = slice(rank * k, (rank + 1) * k)
    gens = pair_generators(seed, pair_idx.shape[0], dev)[mine]
    if idx is not None:
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=dev)
        idx = torch.cat([idx, idx[:1].expand((pad,) + idx.shape[1:])])[mine]

    # zero-padded capacity slots must not associate: a pad row and a pad
    # column are mutual nearest neighbours at score 0
    valid_feat = torch.linalg.vector_norm(desc, dim=-1) > 0.0    # [V, N]
    pairs = pair_idx[mine]
    parts = []
    # the rank's pairs go PAIR_CHUNK at a time: each pair's fit is its own
    # stream, and a chunk's Sampson scores bound the memory
    for lo in range(0, k, PAIR_CHUNK):
        cut = slice(lo, lo + PAIR_CHUNK)
        parts.append(_match_chunk(
            desc, xy, valid_feat, Kinv, pairs[cut], gens[cut],
            None if idx is None else idx[cut], num_hypotheses,
            inlier_threshold, max_desc_error))
    out = {key: torch.cat([part[key] for part in parts])
           for key in parts[0]}
    return {key: all_gather(v, mesh).cpu().numpy()[:k_true]
            for key, v in out.items()}
