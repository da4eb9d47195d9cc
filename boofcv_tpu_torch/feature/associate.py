"""Descriptor association (port of ``boofcv_tpu/feature/associate.py``).

Reference analog: boofcv-feature alg/feature/associate/AssociateGreedy.java
(brute-force greedy with backwards validation), ScoreAssociation
implementations (DescriptorDistance.java), EnsureUniqueAssociation.

The all-pairs score matrix is one matrix product (squared Euclidean through
|a|^2 + |b|^2 - 2ab, in full float32: TF32 is off for the package), and
greedy with backwards validation becomes mutual nearest neighbour: row
argmin and column argmin agreeing.  ``argmin`` returns the first of equal
minima, as the reference's does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device

INF = float("inf")


class Matches(NamedTuple):
    """Fixed-capacity association set (analog of FastQueue<AssociatedIndex>)."""
    src: torch.Tensor     # [N] int32 index into the source set
    dst: torch.Tensor     # [N] int32 index into the destination set
    score: torch.Tensor   # [N] f32 fit score (lower is better)
    valid: torch.Tensor   # [N] bool


def _big() -> float:
    return torch.finfo(torch.float32).max


def _arange32(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def score_euclidean_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., Na, D] x [..., Nb, D] -> [..., Na, Nb] squared Euclidean
    distance (leading axes: a batch of independent pairs of sets)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    return torch.clamp(a2 + b2.mT - 2.0 * (a @ b.mT), min=0.0)


def score_sad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of absolute differences (DescriptorDistance.sad)."""
    return torch.sum(torch.abs(a[:, None, :] - b[None, :, :]), dim=-1)


def score_ncc(a: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-8) -> torch.Tensor:
    """Negative NCC as a *distance* (lower is better) between descriptors
    that are made zero-mean here."""
    am = a - torch.mean(a, dim=1, keepdim=True)
    bm = b - torch.mean(b, dim=1, keepdim=True)
    an = am / (torch.linalg.vector_norm(am, dim=1, keepdim=True) + eps)
    bn = bm / (torch.linalg.vector_norm(bm, dim=1, keepdim=True) + eps)
    return -(an @ bn.T)


def score_hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between packed descriptor rows [N, W] int32 (all 32
    bits of a word count, the sign bit included)."""
    x = torch.bitwise_xor(a[:, None, :], b[None, :, :])
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    pc = (x * 0x01010101) >> 24
    return torch.sum(pc, dim=-1).to(torch.float32)


def associate_mutual(scores: torch.Tensor,
                     valid_a: torch.Tensor | None = None,
                     valid_b: torch.Tensor | None = None,
                     max_error: float = INF) -> Matches:
    """Mutual-nearest-neighbour association from a [Na, Nb] score matrix
    (or [..., Na, Nb] with [..., Na] / [..., Nb] masks: a batch of
    independent pairs of sets, every field gaining the leading axes).

    Equivalent to AssociateGreedy with backwardsValidation=true: src i and
    dst j match iff j = argmin_j S[i, j] and i = argmin_i S[i, j] and
    S[i, j] <= max_error.  Output capacity = Na (one candidate per
    source)."""
    na = scores.shape[-2]
    big = _big()
    s = scores.to(torch.float32)
    if valid_a is not None:
        s = torch.where(valid_a[..., :, None], s, big)
    if valid_b is not None:
        s = torch.where(valid_b[..., None, :], s, big)
    row_min, best_j = torch.min(s, dim=-1)           # [..., Na]
    best_i = torch.argmin(s, dim=-2)                 # [..., Nb]
    src = _arange32(na, s.device)
    mutual = torch.take_along_dim(best_i, best_j, dim=-1) == src
    ok = mutual & (row_min <= max_error) & (row_min < big)
    return Matches(src.expand(row_min.shape), best_j.to(torch.int32),
                   row_min, ok)


def associate_greedy(scores: torch.Tensor, max_error: float = INF,
                     backwards: bool = True) -> Matches:
    """AssociateGreedy semantics; with backwards validation this equals
    mutual nearest neighbour (the forward pass picks each row's min, the
    backward pass keeps pairs that are also the column min)."""
    if backwards:
        return associate_mutual(scores, max_error=max_error)
    row_min, best_j = torch.min(scores, dim=1)
    return Matches(_arange32(scores.shape[0], scores.device),
                   best_j.to(torch.int32), row_min, row_min <= max_error)


def associate_ratio_test(scores: torch.Tensor, ratio: float = 0.8,
                         max_error: float = INF) -> Matches:
    """Lowe ratio-test association (ScoreRatioAssociation analog)."""
    low2, idx2 = torch.topk(scores, 2, dim=1, largest=False)
    best, second = low2[:, 0], low2[:, 1]
    ok = (best <= ratio * second) & (best <= max_error)
    return Matches(_arange32(scores.shape[0], scores.device),
                   idx2[:, 0].to(torch.int32), best, ok)


def associate_mutual_2d(scores: torch.Tensor, xy_a: torch.Tensor,
                        xy_b: torch.Tensor, max_distance: float,
                        valid_a=None, valid_b=None,
                        max_error: float = INF) -> Matches:
    """Mutual nearest neighbour with a 2D image-distance gate
    (AssociateDescription2D / AssociateMaxDistanceNaive analog): pairs
    farther apart than ``max_distance`` pixels are never matched.  The gate
    folds into the score matrix as a mask."""
    d2 = torch.sum((xy_a[:, None, :] - xy_b[None, :, :]) ** 2,
                   -1).to(torch.float32)
    limit = float(np.float32(max_distance) ** 2)     # squared in float32
    gated = torch.where(d2 <= limit, scores.to(torch.float32), _big())
    return associate_mutual(gated, valid_a, valid_b, max_error=max_error)


def associate_mutual_tiled(desc_a: torch.Tensor, desc_b: torch.Tensor,
                           tile: int = 2048,
                           valid_a: torch.Tensor | None = None,
                           valid_b: torch.Tensor | None = None,
                           max_error: float = INF) -> Matches:
    """Mutual-nearest-neighbour association WITHOUT the [Na, Nb] score
    matrix: association at scale (AssociateNearestNeighbor's role).

    The destination set is processed in ``tile``-column blocks: each step
    computes one [Na, tile] squared-Euclidean block and folds it into the
    running row minimum; a column's minimum is complete within its block.
    Peak memory is O(Na * tile) instead of O(Na * Nb).  Results equal
    ``associate_mutual(score_euclidean_sq(a, b))``."""
    na, d = desc_a.shape
    nb = desc_b.shape[0]
    dev = desc_a.device
    big = _big()
    a = desc_a.to(torch.float32)
    a2 = torch.sum(a * a, dim=1)
    pad = (-nb) % tile
    b = desc_b.to(torch.float32)
    vb = (torch.ones(nb, dtype=torch.bool, device=dev) if valid_b is None
          else valid_b)
    if pad:
        b = torch.cat([b, torch.zeros((pad, d), dtype=torch.float32,
                                      device=dev)])
        vb = torch.cat([vb, torch.zeros(pad, dtype=torch.bool, device=dev)])
    va = (torch.ones(na, dtype=torch.bool, device=dev) if valid_a is None
          else valid_a)

    row_min = torch.full((na,), big, dtype=torch.float32, device=dev)
    best_j = torch.zeros(na, dtype=torch.int64, device=dev)
    col_arg = []
    for t in range(b.shape[0] // tile):
        bt = b[t * tile:(t + 1) * tile]
        vbt = vb[t * tile:(t + 1) * tile]
        s = (a2[:, None] + torch.sum(bt * bt, dim=1)[None, :]
             - 2.0 * (a @ bt.T))
        s = torch.clamp(s, min=0.0)
        s = torch.where(va[:, None] & vbt[None, :], s, big)
        tmin, targ = torch.min(s, dim=1)
        upd = tmin < row_min
        row_min = torch.where(upd, tmin, row_min)
        best_j = torch.where(upd, targ + t * tile, best_j)
        col_arg.append(torch.argmin(s, dim=0))
    best_i = torch.cat(col_arg)[:nb]                 # [Nb]
    mutual = best_i[best_j] == torch.arange(na, device=dev)
    ok = mutual & (row_min <= max_error) & (row_min < big) & va
    return Matches(_arange32(na, dev), best_j.to(torch.int32), row_min, ok)


def associate_three_by_pairs(desc1: torch.Tensor, desc2: torch.Tensor,
                             desc3: torch.Tensor, score=score_euclidean_sq,
                             max_error: float = INF,
                             valid1=None, valid2=None, valid3=None):
    """Three-view association by composing pairwise matches
    (AssociateThreeByPairs.java analog).

    Associates 1<->2 and 2<->3 (mutual), composes i -> j -> k, then
    verifies each surviving triple with a direct 1<->3 association.
    Returns (idx1, idx2, idx3, valid) of capacity N1."""
    m12 = associate_mutual(score(desc1, desc2), valid1, valid2,
                           max_error=max_error)
    m23 = associate_mutual(score(desc2, desc3), valid2, valid3,
                           max_error=max_error)
    m13 = associate_mutual(score(desc1, desc3), valid1, valid3,
                           max_error=max_error)
    j = m12.dst                                     # [N1] 1 -> 2
    k = m23.dst[j.long()]                           # [N1] 1 -> 3 via 2
    chain_ok = m12.valid & m23.valid[j.long()]
    closure = m13.valid & (m13.dst == k)            # direct 1 -> 3 agrees
    return (_arange32(desc1.shape[0], desc1.device), j, k,
            chain_ok & closure)


def associate_nearest_neighbor_kdtree(desc_a, desc_b, max_error: float = INF,
                                      mutual: bool = True, eps: float = 0.0,
                                      device=None) -> Matches:
    """Host-side (approximate) KD-tree association
    (AssociateNearestNeighbor.java API parity), backed by scipy's cKDTree.

    The descriptors are copied to the host and the matches returned on
    ``desc_a``'s device, or for numpy descriptors on ``device`` (default the
    card); association at scale on the card is :func:`associate_mutual_tiled`.
    ``eps`` > 0 allows approximate neighbours.  Scores are squared
    Euclidean, as on the matrix paths."""
    from scipy.spatial import cKDTree

    dev = (desc_a.device if isinstance(desc_a, torch.Tensor)
           else resolve_device(device))
    host = lambda x: (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x)).astype(np.float64)
    a, b = host(desc_a), host(desc_b)
    dist, idx = cKDTree(b).query(a, k=1, eps=eps)
    valid = np.isfinite(dist)
    if mutual:
        _, back = cKDTree(a).query(b[idx], k=1, eps=eps)
        valid &= back == np.arange(len(a))
    d2 = dist ** 2
    valid &= d2 <= max_error
    return Matches(_arange32(len(a), dev),
                   torch.from_numpy(idx.astype(np.int32)).to(dev),
                   torch.from_numpy(d2.astype(np.float32)).to(dev),
                   torch.from_numpy(valid).to(dev))
