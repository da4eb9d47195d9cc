"""Hypothesis-bank-sharded RANSAC over a mesh (port of
``boofcv_tpu/dist/ransac_sharded.py``).

No reference analog (ddogleg's Ransac is single-threaded).  The K
hypotheses are split over the mesh's ranks: every rank solves and scores
its own bank against the whole (replicated) point set, then one all-gather
of the ranks' winners picks the global one: the traffic is O(model + N),
never O(N x K).
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch.dist.mesh import all_gather, check_device, shard_index
from boofcv_tpu_torch.geo import pnp, robust


def ransac_pnp_sharded(mesh, generator, world, obs,
                       num_hypotheses_per_device: int = 64,
                       inlier_threshold: float = 1e-3,
                       refine_iterations: int = 10, idx=None):
    """Distributed ``robust.ransac_pnp``: each rank runs its own bank of
    ``num_hypotheses_per_device`` P3P (Grunert, float32) hypotheses, the
    winner is the most inliers with the MSAC tie-break over every rank's
    winner, and the float64 GN refine runs replicated on its inliers.

    Every rank passes the same ``generator`` (at the same position): the
    banks of all ranks are drawn from it in rank order and each rank keeps
    its own, so the generator advances alike everywhere.  ``idx``
    [n, K, 3] (one bank a rank, in mesh order) replaces the draws.
    Returns (RansacResult, (R, t)) as ``robust.ransac_pnp`` does, with an
    effective K of ``num_hypotheses_per_device`` x the mesh's size.
    """
    check_device(mesh, world.device)
    rank, n = shard_index(mesh)
    k = num_hypotheses_per_device
    if idx is None:
        bank = robust.sample_indices(generator, n * k, 3,
                                     world.shape[0])[rank * k:(rank + 1) * k]
    else:
        bank = torch.as_tensor(idx, device=world.device)[rank].long()
    # the bank alone: no refine of this rank's winner
    res, _ = robust.ransac_pnp(None, world, obs, num_hypotheses=k,
                               inlier_threshold=inlier_threshold,
                               refine_iterations=0, idx=bank)
    R, t, _ = res.model
    row = torch.cat([a.reshape(-1).to(torch.float64) for a in (
        R, t, res.num_inliers, res.best_error, res.inliers)])
    won = all_gather(row[None], mesh)                  # [n, 14 + N]
    Rs = won[:, :9].reshape(-1, 3, 3).to(R.dtype)
    ts = won[:, 9:12].to(t.dtype)
    counts = won[:, 12].to(res.num_inliers.dtype)
    errs = won[:, 13].to(res.best_error.dtype)
    inliers = won[:, 14:] > 0.5
    # global winner: most inliers, least MSAC score (no host sync)
    order = counts.to(torch.float64) - (errs / (errs.max() + 1.0)).to(
        torch.float64)
    best = torch.argmax(order, dim=0, keepdim=True)
    pick = lambda a: robust._pick(a, best, 0)
    Rb, tb, inl = pick(Rs), pick(ts), pick(inliers)
    w64 = torch.where(inl[:, None], world.to(torch.float64), 1.0)
    o64 = torch.where(inl[:, None], obs.to(torch.float64), 0.0)
    Rr, tr = pnp.gauss_newton_pose(Rb, tb, w64, o64,
                                   weights=inl.to(torch.float64),
                                   iterations=refine_iterations,
                                   damping=1e-9, polish_iterations=0)
    result = robust.RansacResult(
        model=(Rb, tb, torch.ones((), dtype=torch.bool, device=Rb.device)),
        inliers=inl, num_inliers=pick(counts), best_error=pick(errs))
    return result, (Rr, tr)
