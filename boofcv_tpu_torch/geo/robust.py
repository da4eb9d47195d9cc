"""Hypothesis-parallel RANSAC (port of ``boofcv_tpu/geo/robust.py``:
``sample_indices``, ``ransac``, ``ransac_pnp``).

Reference analog: ddogleg ``Ransac`` driven through boofcv-geo's
ModelGenerator / DistanceFromModel adapters.  All K sample sets are drawn
up front, every minimal problem is solved as one batch, and all K x N
residuals are scored at once; the best hypothesis is the argmax of inlier
count with the MSAC tie-break.

Random draws come from an explicit ``torch.Generator``.  It cannot
reproduce ``jax.random``'s stream, so ``ransac`` and ``ransac_pnp`` also
take the [K, S] index sets directly (``idx``), which is how the tests feed
both packages the same hypotheses.

B independent problems go in one pass with a leading stream axis on every
tensor ([B, N, ...] points, [B, N] masks, [B, K, S] index sets) and one
generator per stream; every reduction is per stream.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class RansacResult(NamedTuple):
    model: object              # best model (tuple of tensors)
    inliers: torch.Tensor      # [..., N] bool
    num_inliers: torch.Tensor  # [...] int
    best_error: torch.Tensor   # [...]: MSAC score of the best model


def sample_indices(generator, num_hypotheses: int, sample_size: int, n: int,
                   valid_mask: Optional[torch.Tensor] = None):
    """[K, S] index sets without repeats inside a set: uniform scores, then
    S argmax passes with one-hot knock-outs.  Invalid entries are never
    chosen (assumes >= S valid).

    ``generator`` is one ``torch.Generator``, or a sequence of B of them
    for [B, K, S] sets (``valid_mask`` [B, N]): stream b's scores come from
    generator b alone, so it draws what a single-stream call with that
    generator draws."""
    draw = lambda g: torch.rand((num_hypotheses, n), generator=g,
                                device=g.device)
    if isinstance(generator, torch.Generator):
        scores = draw(generator)
    else:
        scores = torch.stack([draw(g) for g in generator])
    if valid_mask is not None:
        scores = torch.where(valid_mask[..., None, :], scores, -1.0)
    cols = torch.arange(n, device=scores.device)
    picks = []
    for _ in range(sample_size):
        i = torch.argmax(scores, dim=-1)
        picks.append(i)
        scores = torch.where(cols == i[..., None], -2.0, scores)
    return torch.stack(picks, dim=-1)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a [N, ...] at idx [K, S] -> [K, S, ...]; with a stream axis,
    a [B, N, ...] at idx [B, K, S] -> [B, K, S, ...], each stream from its
    own rows."""
    if idx.dim() == 2:
        return a[idx]
    stream = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
    return a[stream, idx]


def ransac(generator: Optional[torch.Generator], points, solver: Callable,
           scorer: Callable, sample_size: int, num_hypotheses: int,
           inlier_threshold: float, valid_mask=None,
           solutions_per_sample: int = 1, idx=None) -> RansacResult:
    """Generic hypothesis-parallel RANSAC.

    points: tuple of [N, ...] tensors.  solver(sampled) takes the tuple
    with leading [K, S] axes and returns a tuple model with leading [K]
    (or [K, M] for M solutions per sample).  scorer(models, points) returns
    [K*M, N] errors (inf = unusable).  ``idx`` [K, S] replaces the draw
    from ``generator``.  With a stream axis [B] in front of all of these,
    ``generator`` is a sequence of B generators and every stream picks its
    own winner."""
    if idx is None:
        streams = 0 if isinstance(generator, torch.Generator) else 1
        idx = sample_indices(generator, num_hypotheses, sample_size,
                             points[0].shape[streams], valid_mask)
    lead = idx.shape[:-2]
    sampled = tuple(_take(a, idx) for a in points)    # leading [K, S]
    models = solver(sampled)
    if solutions_per_sample > 1:
        models = tuple(
            a.reshape(lead + (num_hypotheses * solutions_per_sample,)
                      + a.shape[len(lead) + 2:]) for a in models)
    errors = scorer(models, points)                   # [K(*M), N]
    errors = torch.where(torch.isnan(errors), float("inf"), errors)
    if valid_mask is not None:
        errors = torch.where(valid_mask[..., None, :], errors, float("inf"))
    is_in = errors <= inlier_threshold
    counts = torch.sum(is_in, dim=-1)
    msac = torch.sum(torch.clamp(errors, max=inlier_threshold), dim=-1)
    # primary: max inliers; tie-break: min MSAC (float64, as the reference),
    # scaled by the stream's own largest score
    worst = torch.amax(msac, dim=-1, keepdim=True)
    order = counts.to(torch.float64) - (msac / (worst + 1.0)).to(
        torch.float64)
    # a one-element index along the hypothesis axis keeps the selection on
    # the device (indexing with a 0-dim tensor reads it back to the host)
    best = torch.argmax(order, dim=-1, keepdim=True)
    k_axis = len(lead)

    def pick(a):
        at = best.reshape(best.shape + (1,) * (a.dim() - best.dim()))
        return torch.take_along_dim(a, at, dim=k_axis).squeeze(k_axis)

    return RansacResult(tuple(pick(a) for a in models), pick(is_in),
                        pick(counts), pick(msac))


def ransac_pnp(generator: Optional[torch.Generator], world: torch.Tensor,
               obs: torch.Tensor, num_hypotheses: int = 256,
               inlier_threshold: float = 1e-3, valid_mask=None,
               refine_iterations: int = 10, polish_iterations: int = 0,
               idx=None):
    """Robust camera pose from 2D/3D: batched P3P-Grunert hypotheses and
    K x N scoring in float32, then a weighted GN refine on the inliers
    (float32 loop, float64 re-orthogonalisation).

    obs in normalized image coords.  Returns (RansacResult, (R, t)).  B
    streams: world [B, N, 3], obs [B, N, 2], valid_mask [B, N], a sequence
    of B generators (or idx [B, K, 3]); every result gains the [B] axis."""
    from boofcv_tpu_torch.geo import pnp

    def solver(sample):
        w, o = sample
        return pnp.p3p_grunert(w, o, dtype=torch.float32)

    def scorer(models, points):
        R, t, ok = models
        w, o = points
        err = pnp.reprojection_error_sq(
            R.to(torch.float32), t.to(torch.float32),
            w.to(torch.float32)[..., None, :, :],
            o.to(torch.float32)[..., None, :, :])
        return torch.where(ok[..., None], err, float("inf"))

    result = ransac(generator, (world, obs), solver, scorer, sample_size=3,
                    num_hypotheses=num_hypotheses,
                    inlier_threshold=inlier_threshold,
                    valid_mask=valid_mask, solutions_per_sample=4, idx=idx)
    R, t, _ = result.model
    # masked rows must be finite: inf * 0 = NaN would poison the normal
    # equations, so they are replaced rather than only zero-weighted
    mask = result.inliers
    w64 = torch.where(mask[..., None], world.to(torch.float64), 1.0)
    o64 = torch.where(mask[..., None], obs.to(torch.float64), 0.0)
    Rr, tr = pnp.gauss_newton_pose(R, t, w64, o64,
                                   weights=mask.to(torch.float64),
                                   iterations=refine_iterations,
                                   damping=1e-9,
                                   polish_iterations=polish_iterations)
    return result, (Rr, tr)
