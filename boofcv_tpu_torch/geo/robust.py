"""Hypothesis-parallel RANSAC and LMedS (port of ``boofcv_tpu/geo/robust.py``,
whole).

Reference analog: ddogleg ``Ransac`` driven through boofcv-geo's
ModelGenerator / DistanceFromModel adapters.  All K sample sets are drawn
up front, every minimal problem is solved as one batch, and all K x N
residuals are scored at once; the best hypothesis is the argmax of inlier
count with the MSAC tie-break.

Random draws come from an explicit ``torch.Generator``.  It cannot
reproduce ``jax.random``'s stream, so every estimator here also takes the
[K, S] index sets directly (``idx``), which is how the tests feed both
packages the same hypotheses.

B independent problems go in one pass with a leading stream axis on every
tensor ([B, N, ...] points, [B, N] masks, [B, K, S] index sets) and one
generator per stream; every reduction is per stream.

On the card, ``ransac_pnp``'s Grunert bank (solve, score, select) is one
launch of ``kernels/pnp_bank``; CPU tensors, and every other estimator
here, take the generic :func:`ransac`.  :func:`bank_routes` counts which
route each ``ransac_pnp`` call took.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from boofcv_tpu_torch.kernels import pnp_bank
from boofcv_tpu_torch.utils.profiling import span

# ransac_pnp calls since import or the last reset_bank_routes, by the route
# their bank took: "kernel" (one pnp_bank launch) or "plain" (ransac)
_routes = {"kernel": 0, "plain": 0}


def bank_routes() -> dict:
    """``{"kernel": calls, "plain": calls}``: the ``ransac_pnp`` calls since
    import or :func:`reset_bank_routes` whose bank was one launch of
    ``kernels/pnp_bank`` (Grunert on a CUDA tensor) or the generic
    :func:`ransac` (a CPU tensor, or Finsterwalder)."""
    return dict(_routes)


def reset_bank_routes() -> None:
    """Set both counts of :func:`bank_routes` to 0."""
    _routes.update(kernel=0, plain=0)


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
    models, k_axis = _models(generator, points, solver, sample_size,
                             num_hypotheses, valid_mask,
                             solutions_per_sample, idx)
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
    pick = lambda a: _pick(a, best, k_axis)
    return RansacResult(tuple(pick(a) for a in models), pick(is_in),
                        pick(counts), pick(msac))


def _pick(a: torch.Tensor, best: torch.Tensor, axis: int) -> torch.Tensor:
    """``a`` at the one-element index ``best`` (keepdim) along ``axis``,
    that axis dropped: a selection that stays on the device."""
    at = best.reshape(best.shape + (1,) * (a.dim() - best.dim()))
    return torch.take_along_dim(a, at, dim=axis).squeeze(axis)


def _models(generator, points, solver, sample_size, num_hypotheses,
            valid_mask, solutions_per_sample, idx):
    """Draw (or take) the index sets, solve every sample, flatten the
    solutions: models with leading [..., K*M]."""
    if idx is None:
        streams = 0 if isinstance(generator, torch.Generator) else 1
        idx = sample_indices(generator, num_hypotheses, sample_size,
                             points[0].shape[streams], valid_mask)
    lead = idx.shape[:-2]
    models = solver(tuple(_take(a, idx) for a in points))  # leading [K, S]
    if solutions_per_sample > 1:
        models = tuple(
            a.reshape(lead + (num_hypotheses * solutions_per_sample,)
                      + a.shape[len(lead) + 2:]) for a in models)
    return models, len(lead)


def least_median_of_squares(generator, points, solver, scorer,
                            sample_size: int, num_hypotheses: int,
                            valid_mask=None, solutions_per_sample: int = 1,
                            inlier_fraction: float = 0.5,
                            idx=None) -> RansacResult:
    """LMedS (ddogleg LeastMedianOfSquares): the model whose
    ``inlier_fraction`` quantile of errors is least; inliers are errors
    within (2.5 sigma)^2 of the robust sigma estimate.  Arguments as
    :func:`ransac`; masked points score one above the stream's largest
    finite error."""
    models, k_axis = _models(generator, points, solver, sample_size,
                             num_hypotheses, valid_mask,
                             solutions_per_sample, idx)
    n = points[0].shape[k_axis]
    errors = scorer(models, points)                   # [..., K(*M), N]
    if valid_mask is not None:
        finite = torch.where(torch.isfinite(errors), errors, 0.0)
        big = torch.amax(finite, dim=(-2, -1), keepdim=True) + 1.0
        errors = torch.where(valid_mask[..., None, :], errors, big)
    errs_sorted = torch.sort(torch.where(torch.isfinite(errors), errors,
                                         1e30), dim=-1).values
    q = min(max(int(n * inlier_fraction), 0), n - 1)
    med = errs_sorted[..., q]                         # [..., K(*M)]
    best = torch.argmin(med, dim=-1, keepdim=True)
    med_best = _pick(med, best, k_axis)
    sigma = 1.4826 * (1.0 + 5.0 / (n - sample_size)) * torch.sqrt(med_best)
    inliers = _pick(errors, best, k_axis) <= ((2.5 * sigma) ** 2)[..., None]
    return RansacResult(tuple(_pick(a, best, k_axis) for a in models),
                        inliers, torch.sum(inliers, dim=-1), med_best)


def _sampson_scorer(models, points):
    """[..., K*M, N] Sampson errors in float64 of F (or E) models, a model
    whose flag (if any) is off unusable."""
    from boofcv_tpu_torch.geo import epipolar
    F = models[0]
    q1, q2 = (p.to(torch.float64)[..., None, :, :] for p in points)
    err = epipolar.sampson_error(F, q1, q2)
    if len(models) > 1:
        err = torch.where(models[1][..., None], err, float("inf"))
    return err


def _masked(err, valid_mask):
    """NaN and masked points unusable (inf)."""
    err = torch.where(torch.isnan(err), float("inf"), err)
    if valid_mask is not None:
        vm = valid_mask.reshape(valid_mask.shape[:-1]
                                + (1,) * (err.dim() - valid_mask.dim())
                                + valid_mask.shape[-1:])
        err = torch.where(vm, err, float("inf"))
    return err


def ransac_fundamental(generator, p1, p2, num_hypotheses: int = 512,
                       inlier_threshold_px: float = 1.0, valid_mask=None,
                       refit_rounds: int = 2, idx=None) -> RansacResult:
    """Robust F: 7-point minimal sets (three solutions a sample) scored by
    the Sampson distance (FactoryMultiViewRobust.fundamentalRansac:273),
    then ``refit_rounds`` weighted 8-point refits on the inlier set.
    p1, p2 [..., N, 2] pixels; the model is (F [..., 3, 3], True)."""
    from boofcv_tpu_torch.geo import epipolar

    def solver(sample):
        F3, real = epipolar.fundamental_7pt(*sample)
        eye = torch.eye(3, dtype=F3.dtype, device=F3.device)
        return torch.where(real[..., None, None], F3, eye), real

    thr = inlier_threshold_px ** 2
    res = ransac(generator, (p1, p2), solver, _sampson_scorer,
                 sample_size=7, num_hypotheses=num_hypotheses,
                 inlier_threshold=thr, valid_mask=valid_mask,
                 solutions_per_sample=3, idx=idx)
    F, _ = res.model
    inliers = res.inliers
    p164, p264 = p1.to(torch.float64), p2.to(torch.float64)
    err = _masked(epipolar.sampson_error(F, p164, p264), valid_mask)
    for _ in range(refit_rounds):
        F = epipolar.fundamental_8pt(p164, p264, weights=inliers)
        err = _masked(epipolar.sampson_error(F, p164, p264), valid_mask)
        inliers = err <= thr
    msac = torch.sum(torch.clamp(err, max=thr), dim=-1)
    flag = torch.ones(F.shape[:-2], dtype=torch.bool, device=F.device)
    return RansacResult((F, flag), inliers, torch.sum(inliers, dim=-1), msac)


def ransac_essential(generator, p1n, p2n, num_hypotheses: int = 512,
                     inlier_threshold: float = 1e-3, valid_mask=None,
                     refit_rounds: int = 3, solver_name: str = "nister5",
                     idx=None) -> RansacResult:
    """Robust E from normalized coordinates: Nister 5-point samples (ten
    solutions a sample; ``solver_name="nister5"``) or 8-point samples
    (``"8pt"``), Sampson scoring, then two chains of weighted 8-point
    refits (a tight gate, and a loose gate annealed down); the candidate
    with the most inliers wins, ties going to the later one.  The model is
    E [..., 3, 3]."""
    from boofcv_tpu_torch.geo import epipolar

    if solver_name == "nister5":
        # invalid solutions are NaN: their errors map to inf in ransac()
        res = ransac(generator, (p1n, p2n),
                     lambda s: (epipolar.essential_nister5(*s)[0],),
                     _sampson_scorer, sample_size=5,
                     num_hypotheses=num_hypotheses,
                     inlier_threshold=inlier_threshold,
                     valid_mask=valid_mask, solutions_per_sample=10, idx=idx)
    elif solver_name == "8pt":
        res = ransac(generator, (p1n, p2n),
                     lambda s: (epipolar.essential_8pt(*s),),
                     _sampson_scorer, sample_size=8,
                     num_hypotheses=num_hypotheses,
                     inlier_threshold=inlier_threshold,
                     valid_mask=valid_mask, idx=idx)
    else:
        raise ValueError(f"solver_name is 'nister5' or '8pt', not "
                         f"{solver_name!r}")
    p164, p264 = p1n.to(torch.float64), p2n.to(torch.float64)

    def score(E):
        lead = E.dim() - 2 - (p164.dim() - 2)      # candidate axes of E
        q1 = p164.reshape(p164.shape[:-2] + (1,) * lead + p164.shape[-2:])
        q2 = p264.reshape(q1.shape)
        return _masked(epipolar.sampson_error(E, q1, q2), valid_mask)

    thr = inlier_threshold
    rounds = max(refit_rounds, 2)
    E0 = res.model[0]
    candidates = [E0]
    for boot, gates in (
            (thr, [thr] * rounds),                               # tight
            (thr * 10.0 ** rounds,
             [thr * 10.0 ** (rounds - 1 - r) for r in range(rounds)])):
        inliers = score(E0) <= boot
        for g in gates:
            E = epipolar.essential_8pt(p164, p264, weights=inliers)
            inliers = score(E) <= g
            candidates.append(E)
    Es = torch.stack(candidates, dim=-3)               # [..., C, 3, 3]
    errs = score(Es)                                   # [..., C, N]
    counts = torch.sum(errs <= thr, dim=-1)
    # most inliers; ties to the latest candidate (the refit over the full
    # consensus set), never to the raw model on a marginally better MSAC
    n_cand = len(candidates)
    order = counts * (n_cand + 1) + torch.arange(n_cand, device=Es.device)
    best = torch.argmax(order, dim=-1, keepdim=True)
    k_axis = Es.dim() - 3
    E = _pick(Es, best, k_axis)
    err = _pick(errs, best, k_axis)
    msac = _pick(torch.sum(torch.clamp(errs, max=thr), dim=-1), best, k_axis)
    inliers = err <= thr
    return RansacResult(E, inliers, torch.sum(inliers, dim=-1), msac)


def ransac_homography(generator, p1, p2, num_hypotheses: int = 512,
                      inlier_threshold_px: float = 2.0, valid_mask=None,
                      idx=None) -> RansacResult:
    """Robust H: 4-point DLT samples scored by the forward transfer error
    in float64.  The model is H [..., 3, 3]."""
    from boofcv_tpu_torch.geo import epipolar

    def scorer(models, points):
        q1, q2 = (p.to(torch.float64)[..., None, :, :] for p in points)
        return epipolar.homography_transfer_error(models[0], q1, q2)

    res = ransac(generator, (p1, p2),
                 lambda s: (epipolar.homography_dlt(*s),), scorer,
                 sample_size=4, num_hypotheses=num_hypotheses,
                 inlier_threshold=inlier_threshold_px ** 2,
                 valid_mask=valid_mask, idx=idx)
    return res._replace(model=res.model[0])


def ransac_pnp(generator: Optional[torch.Generator], world: torch.Tensor,
               obs: torch.Tensor, num_hypotheses: int = 256,
               inlier_threshold: float = 1e-3, valid_mask=None,
               refine_iterations: int = 10, p3p: str = "grunert",
               polish_iterations: int = 0, idx=None):
    """Robust camera pose from 2D/3D: batched P3P hypotheses ("grunert",
    the quartic, or "finsterwalder", the cubic) and K x N scoring in
    float32, then a weighted GN refine on the inliers (float32 loop,
    float64 re-orthogonalisation).

    obs in normalized image coords.  Returns (RansacResult, (R, t)).  B
    streams: world [B, N, 3], obs [B, N, 2], valid_mask [B, N], a sequence
    of B generators (or idx [B, K, 3]); every result gains the [B] axis.
    On a CUDA tensor the Grunert bank (solve, score, select) is one launch
    of ``kernels/pnp_bank`` whatever B is; a CPU tensor, or
    Finsterwalder, takes the generic :func:`ransac`."""
    from boofcv_tpu_torch.geo import pnp

    if p3p not in ("grunert", "finsterwalder"):
        raise ValueError(f"p3p is 'grunert' or 'finsterwalder', not {p3p!r}")

    with span("ransac"):
        if p3p == "grunert" and world.is_cuda:
            result = _kernel_bank(generator, world, obs, num_hypotheses,
                                  inlier_threshold, valid_mask, idx)
            _routes["kernel"] += 1
        else:
            result = _plain_bank(generator, world, obs, num_hypotheses,
                                 inlier_threshold, valid_mask, p3p, idx)
            _routes["plain"] += 1
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


def _plain_bank(generator, world, obs, num_hypotheses: int,
                inlier_threshold: float, valid_mask, p3p: str,
                idx) -> RansacResult:
    """``ransac_pnp``'s bank on the generic :func:`ransac`: P3P (float32,
    four solutions a sample) and K x N float32 reprojection scoring.  The
    plain version of ``kernels/pnp_bank`` for Grunert; any device."""
    from boofcv_tpu_torch.geo import pnp

    minimal = {"grunert": pnp.p3p_grunert,
               "finsterwalder": pnp.p3p_finsterwalder}[p3p]

    def solver(sample):
        w, o = sample
        return minimal(w, o, dtype=torch.float32)

    def scorer(models, points):
        R, t, ok = models
        w, o = points
        err = pnp.reprojection_error_sq(
            R.to(torch.float32), t.to(torch.float32),
            w.to(torch.float32)[..., None, :, :],
            o.to(torch.float32)[..., None, :, :])
        return torch.where(ok[..., None], err, float("inf"))

    return ransac(generator, (world, obs), solver, scorer, sample_size=3,
                  num_hypotheses=num_hypotheses,
                  inlier_threshold=inlier_threshold, valid_mask=valid_mask,
                  solutions_per_sample=4, idx=idx)


def _kernel_bank(generator, world, obs, num_hypotheses: int,
                 inlier_threshold: float, valid_mask, idx) -> RansacResult:
    """``ransac_pnp``'s Grunert bank on the card: the index sets drawn as
    :func:`ransac` draws them (or the caller's), then one launch of
    ``kernels/pnp_bank`` for every stream.  Inputs are read as the plain
    route reads them: real dtypes other than float32 and float64 as
    float32, a mask broadcast to the points.  A caller's index sets are
    checked where that reads nothing back from the card: on the host, an
    index outside [0, N) is refused; on the card, it makes its sample
    unusable in the kernel."""
    n = world.shape[-2]
    if idx is None:
        idx = sample_indices(generator, num_hypotheses, 3, n, valid_mask)
    else:
        idx = torch.as_tensor(idx)
        if idx.shape[-2:] != (num_hypotheses, 3):
            raise ValueError(f"idx must be [..., {num_hypotheses}, 3] for "
                             f"{num_hypotheses} hypotheses, got "
                             f"{tuple(idx.shape)}")
        if not idx.is_cuda:
            pnp_bank.check_indices(idx, n)
    idx = idx.to(device=world.device, dtype=torch.int64).contiguous()
    world, obs = (x if x.dtype in (torch.float32, torch.float64)
                  else x.to(torch.float32) for x in (world, obs))
    if valid_mask is not None and valid_mask.shape != world.shape[:-1]:
        valid_mask = valid_mask.expand(world.shape[:-1])
    with span("ransac.bank"):
        model, inliers, count, msac = pnp_bank.pnp_bank_cuda(
            world.contiguous(), obs.contiguous(), idx,
            None if valid_mask is None else valid_mask.contiguous(),
            inlier_threshold)
    return RansacResult(model, inliers, count, msac)
