"""Bundle adjustment: block-sparse Levenberg-Marquardt with Schur complement
(port of ``boofcv_tpu/geo/ba.py``, the single-device path).

Reference analog: boofcv-geo abst/geo/bundle/ + alg/geo/bundle/
(SceneStructureMetric / SceneObservations, BundleAdjustmentSchur driving
ddogleg's UnconstrainedLeastSquaresSchur).  This module owns the solver.

Layout, as in the reference: observations live in a dense ``[P, L]`` table
(view index, pixel and valid mask per slot); per-point 3x3 blocks are
batch-inverted; the reduced camera system ``S`` (``[6V, 6V]`` dense) is
assembled from the observation pairs of each point and solved with a
Cholesky factorisation; the LM loop runs a fixed number of iterations with
branchless accept/reject.

What differs from the reference, and why:

* **One assembly.**  Every sum over views (the Gauss-Newton diagonal, Hvv,
  the gradients, the Schur fill-in over view pairs) is a segmented sum over
  observations sorted by view, or observation pairs sorted by view pair.
  ``obs_view`` is constant over a solve, so the order is fixed once
  (:func:`_view_order`) and every iteration adds the same terms in the same
  order: two solves of one problem give the same bits.  An ``index_add_``
  on the card adds with atomics in an order that changes from launch to
  launch, and LM's accept/reject turns one different ulp into another
  trajectory.
* **No host sync in the loop.**  ``cholesky_ex`` never raises: where it
  reports a matrix that is not positive definite the step is poisoned with
  NaN, the candidate's cost is NaN, and the step is rejected as in the
  reference (whose Cholesky returns NaN there).  ``lam``, the accept flag
  and the costs stay tensors.
* The small contractions (inner dimension 2, 3 or 6) are broadcast
  multiply-and-sum, not batched matmul calls.

Precision follows the reference's code: with ``mixed_precision`` (default
for float32 problems) the 3x3 point-block inverses run in float64, the
``[6V, 6V]`` Cholesky in the problem's float32, followed by two rounds of
iterative refinement with the residual in float64; costs accumulate in
float64.

Camera models: 'normalized' (observations are K^-1 pixels, no intrinsics),
'snavely' (BAL convention: f, k1, k2 per view, z<0 looks forward) and
'pinhole_f' (+z pinhole with a free focal length).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.geo import se3
from boofcv_tpu_torch.geo.smalllinalg import inv3


class BAProblem(NamedTuple):
    """Scene structure + observations (SceneStructureMetric/SceneObservations).

    R: [V, 3, 3], t: [V, 3] — world->view transforms.
    intr: [V, K] per-view intrinsics (K=0 for 'normalized', 3 for 'snavely',
    1 for 'pinhole_f').
    points: [P, 3] world points.
    obs_xy: [P, L, 2]; obs_view: [P, L] int32; obs_valid: [P, L] bool.
    fixed_views: [V] bool — gauge-fixed views (pose updates zeroed).
    """
    R: torch.Tensor
    t: torch.Tensor
    intr: torch.Tensor
    points: torch.Tensor
    obs_xy: torch.Tensor
    obs_view: torch.Tensor
    obs_valid: torch.Tensor
    fixed_views: torch.Tensor
    model: str = "normalized"


_FLOAT_FIELDS = ("R", "t", "intr", "points", "obs_xy")


def _mv(A, x):
    """[..., i, j] x [..., j] -> [..., i]."""
    return (A * x[..., None, :]).sum(-1)


def _mm(A, B):
    """[..., i, j] x [..., j, k] -> [..., i, k]."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _mtm(A, B):
    """A^T B: [..., k, i], [..., k, j] -> [..., i, j]."""
    return (A[..., :, :, None] * B[..., :, None, :]).sum(-3)


def _scalar(x, dtype, device):
    """A number or 0-dim tensor as a 0-dim tensor of ``dtype`` (a number is
    written by a fill, not copied from the host)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.full((), float(x), dtype=dtype, device=device)


def _project(model: str, Xc, intr):
    """Camera-frame point -> 2D observation. Xc: [..., 3], intr: [..., K]."""
    if model not in ("normalized", "snavely", "pinhole_f"):
        raise ValueError(f"unknown camera model {model!r}")
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    if model == "normalized":
        return Xc[..., :2] / zs[..., None]
    if model == "snavely":
        # BAL: p = -X/X.z; r = 1 + k1|p|^2 + k2|p|^4; proj = f * r * p
        p = -Xc[..., :2] / zs[..., None]
        f, k1, k2 = intr[..., 0], intr[..., 1], intr[..., 2]
        r2 = torch.sum(p * p, dim=-1)
        distort = 1.0 + k1 * r2 + k2 * r2 * r2
        return (f * distort)[..., None] * p
    # pinhole_f: proj = f * X/z
    return intr[..., 0:1] * Xc[..., :2] / zs[..., None]


def n_intr(model: str) -> int:
    return {"normalized": 0, "snavely": 3, "pinhole_f": 1}[model]


def _camera_points(prob: BAProblem):
    """Per-observation rotation, camera-frame point and intrinsics."""
    view = prob.obs_view.long()
    R_o = prob.R[view]                                  # [P, L, 3, 3]
    Xc = _mv(R_o, prob.points[:, None, :]) + prob.t[view]
    return R_o, Xc, prob.intr[view]


def residuals(prob: BAProblem):
    """[P, L, 2] residuals (proj - obs), zeroed where invalid."""
    _, Xc, intr_o = _camera_points(prob)
    r = _project(prob.model, Xc, intr_o) - prob.obs_xy
    return torch.where(prob.obs_valid[..., None], r, 0.0)


def cost(prob: BAProblem):
    """0.5 * sum of squared residuals, accumulated in float64 (keeps LM's
    accept/reject reliable on the float32 path)."""
    r = residuals(prob).to(torch.float64)
    return 0.5 * torch.sum(r * r)


def _proj_jacobian(model: str, Xc, intr):
    """Analytic projection jacobians: dproj/dXc [..., 2, 3] and
    dproj/dintr [..., 2, K]."""
    if model not in ("normalized", "snavely", "pinhole_f"):
        raise ValueError(f"unknown camera model {model!r}")
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    iz = 1.0 / zs
    zero = torch.zeros_like(iz)
    # d(x/z, y/z)/dXc
    dn = torch.stack([
        torch.stack([iz, zero, -x * iz * iz], dim=-1),
        torch.stack([zero, iz, -y * iz * iz], dim=-1)], dim=-2)
    if model == "normalized":
        return dn, Xc.new_zeros(Xc.shape[:-1] + (2, 0))
    if model == "snavely":
        # p = -(x,y)/z; s = 1 + k1 r^2 + k2 r^4; proj = f s p
        p = -Xc[..., :2] * iz[..., None]
        f, k1, k2 = intr[..., 0], intr[..., 1], intr[..., 2]
        r2 = torch.sum(p * p, dim=-1)
        s = 1.0 + k1 * r2 + k2 * r2 * r2
        ds_dp = (2.0 * k1 + 4.0 * k2 * r2)[..., None] * p      # [..., 2]
        eye2 = torch.eye(2, dtype=Xc.dtype, device=Xc.device)
        dproj_dp = f[..., None, None] * (
            s[..., None, None] * eye2
            + p[..., :, None] * ds_dp[..., None, :])           # [..., 2, 2]
        A = _mm(dproj_dp, -dn)
        Ji = torch.stack([s[..., None] * p,
                          (f * r2)[..., None] * p,
                          (f * r2 * r2)[..., None] * p], dim=-1)  # [..., 2, 3]
        return A, Ji
    f = intr[..., 0]
    A = f[..., None, None] * dn
    Ji = torch.stack([x * iz, y * iz], dim=-1)[..., None]      # [..., 2, 1]
    return A, Ji


def _jacobians(prob: BAProblem):
    """Per-observation analytic jacobians at the current state.

    Local parameterization matches ``_apply_step``: pose perturbed on the
    left by ``exp_se3(xi)`` (xi = (w, v), rotation first), point by +dX,
    intrinsics by +dintr.  At xi=0: dXc/dw = -hat(Xc), dXc/dv = I,
    dXc/dX = R.

    Returns Jv [P, L, 2, D] (D = 6 + n_intr), Jp [P, L, 2, 3], r [P, L, 2].
    """
    R_o, Xc, intr_o = _camera_points(prob)
    r = _project(prob.model, Xc, intr_o) - prob.obs_xy
    A, Ji = _proj_jacobian(prob.model, Xc, intr_o)   # [P,L,2,3], [P,L,2,k]
    Jrot = -_mm(A, se3.hat(Xc))
    Jv = torch.cat([Jrot, A, Ji], dim=-1)            # [P, L, 2, 6+k]
    Jp = _mm(A, R_o)                                 # [P, L, 2, 3]
    valid = prob.obs_valid[..., None, None]
    Jv = torch.where(valid, Jv, 0.0)
    Jp = torch.where(valid, Jp, 0.0)
    r = torch.where(prob.obs_valid[..., None], r, 0.0)
    return Jv, Jp, r


class ViewOrder(NamedTuple):
    """The fixed order in which a solve adds over views: observations
    sorted by view, observation pairs of a point sorted by view pair.
    Invalid slots come after the last run and are added nowhere."""
    perm: torch.Tensor           # [P*L] observations, sorted by view
    offsets: torch.Tensor        # [V + 1] where each view's run starts
    pair_perm: torch.Tensor      # [P*L*L] pairs (l, m), sorted by v_l*V + v_m
    pair_offsets: torch.Tensor   # [V*V + 1]


def _segments(keys, num: int):
    """Stable order of ``keys`` [N] and the start of each run of a value in
    [0, num); ``offsets[num]`` is where the keys >= num begin.  No shape
    depends on the data, so nothing is read back to the host."""
    order = torch.argsort(keys, stable=True)
    bounds = torch.arange(num + 1, dtype=keys.dtype, device=keys.device)
    return order, torch.searchsorted(keys[order], bounds)


def _view_order(obs_view, num_views: int, obs_valid=None) -> ViewOrder:
    """Built once per solve: ``obs_view`` and ``obs_valid`` do not change in
    it.  An invalid slot carries view 0 and zero jacobians; with
    ``obs_valid`` given it is left out of view 0's run (and its pairs out of
    theirs) instead of being added there as zeros: thousands of them would
    make those few runs far longer than any other, and a run is added by
    one thread."""
    view = obs_view.long()
    pair = view[:, :, None] * num_views + view[:, None, :]   # [P, L, L]
    if obs_valid is not None:
        view = torch.where(obs_valid, view, num_views)
        pair = torch.where(obs_valid[:, :, None] & obs_valid[:, None, :],
                           pair, num_views * num_views)
    perm, offsets = _segments(view.reshape(-1), num_views)
    pair_perm, pair_offsets = _segments(pair.reshape(-1),
                                        num_views * num_views)
    return ViewOrder(perm, offsets, pair_perm, pair_offsets)


def _segment_sum(x, perm, offsets):
    """Sum rows of ``x`` [N, ...] over the runs of ``perm``: each run is
    added front to back, so the result is the same bits on every call.
    Rows past the last offset are not read."""
    return torch.segment_reduce(x[perm], "sum", offsets=offsets, axis=0,
                                unsafe=True)


def _sum_by_view(x, order: ViewOrder):
    """[P, L, ...] per-observation terms -> [V, ...] sums."""
    return _segment_sum(x.reshape((-1,) + x.shape[2:]), order.perm,
                        order.offsets)


def _gn_view_diag(Jv, order: ViewOrder):
    """[V, D] Gauss-Newton view diagonal: the squares of each observation's
    view columns, summed by view in ``order``."""
    return _sum_by_view(torch.sum(Jv * Jv, dim=2), order)


def hvv_diag_chunked(obs_view, Jv, num_views: int, chunk: int = 8192):
    """[V, D] Gauss-Newton view diagonal, ``chunk`` points at a time: each
    chunk's terms summed by view in the chunk's own order, the chunks'
    sums added in chunk order.  (The reference chunks a one-hot product to
    bound its [chunk, L, V] temporary; here a chunk bounds the sorted
    [chunk * L, D] copy of the terms.)"""
    out = Jv.new_zeros((num_views, Jv.shape[-1]))
    for lo in range(0, obs_view.shape[0], chunk):
        order = _view_order(obs_view[lo:lo + chunk], num_views)
        out = out + _gn_view_diag(Jv[lo:lo + chunk], order)
    return out


def _scale_jacobians(obs_view, Jv, Jp, num_views: int, hvv_diag=None,
                     order: ViewOrder | None = None):
    """Jacobi (Marquardt) column scaling: divide each parameter column by
    sqrt of its Gauss-Newton diagonal so Hpp / Hvv have unit diagonals.

    Returns (Jv_scaled, Jp_scaled, s_v [V, D], s_p [P, 3]); steps computed
    in the scaled space are unscaled by dividing by s_v / s_p again.

    ``hvv_diag``: a pre-reduced [V, D] diagonal to scale by instead.
    """
    if hvv_diag is None:
        if order is None:
            order = _view_order(obs_view, num_views)
        hvv_diag = _gn_view_diag(Jv, order)
    s_v = torch.clamp(torch.sqrt(hvv_diag), min=1e-6)
    s_p = torch.clamp(torch.sqrt(torch.sum(Jp * Jp, dim=(1, 2))), min=1e-6)
    Jv_s = Jv / s_v[obs_view.long()][:, :, None, :]
    Jp_s = Jp / s_p[:, None, None, :]
    return Jv_s, Jp_s, s_v, s_p


def _point_blocks(Jv, Jp, r, lam, solve_dtype):
    """Per-point Schur building blocks.

    Jv [P, L, 2, D], Jp [P, L, 2, 3], r [P, L, 2] ->
    (Hpp_inv [P, 3, 3], W [P, L, 3, D], gp [P, 3], gv_obs [P, L, D],
     Hvv_obs [P, L, D, D], Y [P, L, 3, D], corr [P, L, D]).
    """
    Hpp = _mtm(Jp, Jp).sum(1)
    W = _mtm(Jp, Jv)
    gp = -(Jp * r[..., None]).sum((1, 2))
    gv_obs = -(Jv * r[..., None]).sum(2)
    eyeP = torch.eye(3, dtype=solve_dtype, device=Jp.device)
    damp = _scalar(lam, solve_dtype, Jp.device) + 1e-12
    Hpp_inv = inv3(Hpp.to(solve_dtype) + damp * eyeP).to(W.dtype)
    Hvv_obs = _mtm(Jv, Jv)
    Y = _mm(Hpp_inv[:, None], W)
    hp = _mv(Hpp_inv, gp)
    corr = (W * hp[:, None, :, None]).sum(2)
    return Hpp_inv, W, gp, gv_obs, Hvv_obs, Y, corr


def _pair_products(W, Y):
    """W_l^T Y_m for every slot pair of a point: [P, L, 3, D] twice ->
    [P, L, L, D, D].  The three terms of the inner sum one after the other,
    so the largest temporary is the result itself."""
    Wl, Ym = W[:, :, None, :, :, None], Y[:, None, :, :, None, :]
    pair = Wl[..., 0, :, :] * Ym[..., 0, :, :]
    for i in (1, 2):
        pair.addcmul_(Wl[..., i, :, :], Ym[..., i, :, :])
    return pair


def _local_system(obs_view, Jv, Jp, r, lam, num_views: int,
                  solve_dtype=None, order: ViewOrder | None = None):
    """The reduced camera system of the points given.

    ``solve_dtype``: dtype of the 3x3 point-block inversions (the float32
    path passes float64: about 100 flops a point, and it removes the
    eps*cond(Hpp) error that otherwise poisons the whole Schur complement).

    Returns (S [V, V, D, D] incl. Hvv on the diagonal, gv_t [V, D],
    Hpp_inv [P, 3, 3], W [P, L, 3, D], gp [P, 3]).
    """
    V = num_views
    D = Jv.shape[-1]
    if solve_dtype is None:
        solve_dtype = Jp.dtype
    if order is None:
        order = _view_order(obs_view, V)
    Hpp_inv, W, gp, gv_obs, Hvv_obs, Y, corr = _point_blocks(
        Jv, Jp, r, lam, solve_dtype)
    Hvv = _sum_by_view(Hvv_obs, order)
    gv = _sum_by_view(gv_obs, order)
    # Schur fill-in: S[v_l, v_m] -= W_l^T Y_m over the slot pairs of each
    # point
    S = -_segment_sum(_pair_products(W, Y).reshape(-1, D, D), order.pair_perm,
                      order.pair_offsets).reshape(V, V, D, D)
    gv_t = gv - _sum_by_view(corr, order)
    ar = torch.arange(V, device=S.device)
    S[ar, ar] += Hvv
    return S, gv_t, Hpp_inv, W, gp


def _solve_reduced(S, gv_t, fixed_views, lam, solve_dtype=None,
                   refine_steps: int = 0):
    """Damp + gauge-fix the reduced system and solve.

    ``solve_dtype``: dtype of the Cholesky factor/solve of the [VD, VD]
    system.  ``refine_steps``: rounds of iterative refinement: factor once
    in S.dtype, then repeat x += solve(b - S x) with the residual computed
    in float64.  A matrix that is not positive definite gives a NaN step
    (no exception, nothing read back).  Returns delta_view [V, D].
    """
    V, _, D, _ = S.shape
    out_dtype = S.dtype
    if solve_dtype is not None and solve_dtype != S.dtype:
        S = S.to(solve_dtype)
        gv_t = gv_t.to(solve_dtype)
    lam = _scalar(lam, S.dtype, S.device)

    # gauge fixing: zero rows/cols of fixed views' POSE block only (the
    # intrinsics of a gauge-fixed view carry no gauge freedom and stay
    # free), identity on the frozen diagonal entries.  free is 0 or 1, so
    # damping the free diagonal after the masking gives the bits of
    # (S + lam I) masked
    pose_col = (torch.arange(D, device=S.device) < 6).to(S.dtype)
    frozen = (fixed_views.to(S.dtype)[:, None] * pose_col[None, :]).reshape(-1)
    free = 1.0 - frozen                                      # [V*D]
    Sd = S.permute(0, 2, 1, 3).reshape(V * D, V * D)
    Sd = Sd * free[:, None] * free[None, :]
    Sd.diagonal().add_(lam * free + frozen)
    gd = gv_t.reshape(V * D) * free

    # the factor is that of the symmetric part, as the reference's Cholesky
    # takes it (S is symmetric only up to rounding: Y = Hpp^-1 W); the
    # refinement's residual below uses Sd as assembled
    L_chol, info = torch.linalg.cholesky_ex((Sd + Sd.mT) * 0.5,
                                            check_errors=False)

    def chol_solve(b):
        y = torch.linalg.solve_triangular(L_chol, b[:, None], upper=False)
        return torch.linalg.solve_triangular(L_chol.mT, y, upper=True)[:, 0]

    x = chol_solve(gd)
    if refine_steps:
        Sd64 = Sd.to(torch.float64)
        gd64 = gd.to(torch.float64)
        for _ in range(refine_steps):
            res = gd64 - torch.mv(Sd64, x.to(torch.float64))
            x = x + chol_solve(res.to(Sd.dtype))
    x = torch.where(info > 0, float("nan"), x)
    return (x * free).reshape(V, D).to(out_dtype)


def _back_substitute(obs_view, Hpp_inv, W, gp, dv):
    """Point updates given the view step: dp = Hpp^-1 (gp - sum_l W dv)."""
    dv_obs = dv[obs_view.long()]                             # [P, L, D]
    corr_p = (W * dv_obs[:, :, None, :]).sum((1, 3))
    return _mv(Hpp_inv, gp - corr_p)


def _schur_solve(prob: BAProblem, Jv, Jp, r, lam, solve_dtype=None,
                 refine_steps: int = 0, order: ViewOrder | None = None):
    """One damped Schur-complement solve in the Jacobi-scaled parameter
    space (``lam`` is relative, Marquardt, damping there).  ``solve_dtype``
    applies to the 3x3 point-block inverses; the reduced system is factored
    in the working dtype with ``refine_steps`` rounds of refinement.
    Returns (delta_view [V, D], delta_point [P, 3])."""
    V = prob.R.shape[0]
    if order is None:
        order = _view_order(prob.obs_view, V, prob.obs_valid)
    Jv_s, Jp_s, s_v, s_p = _scale_jacobians(prob.obs_view, Jv, Jp, V,
                                            order=order)
    S, gv_t, Hpp_inv, W, gp = _local_system(
        prob.obs_view, Jv_s, Jp_s, r, lam, V, solve_dtype=solve_dtype,
        order=order)
    dv = _solve_reduced(S, gv_t, prob.fixed_views, lam,
                        refine_steps=refine_steps)
    dp = _back_substitute(prob.obs_view, Hpp_inv, W, gp, dv)
    return dv / s_v, dp / s_p


def _apply_step(prob: BAProblem, dv, dp):
    k = n_intr(prob.model)
    dR, dt = se3.exp_se3(dv[:, :6])
    Rn, tn = se3.compose(dR, dt, prob.R, prob.t)
    intr_n = prob.intr + dv[:, 6:6 + k] if k else prob.intr
    return prob._replace(R=Rn, t=tn, intr=intr_n, points=prob.points + dp)


_STATE_FIELDS = ("R", "t", "intr", "points")


@torch.no_grad()
def optimize(prob: BAProblem, iterations: int = 20, lam0: float = 1e-3,
             lam_up: float = 10.0, lam_down: float = 0.3,
             mixed_precision: bool | None = None):
    """LM-Schur bundle adjustment (BundleAdjustmentSchur.optimize analog).

    Fixed iteration count, branchless accept/reject, no host sync.  Returns
    (optimized problem, info dict: ``costs`` [iterations], ``initial_cost``
    and ``final_cost``, float64 tensors on the problem's device).

    Runs in the problem's own float dtype (``make_problem(dtype=...)``).
    On a float32 problem ``mixed_precision`` (default on) inverts the 3x3
    point blocks in float64 and refines the float32 Cholesky solve of the
    reduced system twice with a float64 residual.
    """
    dtype = prob.points.dtype
    if mixed_precision is None:
        mixed_precision = dtype == torch.float32
    cur = prob._replace(**{k: getattr(prob, k).to(dtype)
                           for k in _FLOAT_FIELDS})
    solve_dtype = torch.float64 if mixed_precision else None
    refine_steps = 2 if mixed_precision else 0
    order = _view_order(cur.obs_view, cur.R.shape[0], cur.obs_valid)
    lam = torch.full((), lam0, dtype=dtype, device=cur.points.device)
    c_init = c0 = cost(cur)
    costs = []
    for _ in range(int(iterations)):
        Jv, Jp, r = _jacobians(cur)
        dv, dp = _schur_solve(cur, Jv, Jp, r, lam, solve_dtype=solve_dtype,
                              refine_steps=refine_steps, order=order)
        cand = _apply_step(cur, dv, dp)
        c1 = cost(cand)
        good = torch.isfinite(c1) & (c1 < c0)
        cur = cur._replace(**{k: torch.where(good, getattr(cand, k),
                                             getattr(cur, k))
                              for k in _STATE_FIELDS})
        lam = torch.clamp(torch.where(good, lam * lam_down, lam * lam_up),
                          1e-12, 1e8)
        c0 = torch.where(good, c1, c0)
        costs.append(c0)
    return cur, {"costs": (torch.stack(costs) if costs
                           else c0.new_zeros((0,))),
                 "initial_cost": c_init, "final_cost": c0}


def _tensor(a, dtype, device):
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=device, dtype=dtype)


def make_problem(R, t, points, obs_xy, obs_view, obs_valid,
                 intr=None, model: str = "normalized", fixed_views=None,
                 dtype=torch.float64, device=None) -> BAProblem:
    """Convenience constructor with dtype/shape policy applied, from numpy
    arrays or tensors.  ``dtype=torch.float64`` (default) is the
    oracle/parity path; ``torch.float32`` the fast path.  ``device`` None
    means the card, and raises ``RuntimeError`` without one."""
    dev = resolve_device(device)
    V = R.shape[0]
    if intr is None:
        intr = np.zeros((V, n_intr(model)))
    if fixed_views is None:
        fixed_views = np.zeros((V,), bool)
        fixed_views[0] = True
    return BAProblem(
        _tensor(R, dtype, dev), _tensor(t, dtype, dev),
        _tensor(intr, dtype, dev), _tensor(points, dtype, dev),
        _tensor(obs_xy, dtype, dev), _tensor(obs_view, torch.int32, dev),
        _tensor(obs_valid, torch.bool, dev),
        _tensor(fixed_views, torch.bool, dev), model)


def problem_to_numpy(prob: BAProblem) -> dict:
    """The problem as numpy arrays under its field names, plus ``model``."""
    d = {k: getattr(prob, k).detach().cpu().numpy()
         for k in BAProblem._fields if k != "model"}
    d["model"] = prob.model
    return d


def problem_from_numpy(d: dict, device=None) -> BAProblem:
    """The inverse of :func:`problem_to_numpy`: the float arrays keep their
    dtype.  ``device`` None means the card, and raises without one."""
    dev = resolve_device(device)
    return BAProblem(
        *(_tensor(d[k], None, dev) for k in _FLOAT_FIELDS),
        _tensor(d["obs_view"], torch.int32, dev),
        _tensor(d["obs_valid"], torch.bool, dev),
        _tensor(d["fixed_views"], torch.bool, dev), d["model"])
