"""Point-sharded bundle adjustment over a mesh (port of
``boofcv_tpu/dist/ba_sharded.py``).

The point blocks (and their observations, in the dense ``[P, L]`` layout)
are split over the mesh's ranks; views are replicated.  Each rank:

1. computes the Jacobians and the Schur terms of its point shard
   (``ba._local_system``, in the solve's fixed view order);
2. sums the partial reduced camera system ``S`` and right-hand side over
   the mesh: an all-reduce of ``S`` [V, V, D, D] and ``gv_t`` [V, D]
   ("cholesky"), or a reduce-scatter of ``S`` by view rows ("pcg");
3. solves the reduced system: replicated Cholesky, or block-Jacobi PCG
   with one all-gather of [V, D] a matvec;
4. back-substitutes its own point updates.

The reference's PCG assembles and solves in a ``kvjw`` layout
(``T[k, v, j, w] = S[v, w, k, j]``) with one-hot products: the TPU pads a
trailing dimension of 6 to its (8, 128) tile and adds scatters serially.
The card has neither constraint, so the port keeps ``S``'s [V, V, D, D]
layout (its view rows are contiguous, as ``reduce_scatter_tensor`` wants)
and the reference's arithmetic.
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch.dist.mesh import (all_gather, all_reduce,
                                        check_device, reduce_scatter,
                                        shard_index)
from boofcv_tpu_torch.geo import ba
from boofcv_tpu_torch.geo.ba import BAProblem


def pad_points_for_mesh(prob: BAProblem, n_shards: int) -> BAProblem:
    """Pad the point axis to a multiple of n_shards with dead observations."""
    Pn = prob.points.shape[0]
    rem = (-Pn) % n_shards
    if rem == 0:
        return prob
    L = prob.obs_view.shape[1]
    return prob._replace(
        points=torch.cat([prob.points, prob.points.new_ones((rem, 3))]),
        obs_xy=torch.cat([prob.obs_xy, prob.obs_xy.new_zeros((rem, L, 2))]),
        obs_view=torch.cat([prob.obs_view,
                            prob.obs_view.new_zeros((rem, L))]),
        obs_valid=torch.cat([prob.obs_valid,
                             prob.obs_valid.new_zeros((rem, L))]))


def _pad_views(prob: BAProblem, n_shards: int) -> BAProblem:
    """Pad the views to a multiple of n_shards so that view rows split
    evenly: the dummies are unobserved and gauge-frozen (identity
    diagonal), so the solve is unaffected."""
    pad = (-prob.R.shape[0]) % n_shards
    if pad == 0:
        return prob
    eye = torch.eye(3, dtype=prob.R.dtype, device=prob.R.device)
    return prob._replace(
        R=torch.cat([prob.R, eye.expand(pad, 3, 3)]),
        t=torch.cat([prob.t, prob.t.new_zeros((pad, 3))]),
        intr=torch.cat([prob.intr,
                        prob.intr.new_zeros((pad, prob.intr.shape[1]))]),
        fixed_views=torch.cat([prob.fixed_views,
                               prob.fixed_views.new_ones((pad,))]))


def _round_robin(m: int, device):
    """The m - 1 rounds of the circle method on m (even) indices, as index
    tensors P, Q [m - 1, m / 2] (P < Q): each round pairs every index once.
    Made on the device: an index list from the host is a copy the host
    waits for."""
    r = torch.arange(m - 1, device=device)[:, None]
    k = torch.arange(1, m // 2, device=device)[None, :]
    a = torch.cat([torch.full_like(r, m - 1), (r + k) % (m - 1)], 1)
    b = torch.cat([r, (r - k) % (m - 1)], 1)
    return torch.minimum(a, b), torch.maximum(a, b)


def _eigh_jacobi(A, sweeps: int = 8):
    """(w [..., n], Q [..., n, n]) of symmetric A [..., n, n], unordered:
    cyclic Jacobi rotations, the n / 2 disjoint ones of a round at once
    (the method of cuSOLVER's batched ``syevj``).  ``torch.linalg.eigh``
    reads its status back to the host; this makes no host sync.  An odd n
    is padded with a decoupled zero row and column."""
    n = A.shape[-1]
    m = n + n % 2
    A = torch.nn.functional.pad(A, (0, m - n, 0, m - n))
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    Q = eye.expand(A.shape).clone()
    Ps, Rs = _round_robin(m, A.device)
    for _ in range(sweeps):
        for P, R in zip(Ps, Rs):
            app, aqq, apq = A[..., P, P], A[..., R, R], A[..., P, R]
            off = apq != 0
            tau = (aqq - app) / torch.where(off, 2.0 * apq, 1.0)
            sgn = torch.where(tau >= 0, 1.0, -1.0)
            t = torch.where(off, sgn / (tau.abs() + torch.sqrt(tau * tau
                                                              + 1.0)), 0.0)
            c = torch.rsqrt(t * t + 1.0)
            s = t * c
            J = eye.expand(A.shape).clone()
            J[..., P, P] = c
            J[..., R, R] = c
            J[..., P, R] = s
            J[..., R, P] = -s
            A = J.mT @ A @ J
            Q = Q @ J
    return torch.diagonal(A, dim1=-2, dim2=-1)[..., :n], Q[..., :n, :n]


def _solve_reduced_pcg(S_rows, gv_t, fixed_views, lam, iters: int, mesh):
    """Block-Jacobi preconditioned conjugate gradients on the view rows
    this rank holds, ``S_rows`` [V / n, V, D, D] (rows ``off`` on of the
    summed system): damping on the global diagonal blocks, identity on the
    gauge-frozen rows, the preconditioner from the eigendecomposition of
    each damped diagonal block (eigenvalues clamped at 1e-12), ``iters``
    fixed iterations with ``tiny`` guards on p^T A p and r^T z.  A matvec
    is a local row-block product and one all-gather of [V, D].  Returns
    delta_view [V, D]."""
    rows, V, D, _ = S_rows.shape
    dtype, dev = S_rows.dtype, S_rows.device
    off = shard_index(mesh)[0] * rows
    ar = torch.arange(rows, device=dev)
    row_ids = off + ar
    pose_col = (torch.arange(D, device=dev) < 6).to(dtype)
    frozen = fixed_views.to(dtype)[:, None] * pose_col[None, :]   # [V, D]
    free = 1.0 - frozen
    free_rows, frozen_rows = free[off:off + rows], frozen[off:off + rows]
    lam = ba._scalar(lam, dtype, dev)
    eye = torch.eye(D, dtype=dtype, device=dev)
    S = S_rows.clone()
    S[ar, row_ids] += lam * eye
    # gauge fixing: zero frozen rows/cols, identity on the frozen diagonal
    S = S * free_rows[:, None, :, None] * free[None, :, None, :]
    diag = S[ar, row_ids] + torch.diag_embed(frozen_rows)
    S[ar, row_ids] = diag
    b = gv_t * free

    w, Q = _eigh_jacobi(0.5 * (diag + diag.mT))
    Minv = (Q * (1.0 / torch.clamp(w, min=1e-12))[..., None, :]) @ Q.mT
    A = S.permute(0, 2, 1, 3).reshape(rows * D, V * D)

    def matvec(x):
        return all_gather(torch.mv(A, x.reshape(-1)).reshape(rows, D), mesh)

    def precond(z):
        return all_gather(ba._mv(Minv, z[off:off + rows]), mesh)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    tiny = torch.finfo(dtype).tiny
    for _ in range(int(iters)):
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        alpha = rz / torch.where(pAp <= 0, tiny, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz2 = torch.sum(r * z)
        beta = rz2 / torch.where(rz == 0, tiny, rz)
        p = z + beta * p
        rz = rz2
    return x * free


@torch.no_grad()
def optimize_sharded(prob: BAProblem, mesh, iterations: int = 20,
                     lam0: float = 1e-3, lam_up: float = 10.0,
                     lam_down: float = 0.3, reduced_solver: str = "cholesky",
                     pcg_iterations: int = 100):
    """Distributed LM-Schur BA: :func:`ba.optimize`'s semantics with the
    point axis split over every axis of ``mesh`` (a 2-D mesh reduces
    within a host row, then across rows).  Every rank calls it with the
    whole problem and returns the whole result; the points keep the mesh
    padding, as the reference's do.  On a one-rank mesh "cholesky" gives
    ``ba.optimize``'s bits.

    ``reduced_solver``:
      * "cholesky": all-reduce the full [V, V, D, D] reduced camera system
        to every rank and solve it there (exact; O(V^2 D^2) traffic and
        memory a rank).
      * "pcg": reduce-scatter the system by view rows (a rank keeps
        [V / n, V, D, D]) and solve by distributed block-Jacobi PCG,
        ``pcg_iterations`` fixed iterations; 1-D meshes only.

    Runs in the problem's own float dtype; on float32 the 3x3 point blocks
    invert in float64 and the Cholesky solve is refined twice with a
    float64 residual, as in ``ba.optimize``.  Costs are summed in float64
    and all-reduced as such.  No host sync inside the LM loop.  Returns
    (problem, {"costs" [iterations], "initial_cost", "final_cost"}).
    """
    if reduced_solver not in ("cholesky", "pcg"):
        raise ValueError(f"unknown reduced_solver {reduced_solver!r}; "
                         "expected 'cholesky' or 'pcg'")
    if reduced_solver == "pcg" and mesh.ndim != 1:
        raise ValueError("the pcg reduced solver takes 1-D meshes only")
    check_device(mesh, prob.points.device)
    rank, n = shard_index(mesh)
    V_orig = prob.R.shape[0]
    prob = pad_points_for_mesh(prob, n)
    if reduced_solver == "pcg":
        prob = _pad_views(prob, n)
    dtype = prob.points.dtype
    prob = prob._replace(**{k: getattr(prob, k).to(dtype)
                            for k in ba._FLOAT_FIELDS})
    V = prob.R.shape[0]
    mixed = dtype == torch.float32
    solve_dtype = torch.float64 if mixed else None
    refine_steps = 2 if mixed else 0
    m = prob.points.shape[0] // n
    mine = slice(rank * m, (rank + 1) * m)
    cur = prob._replace(points=prob.points[mine], obs_xy=prob.obs_xy[mine],
                        obs_view=prob.obs_view[mine],
                        obs_valid=prob.obs_valid[mine])
    order = ba._view_order(cur.obs_view, V, cur.obs_valid)

    def lm_step(cur, lam):
        Jv, Jp, r = ba._jacobians(cur)
        # every rank scales the view columns by the same, summed diagonal
        hvv_diag = all_reduce(ba._gn_view_diag(Jv, order), mesh)
        Jv, Jp, s_v, s_p = ba._scale_jacobians(cur.obs_view, Jv, Jp, V,
                                               hvv_diag=hvv_diag)
        S, gv_t, Hpp_inv, W, gp = ba._local_system(
            cur.obs_view, Jv, Jp, r, lam, V, solve_dtype=solve_dtype,
            order=order)
        gv_t = all_reduce(gv_t, mesh)
        if reduced_solver == "pcg":
            dv = _solve_reduced_pcg(reduce_scatter(S, mesh), gv_t,
                                    cur.fixed_views, lam, pcg_iterations,
                                    mesh)
        else:
            dv = ba._solve_reduced(all_reduce(S, mesh), gv_t,
                                   cur.fixed_views, lam,
                                   refine_steps=refine_steps)
        dp = ba._back_substitute(cur.obs_view, Hpp_inv, W, gp, dv)
        r64 = r.to(torch.float64)
        c0 = all_reduce(0.5 * torch.sum(r64 * r64), mesh)
        return dv / s_v, dp / s_p, c0

    lam = torch.full((), lam0, dtype=dtype, device=prob.points.device)
    costs = []
    c_init = None
    for _ in range(int(iterations)):
        dv, dp, c0 = lm_step(cur, lam)
        c_init = c0 if c_init is None else c_init
        cand = ba._apply_step(cur, dv, dp)
        c1 = all_reduce(ba.cost(cand), mesh)
        good = torch.isfinite(c1) & (c1 < c0)
        cur = cur._replace(**{k: torch.where(good, getattr(cand, k),
                                             getattr(cur, k))
                              for k in ba._STATE_FIELDS})
        lam = torch.clamp(torch.where(good, lam * lam_down, lam * lam_up),
                          1e-12, 1e8)
        costs.append(torch.where(good, c1, c0))
    final = all_reduce(ba.cost(cur), mesh)
    out = prob._replace(R=cur.R[:V_orig], t=cur.t[:V_orig],
                        intr=cur.intr[:V_orig],
                        fixed_views=prob.fixed_views[:V_orig],
                        points=all_gather(cur.points, mesh))
    return out, {"costs": (torch.stack(costs) if costs
                           else final.new_zeros((0,))),
                 "initial_cost": final if c_init is None else c_init,
                 "final_cost": final}
