"""Pose-graph optimization over SE(3) relative-pose constraints (port of
``boofcv_tpu/sfm/pose_graph.py``, whole).

World->camera poses T_i = (R_i, t_i); an edge (i, j) with measured relative
pose Z_ij (x_j = Z_R x_i + Z_t) contributes the residual
r_ij = (log_so3(R_E), t_E) of E = Z_ij⁻¹ ∘ T_j ∘ T_i⁻¹, in R^6.  Damped
Gauss-Newton over local updates T <- exp_se3(xi) ∘ T; the normal system is
dense [6V, 6V] and solved by ``solve_spd`` (a Cholesky factor, no host
sync); the loop runs a fixed number of iterations with branchless
accept/reject, as the reference's ``lax.scan``.

What differs from the reference, and why:

* **Closed-form edge Jacobians.**  The reference builds them with a vmapped
  ``jax.jacfwd``.  Here they are written out: with E = (R_E, t_E),
  T_rel = T_j T_i⁻¹ and J_l⁻¹ the inverse left Jacobian of SO(3) at
  w = log R_E,
    d r / d xi_i = [[-J_l⁻¹ R_E, 0], [0, -R_E]],
    d r / d xi_j = [[J_l⁻¹ Z_Rᵀ, 0], [-Z_Rᵀ [t_rel]x, Z_Rᵀ]],
  a few dozen batched operations over all edges, with no forward-mode
  machinery.  The tests hold them against ``jax.jacfwd`` to 1e-9 in
  float64.
* **Assembly in a fixed order.**  The reference scatter-adds the edge
  blocks (``H.at[...].add``).  ``index_add_`` on the card adds in another
  order on each launch, so here every block goes to its (row, column) run
  of a stable sort made once per solve and each run is summed front to
  back (``geo/ba.py``'s ``_segment_sum``): two solves give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.geo import se3
from boofcv_tpu_torch.geo.ba import _segment_sum, _segments
from boofcv_tpu_torch.geo.smalllinalg import solve_spd

_F64 = torch.float64


class PoseGraph(NamedTuple):
    R: torch.Tensor        # [V, 3, 3]
    t: torch.Tensor        # [V, 3]
    edge_i: torch.Tensor   # [E] int32
    edge_j: torch.Tensor   # [E]
    Z_R: torch.Tensor      # [E, 3, 3] measured relative rotations
    Z_t: torch.Tensor      # [E, 3]
    weight: torch.Tensor   # [E] information scale
    fixed: torch.Tensor    # [V] bool


def make_graph(R, t, edges, fixed=None, device=None) -> PoseGraph:
    """edges: list of (i, j, R_ij, t_ij[, weight]) with x_j = R_ij x_i + t_ij.
    R [V, 3, 3], t [V, 3] numpy or tensors; ``fixed`` [V] bool (default:
    view 0).  ``device`` None: the card."""
    dev = resolve_device(device)
    V = len(R)
    if fixed is None:
        fixed = np.zeros(V, bool)
        fixed[0] = True
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    return PoseGraph(
        t64(R), t64(t),
        torch.as_tensor(np.array([e[0] for e in edges], np.int32),
                        device=dev),
        torch.as_tensor(np.array([e[1] for e in edges], np.int32),
                        device=dev),
        t64(np.stack([np.asarray(e[2], np.float64) for e in edges])),
        t64(np.stack([np.asarray(e[3], np.float64) for e in edges])),
        t64(np.array([e[4] if len(e) > 4 else 1.0 for e in edges])),
        torch.as_tensor(np.asarray(fixed, bool), device=dev))


def graph_from_numpy(d: dict, device=None) -> PoseGraph:
    """A graph from numpy arrays under :class:`PoseGraph`'s field names (as
    the reference's ``PoseGraph`` gives them through ``np.asarray``)."""
    dev = resolve_device(device)
    return PoseGraph(*(torch.as_tensor(np.asarray(d[k]), device=dev)
                       for k in PoseGraph._fields))


def _edge_error(R, t, graph: PoseGraph):
    """E = Z⁻¹ ∘ T_j ∘ T_i⁻¹ for every edge: (R_E, t_E, t_rel, Z_Rᵀ)."""
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    Rii, tii = se3.invert(R[ei], t[ei])
    Rrel, trel = se3.compose(R[ej], t[ej], Rii, tii)    # T_j T_i⁻¹
    ZRi, Zti = se3.invert(graph.Z_R, graph.Z_t)
    Re, te = se3.compose(ZRi, Zti, Rrel, trel)
    return Re, te, trel, ZRi


def _residuals_of(R, t, graph: PoseGraph):
    Re, te, _, _ = _edge_error(R, t, graph)
    return torch.cat([se3.log_so3(Re), te], dim=-1)


def residuals(graph: PoseGraph):
    """[E, 6] edge residuals (rotation first)."""
    return _residuals_of(graph.R, graph.t, graph)


def _inv_left_jacobian(w):
    """J_l⁻¹(w) = I - [w]x / 2 + (1/θ² - (1 + cos θ) / (2 θ sin θ)) [w]x²
    of SO(3), with its series below θ = 1e-4.  [..., 3] -> [..., 3, 3]."""
    th2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = th2 < 1e-8
    th2s = torch.where(small, 1.0, th2)
    th = torch.sqrt(th2s)
    c = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                    1.0 / th2s - (1.0 + torch.cos(th))
                    / (2.0 * th * torch.sin(th)))
    W = se3.hat(w)
    return se3._eye_like(W) - 0.5 * W + c * (W @ W)


def edge_jacobians(R, t, graph: PoseGraph):
    """(r [E, 6], J_i [E, 6, 6], J_j [E, 6, 6]): the residuals and their
    derivatives by the local updates xi_i, xi_j (rotation first) at 0."""
    Re, te, trel, ZRi = _edge_error(R, t, graph)
    w = se3.log_so3(Re)
    Jl = _inv_left_jacobian(w)
    z = torch.zeros_like(Re)
    Ji = torch.cat([torch.cat([-Jl @ Re, z], dim=-1),
                    torch.cat([z, -Re], dim=-1)], dim=-2)
    Jj = torch.cat([torch.cat([Jl @ ZRi, z], dim=-1),
                    torch.cat([-ZRi @ se3.hat(trel), ZRi], dim=-1)], dim=-2)
    return torch.cat([w, te], dim=-1), Ji, Jj


class _Assembly(NamedTuple):
    """The fixed order a solve sums in: every edge's four 6x6 blocks by
    (row view, column view), every edge's two gradient rows by view."""
    block_perm: torch.Tensor     # [4E]
    block_offsets: torch.Tensor  # [V*V + 1]
    grad_perm: torch.Tensor      # [2E]
    grad_offsets: torch.Tensor   # [V + 1]


def _assembly(graph: PoseGraph, V: int) -> _Assembly:
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    keys = torch.cat([ei * V + ei, ej * V + ej, ei * V + ej, ej * V + ei])
    block_perm, block_offsets = _segments(keys, V * V)
    grad_perm, grad_offsets = _segments(torch.cat([ei, ej]), V)
    return _Assembly(block_perm, block_offsets, grad_perm, grad_offsets)


@torch.no_grad()
def optimize(graph: PoseGraph, iterations: int = 20, lam0: float = 1e-4):
    """Damped Gauss-Newton pose-graph optimization (the reference's fixed
    iteration count, branchless accept/reject, no host sync).  Returns
    (graph with the new poses, costs [iterations] float64 tensor)."""
    V = graph.R.shape[0]
    dev = graph.R.device
    order = _assembly(graph, V)
    w = graph.weight
    fvd = (~graph.fixed).to(_F64)[:, None].expand(V, 6).reshape(-1)  # [6V]
    mask = fvd[:, None] * fvd[None, :]
    diag = (1.0 - fvd)                       # gauge: fixed views pinned
    R, t = graph.R, graph.t
    lam = torch.full((), lam0, dtype=_F64, device=dev)
    costs = []
    for _ in range(int(iterations)):
        r, Ji, Jj = edge_jacobians(R, t, graph)
        wb = w[:, None, None]
        Hii = Ji.transpose(-1, -2) @ Ji * wb
        Hjj = Jj.transpose(-1, -2) @ Jj * wb
        Hij = Ji.transpose(-1, -2) @ Jj * wb
        blocks = torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)])
        H = _segment_sum(blocks, order.block_perm, order.block_offsets)
        H = H.reshape(V, V, 6, 6).permute(0, 2, 1, 3).reshape(6 * V, 6 * V)
        gi = (Ji.transpose(-1, -2) @ r[..., None])[..., 0] * w[:, None]
        gj = (Jj.transpose(-1, -2) @ r[..., None])[..., 0] * w[:, None]
        g = _segment_sum(torch.cat([gi, gj]), order.grad_perm,
                         order.grad_offsets).reshape(-1)
        H = H * mask
        H.diagonal().add_(diag + lam)
        dx = -solve_spd(H, g * fvd).reshape(V, 6) * fvd.reshape(V, 6)
        dR, dt = se3.exp_se3(dx)
        Rn, tn = se3.compose(dR, dt, R, t)
        c0 = torch.sum(w[:, None] * r * r)
        rn = _residuals_of(Rn, tn, graph)
        c1 = torch.sum(w[:, None] * rn * rn)
        good = torch.isfinite(c1) & (c1 < c0)
        R = torch.where(good, Rn, R)
        t = torch.where(good, tn, t)
        lam = torch.clamp(torch.where(good, lam * 0.3, lam * 10.0),
                          1e-12, 1e8)
        costs.append(torch.where(good, c1, c0))
    return graph._replace(R=R, t=t), (torch.stack(costs) if costs else
                                      torch.zeros(0, dtype=_F64, device=dev))
