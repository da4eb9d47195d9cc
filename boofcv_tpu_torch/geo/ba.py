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
  order: two solves of one problem give the same bits (on the card the
  fill-in's sums are one kernel, ``kernels/schur_fill``, that forms the
  pair products in registers and adds each run in that order).  An
  ``index_add_`` on the card adds with atomics in an order that changes
  from launch to launch, and LM's accept/reject turns one different ulp
  into another trajectory.
* **No host sync in the loop.**  ``cholesky_ex`` never raises: where it
  reports a matrix that is not positive definite the step is poisoned with
  NaN, the candidate's cost is NaN, and the step is rejected as in the
  reference (whose Cholesky returns NaN there).  ``lam``, the accept flag
  and the costs stay tensors.
* The small contractions (inner dimension 2, 3 or 6) are broadcast
  multiply-and-sum, not batched matmul calls.
* **Buckets, not one table.**  Where it knows the track lengths,
  ``optimize`` runs no stage on the whole ``[P, L]`` table, whose width
  is the longest track: in a photo
  collection most points are seen two to four times and a few a hundred
  times, so the pair fill-in over ``[P, L, L]`` would be hundreds of times
  the work and far more than the card holds.  Once per solve
  (:func:`_buckets`) each point's valid slots are moved to the front and
  the points grouped by track length into dense ``[P_b, L_b]`` buckets; a
  bucket too large for the assembly's memory budget (``_PAIR_BYTES``) is
  taken in pieces of points, and consecutive pieces form groups, each
  with its own fixed order.  Every iteration runs the stages piece by
  piece and adds the groups' sums in plan order.  How many points have
  each track length is noted on the table where it is made from host
  arrays (:func:`make_problem`), so the plan reads nothing back; a table
  made otherwise is taken as it is, one bucket of its width.  The
  ``[P, L]`` entry points (:func:`_local_system`, :func:`_scale_jacobians`)
  run the same code over the table as a plan of one piece.

Precision follows the reference's code: with ``mixed_precision`` (default
for float32 problems) the 3x3 point-block inverses run in float64, the
``[6V, 6V]`` Cholesky in the problem's float32, followed by two rounds of
iterative refinement with the residual in float64; ``optimize``'s costs
are float64, the state's residuals evaluated and summed in float64.

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
from boofcv_tpu_torch.kernels import schur_fill
from boofcv_tpu_torch.utils.profiling import span


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


def _keys(obs_view, num_views: int, obs_valid=None):
    """The sort keys of a ``[P, L]`` table: its slots' views [P*L] and its
    slot pairs' view pairs ``v_l * V + v_m`` [P*L*L]; with ``obs_valid``
    an invalid slot's key is V and an invalid pair's V*V, past every
    run."""
    view = obs_view.long()
    pair = view[:, :, None] * num_views + view[:, None, :]   # [P, L, L]
    if obs_valid is not None:
        view = torch.where(obs_valid, view, num_views)
        pair = torch.where(obs_valid[:, :, None] & obs_valid[:, None, :],
                           pair, num_views * num_views)
    return view.reshape(-1), pair.reshape(-1)


def _order(keys, pair_keys, num_views: int) -> ViewOrder:
    perm, offsets = _segments(keys, num_views)
    pair_perm, pair_offsets = _segments(pair_keys, num_views * num_views)
    return ViewOrder(perm, offsets, pair_perm, pair_offsets)


def _view_order(obs_view, num_views: int, obs_valid=None) -> ViewOrder:
    """Built once per solve: ``obs_view`` and ``obs_valid`` do not change in
    it.  An invalid slot carries view 0 and zero jacobians; with
    ``obs_valid`` given it is left out of view 0's run (and its pairs out of
    theirs) instead of being added there as zeros: thousands of them would
    make those few runs far longer than any other, and a run is added by
    one thread."""
    return _order(*_keys(obs_view, num_views, obs_valid), num_views)


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
    view columns (``Jv`` [..., 2, D]), summed by view in ``order``."""
    return _segment_sum(torch.sum(Jv * Jv, dim=-2).reshape(-1, Jv.shape[-1]),
                        order.perm, order.offsets)


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
    """Jacobi (Marquardt) column scaling of a ``[P, L]`` table
    (:func:`_slot_scale` of the table as a plan of one piece): divide each
    parameter column by sqrt of its Gauss-Newton diagonal so Hpp / Hvv
    have unit diagonals.

    Returns (Jv_scaled, Jp_scaled, s_v [V, D], s_p [P, 3]); steps computed
    in the scaled space are unscaled by dividing by s_v / s_p again.

    ``hvv_diag``: a pre-reduced [V, D] diagonal to scale by instead.
    """
    plan = _table_plan(obs_view, num_views, order=order)
    flat = [x.reshape((-1,) + x.shape[2:]) for x in (Jv, Jp)]
    if hvv_diag is None:
        hvv_diag = _slot_view_diag(flat[0], plan, num_views)
    Jv_s, Jp_s, s_v, s_p = _slot_scale(plan, *flat, hvv_diag)
    return Jv_s.view(Jv.shape), Jp_s.view(Jp.shape), s_v, s_p


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


def _pair_products(W, Y, out=None):
    """W_l^T Y_m for every slot pair of a point: [P, L, 3, D] twice ->
    [P, L, L, D, D] (written into ``out`` when given).  The three terms of
    the inner sum one after the other, so the largest temporary is the
    result itself."""
    Wl, Ym = W[:, :, None, :, :, None], Y[:, None, :, :, None, :]
    pair = torch.mul(Wl[..., 0, :, :], Ym[..., 0, :, :], out=out)
    for i in (1, 2):
        pair.addcmul_(Wl[..., i, :, :], Ym[..., i, :, :])
    return pair


# The assembly's memory budget, in bytes of one group's pair products
# (D x D floats a pair).  On the card the fill-in forms the products in
# registers (kernels/schur_fill), so the budget now bounds only what a
# group keeps of its pairs: their order, 8 bytes a pair (0.84 GB over
# Venice's ~104 M pairs), and the keys sorted to make it.  The plain
# version (a CPU tensor) still writes the products and a sorted copy of
# them, 2 x this at once.  Each group adds into one dense [V * V, D, D]
# system (1 GB at BAL Venice's 1,778 views) the blocks of its view pairs;
# Venice's ~104 M pairs take 8 groups.
_PAIR_BYTES = 1 << 32

# Bucket widths: one per track length up to this, then buckets that each
# span lengths [l, l * 9 / 8], so a slot pair is padded by at most
# (9 / 8)^2 (1.08 x at Venice's track law).
_EXACT_WIDTHS = 16


class Buckets(NamedTuple):
    """A solve's points grouped by track length, built once per solve by
    :func:`_buckets` (or a ``[P, L]`` table as one piece,
    :func:`_table_plan`).

    The slots of every piece lie one after the other in the plan's slot
    arrays, point-major: piece ``(slot0, n, w, point0)`` is slots
    ``slot0 : slot0 + n * w`` viewed as ``[n, w]``, the points
    ``point0 : point0 + n`` of the plan, each point's valid slots first.
    A group is consecutive pieces; its ``ViewOrder`` runs over its slots
    and over the pairs of its pieces, piece by piece, and its
    :class:`Fill` says how the fill-in walks those pairs.
    """
    pieces: tuple               # host: (slot0, n, w, point0) a piece
    groups: tuple               # host: (piece0, piece1, slot0, slot1, pairs)
    orders: tuple               # ViewOrder of each group
    fills: tuple                # Fill of each group
    points: torch.Tensor        # [Q] each planned point's index in the problem
    where: torch.Tensor         # [P] each point's plan position (Q: no slot)
    slot_point: torch.Tensor    # [N] plan position of each slot's point
    slot_source: torch.Tensor   # [N] problem index of each slot's point
    obs_xy: torch.Tensor        # [N, 2] (None in a table's plan)
    obs_view: torch.Tensor      # [N] int32
    obs_valid: torch.Tensor     # [N] bool
    lengths: np.ndarray | None  # host: points by track length, [L + 1]


class Fill(NamedTuple):
    """How the Schur fill-in walks a group's slot pairs (:func:`_fill_in`),
    built once per solve by :func:`_fill_table`."""
    pieces: tuple               # host: (pair0, slot0, w) of each piece,
    #                             pair and slot offsets within the group
    runs: torch.Tensor          # [V * V] int32: the view pairs, those with
    #                             a pair first, each part in key order


def _fill_table(pieces, slot0: int, order: ViewOrder) -> Fill:
    """The :class:`Fill` of a group: its ``pieces`` (the plan's rows) and
    its ``order``; the group's slots begin at ``slot0``.  The runs are
    sorted on the device (nothing read back)."""
    rows, pair0 = [], 0
    for a, n, w, _ in pieces:
        rows.append((pair0, a - slot0, w))
        pair0 += n * w * w
    empty = (order.pair_offsets.diff() == 0).to(torch.uint8)
    runs = torch.argsort(empty, stable=True).to(torch.int32)
    return Fill(tuple(rows), runs)


_pairs_last = (0, 0)


def pair_counts() -> tuple:
    """(formed, valid) slot pairs of the last solve's assembly: those its
    buckets form, padding included, and the valid pairs among them."""
    formed, valid = _pairs_last
    return formed, int(valid)


def _note_track_lengths(table, host_valid) -> None:
    """Note on the device ``table`` (``obs_valid``) how many points have
    each count of valid observations, counted from the host array it was
    made from (and that nothing else writes to); :func:`_track_lengths`
    reads it while the table is not written to."""
    counts = np.asarray(host_valid).sum(1)
    table._ba_track_lengths = (table._version, np.bincount(
        counts, minlength=table.shape[1] + 1))


def _track_lengths(obs_valid) -> np.ndarray | None:
    """[L + 1] points by count of valid observations, as noted on the
    table where it was made from host arrays; None for a table made
    otherwise, or written to since (nothing is read back)."""
    note = getattr(obs_valid, "_ba_track_lengths", None)
    if note is None or note[0] != obs_valid._version:
        return None
    return note[1]


def _plan(hist, D: int, itemsize: int):
    """The host half of :func:`_buckets`: pieces and groups from the track
    lengths ``hist``."""
    buckets = []                                # (width, points)
    length = 1
    while length < len(hist):
        if not hist[length]:
            length += 1
            continue
        top = length if length <= _EXACT_WIDTHS else length * 9 // 8
        top = min(top, len(hist) - 1)
        n = int(hist[length:top + 1].sum())
        width = length + int(np.nonzero(hist[length:top + 1])[0][-1])
        buckets.append((width, n))
        length = top + 1
    cap = max(1, _PAIR_BYTES // (D * D * itemsize))
    pieces, groups = [], []
    slot0 = point0 = pairs = 0
    first = (0, 0)                              # (piece, slot) of the group

    def close():
        groups.append((first[0], len(pieces), first[1], slot0, pairs))

    for width, n in buckets:
        while n:
            take = min(n, max(1, (cap - pairs) // (width * width)))
            if pairs and pairs + take * width * width > cap:
                close()
                first, pairs = (len(pieces), slot0), 0
                continue
            pieces.append((slot0, take, width, point0))
            slot0 += take * width
            point0 += take
            pairs += take * width * width
            n -= take
    if pieces:
        close()
    return tuple(pieces), tuple(groups)


def _buckets(prob: BAProblem, num_views: int) -> Buckets:
    """The solve's plan (see :class:`Buckets`), made on the problem's
    device with nothing read back.  Where the table's track lengths are
    noted (:func:`_track_lengths`) each point's valid slots move to the
    front and the points are grouped by track length; the plan is checked
    on the device to hold every valid observation, so a note gone stale
    fails loudly instead of dropping some.  A table without a note is
    taken as it is: one bucket of its width, in table order."""
    global _pairs_last
    valid = prob.obs_valid
    P, L = valid.shape
    dev = prob.points.device
    hist = _track_lengths(valid)
    noted = hist is not None
    if not noted:
        hist = np.zeros(L + 1, np.int64)
        hist[L] = P
    pieces, groups = _plan(hist, 6 + n_intr(prob.model),
                           prob.points.element_size())
    empty = torch.zeros((0,), dtype=torch.long, device=dev)
    if noted:
        # points shortest track first (those with none lead and are left
        # out); each row's valid slots first, in their order
        points = torch.argsort(valid.sum(1), stable=True)[int(hist[0]):]
        front = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
        source = [(points[p0:p0 + n, None] * L
                   + front[points[p0:p0 + n], :w]).reshape(-1)
                  for _, n, w, p0 in pieces]
        source = torch.cat(source) if source else empty
        valid_pairs = int((hist * np.arange(L + 1) ** 2).sum())
    else:
        points = torch.arange(int(hist[1:].sum()), device=dev)
        source = torch.arange(points.shape[0] * L, device=dev)
        valid_pairs = (valid.sum(1) ** 2).sum()
    slot_point = [torch.arange(n * w, device=dev) // w + p0
                  for _, n, w, p0 in pieces]
    slot_point = torch.cat(slot_point) if slot_point else empty
    obs_view = prob.obs_view.reshape(-1)[source]
    obs_valid = valid.reshape(-1)[source]
    if noted:
        torch._assert_async(obs_valid.sum() == valid.sum())
    orders, fills = [], []
    for p0, p1, s0, s1, _ in groups:
        keys = [_keys(obs_view[a:a + n * w].view(n, w), num_views,
                      obs_valid[a:a + n * w].view(n, w))
                for a, n, w, _ in pieces[p0:p1]]
        orders.append(_order(torch.cat([k[0] for k in keys]),
                             torch.cat([k[1] for k in keys]), num_views))
        fills.append(_fill_table(pieces[p0:p1], s0, orders[-1]))
    Q = points.shape[0]
    where = torch.full((P,), Q, dtype=torch.long, device=dev).scatter_(
        0, points, torch.arange(Q, device=dev))
    _pairs_last = (sum(g[4] for g in groups), valid_pairs)
    return Buckets(pieces, groups, tuple(orders), tuple(fills), points,
                   where, slot_point, source // max(L, 1),
                   prob.obs_xy.reshape(-1, 2)[source],
                   obs_view, obs_valid, hist if noted else None)


def _table_plan(obs_view, num_views: int, order=None) -> Buckets:
    """A ``[P, L]`` table as a plan of one piece and one group, its slots
    in table order (the ``[P, L]`` entry points): ``order`` its
    :class:`ViewOrder` (None: made here, invalid slots added as zeros)."""
    P, L = obs_view.shape
    dev = obs_view.device
    if order is None:
        order = _view_order(obs_view, num_views)
    points = torch.arange(P, device=dev)
    slot_point = torch.arange(P * L, device=dev) // max(L, 1)
    pieces = ((0, P, L, 0),)
    return Buckets(pieces, ((0, 1, 0, P * L, P * L * L),), (order,),
                   (_fill_table(pieces, 0, order),), points, points,
                   slot_point, slot_point, None,
                   obs_view.reshape(-1),
                   torch.ones(P * L, dtype=torch.bool, device=dev), None)


def _slot_problem(prob: BAProblem, plan: Buckets, dtype=None) -> BAProblem:
    """The plan's slots as a problem of one slot a point: [N, 1] tables,
    each slot's point gathered; in ``dtype`` when given."""
    f = (lambda x: x) if dtype is None else (lambda x: x.to(dtype))
    return prob._replace(R=f(prob.R), t=f(prob.t), intr=f(prob.intr),
                         points=f(prob.points)[plan.slot_source],
                         obs_xy=f(plan.obs_xy)[:, None],
                         obs_view=plan.obs_view[:, None],
                         obs_valid=plan.obs_valid[:, None])


def _slot_cost(prob: BAProblem, plan: Buckets):
    """0.5 * the sum of squared residuals over the plan's slots, the state
    evaluated and summed in float64: LM's accept and reject compare two
    such costs."""
    r = residuals(_slot_problem(prob, plan, torch.float64))
    return 0.5 * torch.sum(r * r)


def _slot_jacobians(prob: BAProblem, plan: Buckets):
    """:func:`_jacobians` of the plan's slots: Jv [N, 2, D], Jp [N, 2, 3],
    r [N, 2]."""
    return tuple(x.squeeze(1) for x in _jacobians(_slot_problem(prob, plan)))


def _piece(x, piece):
    """A piece's slots of a slot array [N, ...] as [n, w, ...]."""
    slot0, n, w, _ = piece
    return x[slot0:slot0 + n * w].view((n, w) + x.shape[1:])


def _slot_view_diag(Jv, plan: Buckets, num_views: int):
    """[V, D] Gauss-Newton view diagonal over the plan's slots: each
    group's in its order, the groups' added in plan order."""
    diag = None
    for (_, _, s0, s1, _), order in zip(plan.groups, plan.orders):
        part = _gn_view_diag(Jv[s0:s1], order)
        diag = part if diag is None else diag + part
    return Jv.new_zeros((num_views, Jv.shape[-1])) if diag is None else diag


def _slot_scale(plan: Buckets, Jv, Jp, hvv_diag):
    """Jacobi column scaling of the plan's slot arrays: (Jv_s, Jp_s,
    s_v [V, D], s_p [Q, 3]), the point scales in plan order."""
    s_v = torch.clamp(torch.sqrt(hvv_diag), min=1e-6)
    sq = [torch.sum(x * x, dim=(1, 2))
          for x in (_piece(Jp, pc) for pc in plan.pieces)]
    s_p = torch.clamp(torch.sqrt(torch.cat(sq) if sq else Jp.new_zeros(
        (0, 3))), min=1e-6)
    Jv_s = Jv / s_v[plan.obs_view.long()][:, None, :]
    Jp_s = Jp / s_p[plan.slot_point][:, None, :]
    return Jv_s, Jp_s, s_v, s_p


def _pair_sums(W, Y, order: ViewOrder, fill: Fill):
    """The plain version of a group's fill-in: [V * V, D, D], for each view
    pair the sum of W_l^T Y_m over its slot pairs (l, m) in ``order``; W, Y
    [N, 3, D] the group's slot arrays.  Every product of the group is
    written (:func:`_pair_products`), then summed by view pair
    (:func:`_segment_sum`)."""
    D = W.shape[-1]
    pairs = order.pair_perm.shape[0]
    products = W.new_empty((pairs, D, D))
    ends = [row[0] for row in fill.pieces[1:]] + [pairs]
    for (pair0, slot0, w), end in zip(fill.pieces, ends):
        n = (end - pair0) // (w * w)
        _pair_products(W[slot0:slot0 + n * w].view(n, w, 3, D),
                       Y[slot0:slot0 + n * w].view(n, w, 3, D),
                       out=products[pair0:end].view(n, w, w, D, D))
    return _segment_sum(products, order.pair_perm, order.pair_offsets)


def _fill_in(S, W, Y, order: ViewOrder, fill: Fill) -> None:
    """The Schur fill-in of one group, in place: S [V * V, D, D] -= the
    sum of W_l^T Y_m over the slot pairs (l, m) of each view pair, in
    ``order``; W, Y [N, 3, D] the group's slot arrays.  A CUDA tensor
    launches ``kernels/schur_fill`` once, which forms each product in
    registers; elsewhere the plain version runs (:func:`_pair_sums`)."""
    if S.is_cuda:
        schur_fill.schur_fill_cuda(S, W, Y, order.pair_perm,
                                   order.pair_offsets, fill.runs,
                                   fill.pieces)
    else:
        S -= _pair_sums(W, Y, order, fill)


def _local_system(plan, Jv, Jp, r, lam, num_views: int, solve_dtype=None,
                  order=None):
    """The reduced camera system of the points of ``plan``, piece by
    piece; each group's sums in its own order, the groups' sums added in
    plan order.

    ``plan``: a :class:`Buckets` plan, and ``Jv``, ``Jp``, ``r`` its slot
    arrays ([N, 2, D], [N, 2, 3], [N, 2]); or the ``obs_view`` [P, L] of a
    table, ``Jv``, ``Jp``, ``r`` its ``[P, L, ...]`` arrays, taken as a
    plan of one piece (:func:`_table_plan`; ``order`` its
    :class:`ViewOrder`, when made already).

    ``solve_dtype``: dtype of the 3x3 point-block inversions (the float32
    path passes float64: about 100 flops a point, and it removes the
    eps*cond(Hpp) error that otherwise poisons the whole Schur complement).

    Returns (S [V, V, D, D] incl. Hvv on the diagonal, gv_t [V, D],
    Hpp_inv [Q, 3, 3], W [N, 3, D] ([P, L, 3, D] for a table),
    gp [Q, 3]), the points in plan order.
    """
    table = None
    if not isinstance(plan, Buckets):
        table = plan.shape
        plan = _table_plan(plan, num_views, order)
        Jv, Jp, r = (x.reshape((-1,) + x.shape[2:]) for x in (Jv, Jp, r))
    if solve_dtype is None:
        solve_dtype = Jp.dtype
    V, D = num_views, Jv.shape[-1]
    S = Jv.new_zeros((V * V, D, D))
    Hvv = gv = corr = None
    Hpp_inv, W, gp = [], [], []

    def add(total, part):
        return part if total is None else total + part

    for (p0, p1, _, _, _), order, fill in zip(plan.groups, plan.orders,
                                              plan.fills):
        blocks = [_point_blocks(_piece(Jv, pc), _piece(Jp, pc),
                                _piece(r, pc), lam, solve_dtype)
                  for pc in plan.pieces[p0:p1]]

        def flat(i):
            return torch.cat([b[i].reshape((-1,) + b[i].shape[2:])
                              for b in blocks])

        Hvv = add(Hvv, _segment_sum(flat(4), order.perm, order.offsets))
        gv = add(gv, _segment_sum(flat(3), order.perm, order.offsets))
        corr = add(corr, _segment_sum(flat(6), order.perm, order.offsets))
        # Schur fill-in: S[v_l, v_m] -= W_l^T Y_m over the slot pairs of
        # each point
        W.append(flat(1))
        _fill_in(S, W[-1], flat(5), order, fill)
        for b in blocks:
            Hpp_inv.append(b[0])
            gp.append(b[2])
    if Hvv is None:                             # no observation at all
        Hvv = Jv.new_zeros((V, D, D))
        gv = corr = Jv.new_zeros((V, D))
    S = S.view(V, V, D, D)
    ar = torch.arange(V, device=S.device)
    S[ar, ar] += Hvv
    cat = lambda xs, shape: torch.cat(xs) if xs else Jv.new_zeros(shape)
    W = cat(W, (0, 3, D))
    return (S, gv - corr, cat(Hpp_inv, (0, 3, 3)),
            W if table is None else W.view(table + W.shape[1:]),
            cat(gp, (0, 3)))


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
    """Point updates of a ``[P, L]`` table given the view step:
    dp = Hpp^-1 (gp - sum_l W dv)."""
    dv_obs = dv[obs_view.long()]                             # [P, L, D]
    corr_p = (W * dv_obs[:, :, None, :]).sum((1, 3))
    return _mv(Hpp_inv, gp - corr_p)


def _slot_back_substitute(plan: Buckets, Hpp_inv, W, gp, dv):
    """:func:`_back_substitute` of the plan's pieces: [Q, 3] in plan
    order."""
    out = []
    for pc in plan.pieces:
        pts = slice(pc[3], pc[3] + pc[1])
        out.append(_back_substitute(_piece(plan.obs_view, pc), Hpp_inv[pts],
                                    _piece(W, pc), gp[pts], dv))
    return torch.cat(out) if out else gp


def _slot_step(cur: BAProblem, plan: Buckets, lam, solve_dtype,
               refine_steps: int, reduce=None, solve=None):
    """One damped Schur-complement step of the plan's points in the
    Jacobi-scaled parameter space (``lam`` is relative, Marquardt, damping
    there): (delta_view [V, D], delta_point [P, 3]), unscaled.

    ``reduce`` sums the view diagonal over a mesh's ranks (None: one
    process); ``solve(S, gv_t)`` solves the reduced system (None: the
    damped, gauge-fixed Cholesky of :func:`_solve_reduced` with
    ``refine_steps`` rounds of refinement).
    """
    V = cur.R.shape[0]
    with span("ba.jacobians"):
        Jv, Jp, r = _slot_jacobians(cur, plan)
        diag = _slot_view_diag(Jv, plan, V)
        Jv, Jp, s_v, s_p = _slot_scale(plan, Jv, Jp, diag if reduce is None
                                       else reduce(diag))
    with span("ba.schur"):
        S, gv_t, Hpp_inv, W, gp = _local_system(plan, Jv, Jp, r, lam, V,
                                                solve_dtype)
    with span("ba.reduced_solve"):
        dv = (_solve_reduced(S, gv_t, cur.fixed_views, lam,
                             refine_steps=refine_steps)
              if solve is None else solve(S, gv_t))
    with span("ba.back_substitute"):
        dp = _slot_back_substitute(plan, Hpp_inv, W, gp, dv) / s_p
        # the points without an observation (plan position Q) stay
        dp = torch.cat([dp, dp.new_zeros((1, 3))])[plan.where]
    return dv / s_v, dp


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

    Spans (``utils/profiling``): ``ba.solve`` around the call; per
    iteration ``ba.jacobians`` (with the Jacobi scaling), ``ba.schur``,
    ``ba.reduced_solve``, ``ba.back_substitute`` and ``ba.cost`` (the
    candidate's state and its cost); one more ``ba.cost`` for the initial
    cost.
    """
    with span("ba.solve"):
        dtype = prob.points.dtype
        if mixed_precision is None:
            mixed_precision = dtype == torch.float32
        cur = prob._replace(**{k: getattr(prob, k).to(dtype)
                               for k in _FLOAT_FIELDS})
        solve_dtype = torch.float64 if mixed_precision else None
        refine_steps = 2 if mixed_precision else 0
        plan = _buckets(cur, cur.R.shape[0])
        lam = torch.full((), lam0, dtype=dtype, device=cur.points.device)
        with span("ba.cost"):
            c_init = c0 = _slot_cost(cur, plan)
        costs = []
        for _ in range(int(iterations)):
            dv, dp = _slot_step(cur, plan, lam, solve_dtype, refine_steps)
            with span("ba.cost"):
                cand = _apply_step(cur, dv, dp)
                c1 = _slot_cost(cand, plan)
            good = torch.isfinite(c1) & (c1 < c0)
            cur = cur._replace(**{k: torch.where(good, getattr(cand, k),
                                                 getattr(cur, k))
                                  for k in _STATE_FIELDS})
            lam = torch.clamp(torch.where(good, lam * lam_down,
                                          lam * lam_up), 1e-12, 1e8)
            c0 = torch.where(good, c1, c0)
            costs.append(c0)
        return cur, {"costs": (torch.stack(costs) if costs
                               else c0.new_zeros((0,))),
                     "initial_cost": c_init, "final_cost": c0}


def _tensor(a, dtype, device):
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=device, dtype=dtype)


def _valid_table(obs_valid, device):
    """``obs_valid`` on ``device``; one from the host is copied first, so
    the table holds memory of its own, and its track lengths noted."""
    if isinstance(obs_valid, torch.Tensor) and obs_valid.is_cuda:
        return obs_valid.to(device=device, dtype=torch.bool)
    host = np.array(obs_valid, dtype=bool)
    table = torch.from_numpy(host).to(device)
    _note_track_lengths(table, host)
    return table


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
        _valid_table(obs_valid, dev),
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
        _valid_table(d["obs_valid"], dev),
        _tensor(d["fixed_views"], torch.bool, dev), d["model"])
