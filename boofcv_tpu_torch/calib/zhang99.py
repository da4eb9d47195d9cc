"""Zhang 1999 planar camera calibration (port of
``boofcv_tpu/calib/zhang99.py``, whole).

Reference analog: boofcv-calibration alg/geo/calibration/
CalibrationPlanarGridZhang99.java:67,122 — per-view homographies, linear K,
extrinsics, linear radial init, then a nonlinear refine of every parameter
at once; CalibrateStereoPlanar for the stereo pair.

The homographies are one batched DLT on the device; the closed form after
them (linear K, extrinsics, radial init) is the reference's numpy, copied,
on the host.  The refine loops (the reference's jitted ``lax.scan``) are
fixed-count loops on device tensors with the accept flag and the damping
kept as tensors: no host sync inside.  The Brown refine Schur-eliminates
the per-view pose blocks with ``inv_ex`` and solves the 7x7 reduced system
with ``solve_spd``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.geo import epipolar, se3
from boofcv_tpu_torch.geo.smalllinalg import solve_spd

_F64 = torch.float64


@dataclass
class CalibrationResult:
    K: np.ndarray                 # [3,3]
    radial: tuple                 # (k1, k2)
    rotations: np.ndarray         # [V,3,3] world(target)->camera
    translations: np.ndarray      # [V,3]
    reprojection_rmse: float
    mirror_offset: float = 0.0    # universal-omni xi (0 for Brown/pinhole)


def homographies_per_view(world_xy, obs, device=None) -> torch.Tensor:
    """[V, 3, 3] target-plane -> pixel homographies (one batched DLT).
    world_xy [N, 2] planar target points, obs [V, N, 2] pixels."""
    dev = resolve_device(device)
    obs = torch.as_tensor(np.asarray(obs, np.float64), device=dev)
    w = torch.as_tensor(np.asarray(world_xy, np.float64), device=dev)
    return epipolar.homography_dlt(w.expand(obs.shape[:1] + w.shape), obs)


def k_from_homographies(Hs):
    """Linear intrinsics from >= 3 homographies (Zhang99CalibrationMatrix-
    FromHomographies), on the host."""
    Hs = np.asarray(Hs, np.float64)

    def v_ij(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    rows = []
    for H in Hs:
        rows.append(v_ij(H, 0, 1))
        rows.append(v_ij(H, 0, 0) - v_ij(H, 1, 1))
    A = np.stack(rows)
    _, _, Vt = np.linalg.svd(A)
    b = Vt[-1]
    B11, B12, B22, B13, B23, B33 = b
    cy = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 ** 2)
    lam = B33 - (B13 ** 2 + cy * (B12 * B13 - B11 * B23)) / B11
    fx = np.sqrt(abs(lam / B11))
    fy = np.sqrt(abs(lam * B11 / (B11 * B22 - B12 ** 2)))
    skew = -B12 * fx ** 2 * fy / lam
    cx = skew * cy / fx - B13 * fx ** 2 / lam
    return np.array([[fx, skew, cx], [0, fy, cy], [0, 0, 1.0]])


def extrinsics_from_homography(H, K):
    """(R, t) target -> camera from H = K [r1 r2 t]
    (Zhang99DecomposeHomography), on the host."""
    Kinv = np.linalg.inv(K)
    A = Kinv @ np.asarray(H, np.float64)
    s = 1.0 / np.linalg.norm(A[:, 0])
    if A[2, 2] * s < 0:  # target must be in front
        s = -s
    r1 = A[:, 0] * s
    r2 = A[:, 1] * s
    r3 = np.cross(r1, r2)
    t = A[:, 2] * s
    R = np.stack([r1, r2, r3], axis=1)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
    return R, t


def linear_radial_estimate(world_xy, obs, K, Rs, ts, obs_mask=None):
    """Least-squares (k1, k2) from the residuals against the pinhole
    projection (RadialDistortionEstimateLinear), on the host."""
    K = np.asarray(K)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    w3 = np.concatenate([world_xy, np.zeros((world_xy.shape[0], 1))], 1)
    Xc = np.einsum("vij,nj->vni", np.asarray(Rs), w3) \
        + np.asarray(ts)[:, None]                            # [V,N,3]
    xn = Xc[..., :2] / Xc[..., 2:]
    r2 = np.sum(xn ** 2, axis=-1)                            # [V,N]
    u = fx * xn[..., 0] + cx
    vv = fy * xn[..., 1] + cy
    du = obs[..., 0] - u
    dv = obs[..., 1] - vv
    cu = np.stack([(u - cx) * r2, (u - cx) * r2 * r2], -1)
    cv = np.stack([(vv - cy) * r2, (vv - cy) * r2 * r2], -1)
    A = np.stack([cu, cv], axis=2)
    b = np.stack([du, dv], axis=2)
    if obs_mask is not None:
        A = A[obs_mask]
        b = b[obs_mask]
    k, *_ = np.linalg.lstsq(A.reshape(-1, 2), b.reshape(-1), rcond=None)
    return float(k[0]), float(k[1])


def _planar3(world_xy: torch.Tensor) -> torch.Tensor:
    return torch.cat([world_xy, torch.zeros_like(world_xy[:, :1])], 1)


def _project_all(params, world_xy, n_views: int):
    """Brown-pinhole projection of every target point in every view.
    params [7 + 6V] = (fx, fy, skew, cx, cy, k1, k2, per-view se3);
    returns [V, N, 2]."""
    fx, fy, skew, cx, cy, k1, k2 = params[:7]
    R, t = se3.exp_se3(params[7:].reshape(n_views, 6))
    Xc = _planar3(world_xy) @ R.transpose(-1, -2) + t[:, None, :]
    xn = Xc[..., :2] / Xc[..., 2:]
    r2 = torch.sum(xn ** 2, dim=-1, keepdim=True)
    xd = xn * (1.0 + k1 * r2 + k2 * r2 * r2)
    return torch.stack([fx * xd[..., 0] + skew * xd[..., 1] + cx,
                        fy * xd[..., 1] + cy], dim=-1)


def _brown_project_and_jac(intr, Rs, ts, w3):
    """Analytic Brown-pinhole projection and Jacobians of every (view,
    corner) (CalibrationPlanarGridZhang99.java:122 wires the analytic
    Zhang99OptimizationJacobian into its LM).

    intr [7] = (fx, fy, skew, cx, cy, k1, k2); Rs [V, 3, 3]; ts [V, 3]; w3
    [N, 3].  Pose Jacobians are for a left-multiplied se3 perturbation
    (dXc/dw = -hat(Xc), dXc/dv = I).  Returns (proj [V, N, 2], Ji
    [V, N, 2, 7], Jx [V, N, 2, 6])."""
    fx, fy, skew, cx, cy, k1, k2 = intr
    Xc = torch.einsum("vij,nj->vni", Rs, w3) + ts[:, None]
    z = Xc[..., 2]
    iz = 1.0 / z
    xn = Xc[..., :2] * iz[..., None]
    r2 = torch.sum(xn * xn, dim=-1)
    d = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = xn * d[..., None]
    u = fx * xd[..., 0] + skew * xd[..., 1] + cx
    v = fy * xd[..., 1] + cy
    proj = torch.stack([u, v], dim=-1)

    zero = torch.zeros_like(r2)
    one = torch.ones_like(r2)
    fxs = fx * xn[..., 0] + skew * xn[..., 1]
    du = torch.stack([xd[..., 0], zero, xd[..., 1], one, zero,
                      fxs * r2, fxs * r2 * r2], -1)
    dv = torch.stack([zero, xd[..., 1], zero, zero, one,
                      fy * xn[..., 1] * r2, fy * xn[..., 1] * r2 * r2], -1)
    Ji = torch.stack([du, dv], dim=-2)                       # [V,N,2,7]

    # pixel <- distorted <- normalized <- camera point
    g = 2.0 * (k1 + 2.0 * k2 * r2)
    eye2 = torch.eye(2, dtype=d.dtype, device=d.device)
    Dxd = (d[..., None, None] * eye2
           + g[..., None, None] * xn[..., :, None] * xn[..., None, :])
    Kpix = torch.stack([torch.stack([fx, skew]), torch.stack([0.0 * fx, fy])])
    A0 = torch.stack([
        torch.stack([iz, zero, -Xc[..., 0] * iz * iz], -1),
        torch.stack([zero, iz, -Xc[..., 1] * iz * iz], -1)], -2)
    A = torch.einsum("ij,vnjk,vnkl->vnil", Kpix, Dxd, A0)    # [V,N,2,3]
    Jx = torch.cat([-torch.einsum("vnij,vnjk->vnik", A, se3.hat(Xc)), A],
                   dim=-1)                                   # [V,N,2,6]
    return proj, Ji, Jx


def _refine_brown(intr0, Rs0, ts0, w3, obsj, maskj, iterations: int,
                  zero_skew: bool):
    """Damped Gauss-Newton (LM accept/reject) of (intrinsics, per-view
    poses), ``iterations`` fixed steps.  View v's corners depend only on
    the 7 intrinsics and its own pose, so the pose blocks are
    Schur-eliminated and a 7x7 system is solved a step."""
    col = torch.arange(7, device=intr0.device)
    eye7 = torch.eye(7, dtype=_F64, device=intr0.device)
    eye6 = torch.eye(6, dtype=_F64, device=intr0.device)

    def cost_of(intr, R_, t_):
        proj, _, _ = _brown_project_and_jac(intr, R_, t_, w3)
        r = torch.where(maskj, proj - obsj, 0.0)
        return torch.sum(r * r)

    intr, R_, t_ = intr0, Rs0, ts0
    lam = torch.tensor(1e-3, dtype=_F64, device=intr0.device)
    for _ in range(iterations):
        proj, Ji, Jx = _brown_project_and_jac(intr, R_, t_, w3)
        r = torch.where(maskj, proj - obsj, 0.0)
        Ji = torch.where(maskj[..., None], Ji, 0.0)
        Jx = torch.where(maskj[..., None], Jx, 0.0)
        if zero_skew:
            Ji = torch.where(col == 2, 0.0, Ji)
        Hii = torch.einsum("vnki,vnkj->ij", Ji, Ji) + lam * eye7
        Hxx = torch.einsum("vnki,vnkj->vij", Jx, Jx) + lam * eye6
        Hix = torch.einsum("vnki,vnkj->vij", Ji, Jx)         # [V,7,6]
        gi = torch.einsum("vnki,vnk->i", Ji, r)
        gx = torch.einsum("vnki,vnk->vi", Jx, r)
        Hxx_inv = torch.linalg.inv_ex(Hxx)[0]               # [V,6,6]
        Heff = Hii - torch.einsum("vij,vjk,vlk->il", Hix, Hxx_inv, Hix)
        geff = gi - torch.einsum("vij,vjk,vk->i", Hix, Hxx_inv, gx)
        di = -solve_spd(Heff, geff)
        if zero_skew:
            di = torch.where(col == 2, 0.0, di)
        dx = -torch.einsum("vij,vj->vi", Hxx_inv,
                           gx + torch.einsum("vji,j->vi", Hix, di))
        dR, dt = se3.exp_se3(dx)
        cand = (intr + di, dR @ R_, (dR @ t_[..., None])[..., 0] + dt)
        c0 = torch.sum(r * r)
        c1 = cost_of(*cand)
        good = torch.isfinite(c1) & (c1 < c0)
        intr, R_, t_ = (torch.where(good, b, a)
                        for a, b in zip((intr, R_, t_), cand))
        lam = torch.clamp(torch.where(good, lam * 0.3, lam * 10.0),
                          1e-10, 1e6)
    proj, _, _ = _brown_project_and_jac(intr, R_, t_, w3)
    return intr, R_, t_, proj


def _initial_poses(Hs, K0):
    Rs, ts = zip(*(extrinsics_from_homography(H, K0) for H in Hs))
    return np.stack(Rs), np.stack(ts)


def calibrate_mono_planar(world_xy, obs, iterations: int = 30,
                          zero_skew: bool = True, obs_mask=None,
                          device=None) -> CalibrationResult:
    """The Zhang99 pipeline (CalibrateMonoPlanar.process:160).

    world_xy [N, 2] planar target coordinates; obs [V, N, 2] pixels per
    view (V >= 3); ``obs_mask`` [V, N] bool marks the corners found in each
    view (the others are left out of every stage).  The homographies and
    the refine run on ``device`` (default the card), the closed form
    between them on the host."""
    dev = resolve_device(device)
    world_xy = np.asarray(world_xy, np.float64)
    obs = np.asarray(obs, np.float64)
    V = obs.shape[0]
    if obs_mask is None:
        obs_mask = np.ones(obs.shape[:2], bool)
    else:
        obs_mask = np.asarray(obs_mask, bool)
        counts = obs_mask.sum(axis=1)
        if (counts < 4).any():
            bad = np.nonzero(counts < 4)[0].tolist()
            raise ValueError(
                f"views {bad} have fewer than 4 unmasked corners "
                f"(counts {counts[bad].tolist()}) — the per-view "
                "homography is underdetermined; drop those views")

    if obs_mask.all():
        Hs = homographies_per_view(world_xy, obs, dev).cpu().numpy()
    else:
        Hs = np.stack([
            homographies_per_view(world_xy[obs_mask[v]],
                                  obs[v][obs_mask[v]][None], dev)[0]
            .cpu().numpy() for v in range(V)])
    K0 = k_from_homographies(Hs)
    if zero_skew:
        K0[0, 1] = 0.0
    Rs, ts = _initial_poses(Hs, K0)
    k1, k2 = linear_radial_estimate(world_xy, obs, K0, Rs, ts,
                                    obs_mask=obs_mask)

    T = lambda a: torch.as_tensor(a, dtype=_F64, device=dev)
    intr0 = T([K0[0, 0], K0[1, 1], K0[0, 1], K0[0, 2], K0[1, 2], k1, k2])
    intr, Rs_out, ts_out, proj = _refine_brown(
        intr0, T(Rs), T(ts), _planar3(T(world_xy)), T(obs),
        torch.as_tensor(obs_mask, device=dev)[..., None], iterations,
        zero_skew)
    fx, fy, skew, cx, cy, k1, k2 = intr.cpu().numpy()
    K = np.array([[fx, skew, cx], [0, fy, cy], [0, 0, 1.0]])
    err2 = np.sum((proj.cpu().numpy() - obs) ** 2, axis=-1)
    rmse = float(np.sqrt(np.mean(err2[obs_mask])))
    return CalibrationResult(K, (float(k1), float(k2)),
                             Rs_out.cpu().numpy(), ts_out.cpu().numpy(), rmse)


def _project_all_omni(params, world_xy, n_views: int):
    """Universal-omni projection of every target point in every view
    (Zhang99CameraUniversalOmni.java:39: ray -> unit sphere -> +xi along z
    -> Brown distortion -> pinhole).  params [8 + 6V] = (fx, fy, skew, cx,
    cy, k1, k2, xi, per-view se3); returns [V, N, 2]."""
    fx, fy, skew, cx, cy, k1, k2, xi = params[:8]
    R, t = se3.exp_se3(params[8:].reshape(n_views, 6))
    Xc = _planar3(world_xy) @ R.transpose(-1, -2) + t[:, None, :]
    n = torch.sqrt(torch.sum(Xc * Xc, dim=-1, keepdim=True))
    n = torch.where(n < 1e-12, 1.0, n)
    s = Xc / n
    sz = s[..., 2:] + xi
    sz = torch.where(torch.abs(sz) < 1e-9, 1e-9, sz)
    xn = s[..., :2] / sz
    r2 = torch.sum(xn ** 2, dim=-1, keepdim=True)
    xd = xn * (1.0 + k1 * r2 + k2 * r2 * r2)
    return torch.stack([fx * xd[..., 0] + skew * xd[..., 1] + cx,
                        fy * xd[..., 1] + cy], dim=-1)


def calibrate_mono_omni(world_xy, obs, iterations: int = 40,
                        zero_skew: bool = True,
                        mirror_inits=(0.0, 0.5, 1.0, 1.5), device=None):
    """Zhang99 with the universal-omni (fisheye) camera
    (Zhang99CameraUniversalOmni.java:39): the Brown pipeline's linear
    start, then damped GN over the intrinsics, the mirror offset xi and
    every pose, with forward-mode Jacobians.  The mirror offset is seeded
    by guess and check over ``mirror_inits`` (one host read a seed) and the
    best-converged solution wins."""
    dev = resolve_device(device)
    world_xy = np.asarray(world_xy, np.float64)
    obs = np.asarray(obs, np.float64)
    V = obs.shape[0]

    Hs = homographies_per_view(world_xy, obs, dev).cpu().numpy()
    K0 = k_from_homographies(Hs)
    if zero_skew:
        K0[0, 1] = 0.0
    Rs, ts = _initial_poses(Hs, K0)
    w0 = se3.log_so3(torch.as_tensor(Rs, device=dev)).cpu().numpy()
    xi0 = np.concatenate([w0, ts], axis=1).reshape(-1)
    wj = torch.as_tensor(world_xy, device=dev)
    obsj = torch.as_tensor(obs, device=dev)
    n_par = 8 + 6 * V
    eye = torch.eye(n_par, dtype=_F64, device=dev)
    col = torch.arange(n_par, device=dev)

    def residual(p):
        return (_project_all_omni(p, wj, V) - obsj).reshape(-1)

    def refine(p):
        lam = torch.tensor(1e-3, dtype=_F64, device=dev)
        for _ in range(iterations):
            r = residual(p)
            J = torch.func.jacfwd(residual)(p)
            step = -solve_spd(J.T @ J + lam * eye, J.T @ r)
            if zero_skew:
                step = torch.where(col == 2, 0.0, step)
            c0 = torch.sum(r * r)
            c1 = torch.sum(residual(p + step) ** 2)
            good = torch.isfinite(c1) & (c1 < c0)
            p = torch.where(good, p + step, p)
            lam = torch.clamp(torch.where(good, lam * 0.3, lam * 10.0),
                              1e-10, 1e6)
        return p, torch.sum(residual(p) ** 2)

    best_p, best_c = None, np.inf
    for mi in mirror_inits:
        # a larger xi widens the image of a ray: scale the focal guess
        params0 = torch.as_tensor(np.concatenate(
            [[K0[0, 0] * (1.0 + mi), K0[1, 1] * (1.0 + mi), K0[0, 1],
              K0[0, 2], K0[1, 2], 0.0, 0.0, mi], xi0]), device=dev)
        p, c = refine(params0)
        c = float(c)
        if np.isfinite(c) and c < best_c:
            best_p, best_c = p, c

    if best_p is None:
        raise ValueError(
            "omni calibration failed: every mirror-offset seed diverged "
            "(degenerate target geometry or non-finite observations)")
    fx, fy, skew, cx, cy, k1, k2, mirror = best_p[:8].cpu().numpy()
    K = np.array([[fx, skew, cx], [0, fy, cy], [0, 0, 1.0]])
    R, t = se3.exp_se3(best_p[8:].reshape(V, 6))
    proj = _project_all_omni(best_p, wj, V).cpu().numpy()
    rmse = float(np.sqrt(np.mean(np.sum((proj - obs) ** 2, axis=-1))))
    return CalibrationResult(K, (float(k1), float(k2)), R.cpu().numpy(),
                             t.cpu().numpy(), rmse,
                             mirror_offset=float(mirror))


def calibrate_stereo_planar(world_xy, obs_left, obs_right,
                            iterations: int = 30, device=None):
    """CalibrateStereoPlanar analog: each camera calibrated mono on the same
    target views, then the per-view left -> right transforms averaged (the
    rotations by their chordal mean).  Returns (left_result, right_result,
    R_l2r, t_l2r)."""
    left = calibrate_mono_planar(world_xy, obs_left, iterations,
                                 device=device)
    right = calibrate_mono_planar(world_xy, obs_right, iterations,
                                  device=device)
    # x_r = R_r R_lᵀ x_l + (t_r - R_r R_lᵀ t_l)
    Rs, ts = [], []
    for v in range(left.rotations.shape[0]):
        Rrel = right.rotations[v] @ left.rotations[v].T
        Rs.append(Rrel)
        ts.append(right.translations[v] - Rrel @ left.translations[v])
    Rmean = se3.project_to_so3(torch.as_tensor(
        np.mean(Rs, axis=0), device=resolve_device(device))).cpu().numpy()
    return left, right, Rmean, np.mean(ts, axis=0)
