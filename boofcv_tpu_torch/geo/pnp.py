"""Perspective-n-Point pose estimation (port of ``boofcv_tpu/geo/pnp.py``:
``rigid_from_three_points``, ``p3p_grunert``, ``reprojection_error_sq``,
``_gn_pose_loop``, ``gauss_newton_pose``).

Reference analog: boofcv-geo alg/geo/pose/P3PGrunert.java and the
nonlinear refiner (PnPJacobianRodrigues.java).  P3P is batched over
hypotheses; the refine is Gauss-Newton on se(3) with the analytic
reprojection Jacobian.
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch.geo import se3
from boofcv_tpu_torch.geo.smalllinalg import quartic_roots


def rigid_from_three_points(world: torch.Tensor, cam: torch.Tensor):
    """Closed-form rigid alignment of exactly three exact correspondences.

    world, cam: [..., 3, 3] (three points, xyz).  Returns (R, t) with
    cam_i = R @ world_i + t, from the orthonormal triangle frames."""
    def frame(p):
        u = p[..., 1, :] - p[..., 0, :]
        v = p[..., 2, :] - p[..., 0, :]
        e1 = u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True),
                             min=1e-30)
        w = v - torch.sum(v * e1, dim=-1, keepdim=True) * e1
        e2 = w / torch.clamp(torch.linalg.norm(w, dim=-1, keepdim=True),
                             min=1e-30)
        e3 = torch.linalg.cross(e1, e2, dim=-1)
        return torch.stack([e1, e2, e3], dim=-1)      # columns
    Bw = frame(world)
    Bc = frame(cam)
    R = Bc @ Bw.transpose(-1, -2)
    cw = torch.mean(world, dim=-2)
    cc = torch.mean(cam, dim=-2)
    t = cc - (R @ cw[..., None])[..., 0]
    return R, t


def p3p_grunert(world: torch.Tensor, obs: torch.Tensor,
                dtype=torch.float64):
    """Grunert's P3P (P3PGrunert.java), batched over hypotheses.

    world: [..., 3, 3] three 3D points; obs: [..., 3, 2] normalized image
    coords.  Returns (R [..., 4, 3, 3], t [..., 4, 3], valid [..., 4]),
    camera-from-world, one solution per quartic root.  ``dtype=float32``
    is the RANSAC hypothesis path."""
    world = world.to(dtype)
    obs = obs.to(dtype)
    f = torch.cat([obs, torch.ones_like(obs[..., :1])], dim=-1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    P1, P2, P3 = world[..., 0, :], world[..., 1, :], world[..., 2, :]
    a = torch.linalg.norm(P2 - P3, dim=-1)
    b = torch.linalg.norm(P1 - P3, dim=-1)
    c = torch.linalg.norm(P1 - P2, dim=-1)
    cos_alpha = torch.sum(f2 * f3, dim=-1)
    cos_beta = torch.sum(f1 * f3, dim=-1)
    cos_gamma = torch.sum(f1 * f2, dim=-1)

    a2, b2, c2 = a * a, b * b, c * c
    q1 = (a2 - c2) / b2
    q2 = (a2 + c2) / b2
    q3 = (b2 - c2) / b2
    q4 = (b2 - a2) / b2

    A4 = (q1 - 1.0) ** 2 - 4.0 * c2 / b2 * cos_alpha ** 2
    A3 = 4.0 * (q1 * (1.0 - q1) * cos_beta
                - (1.0 - q2) * cos_alpha * cos_gamma
                + 2.0 * c2 / b2 * cos_alpha ** 2 * cos_beta)
    A2 = 2.0 * (q1 ** 2 - 1.0
                + 2.0 * q1 ** 2 * cos_beta ** 2
                + 2.0 * q3 * cos_alpha ** 2
                - 4.0 * q2 * cos_alpha * cos_beta * cos_gamma
                + 2.0 * q4 * cos_gamma ** 2)
    A1 = 4.0 * (-q1 * (1.0 + q1) * cos_beta
                + 2.0 * a2 / b2 * cos_gamma ** 2 * cos_beta
                - (1.0 - q2) * cos_alpha * cos_gamma)
    A0 = (1.0 + q1) ** 2 - 4.0 * a2 / b2 * cos_gamma ** 2

    v, real = quartic_roots(A4, A3, A2, A1, A0)       # [..., 4]

    cb = cos_beta[..., None]
    ca = cos_alpha[..., None]
    cg = cos_gamma[..., None]
    q1e = q1[..., None]
    c2e = c2[..., None]
    num = (-1.0 + q1e) * v * v - 2.0 * q1e * cb * v + 1.0 + q1e
    den = 2.0 * (cg - v * ca)
    den = torch.where(torch.abs(den) < 1e-30, 1e-30, den)
    u = num / den
    s1sq_den = 1.0 + u * u - 2.0 * u * cg
    s1sq_den = torch.where(torch.abs(s1sq_den) < 1e-30, 1e-30, s1sq_den)
    s1 = torch.sqrt(torch.clamp(c2e / s1sq_den, min=0.0))
    s2 = u * s1
    s3 = v * s1
    ok = real & (s1 > 0) & (s2 > 0) & (s3 > 0)

    cam1 = s1[..., None] * f1[..., None, :]           # [..., 4, 3]
    cam2 = s2[..., None] * f2[..., None, :]
    cam3 = s3[..., None] * f3[..., None, :]
    cam = torch.stack([cam1, cam2, cam3], dim=-2)     # [..., 4, 3pts, 3]
    worldr = world[..., None, :, :].expand(cam.shape)
    R, t = rigid_from_three_points(worldr.to(dtype), cam.to(dtype))
    return R.to(dtype), t.to(dtype), ok


def reprojection_error_sq(R, t, world, obs):
    """Squared reprojection error in normalized coords, batched.
    R: [..., 3, 3], t: [..., 3], world: [..., N, 3], obs: [..., N, 2] ->
    [..., N]; points behind the camera get +inf."""
    Xc = world @ R.transpose(-1, -2) + t[..., None, :]
    zc = Xc[..., 2]
    proj = Xc[..., :2] / torch.where(torch.abs(zc) < 1e-12, 1e-12,
                                     zc)[..., None]
    err = torch.sum((proj - obs) ** 2, dim=-1)
    return torch.where(zc <= 0, float("inf"), err)


def _gn_pose_loop(R, t, world, obs, wgt, iterations: int, damping: float,
                  dtype, step_tol: float):
    """One precision tier of the GN pose loop, for one problem (R [3, 3],
    world [N, 3]) or B independent ones with a leading axis on every
    argument.

    The reference's early-exit ``while_loop`` (continue while the last
    step's max|dx| > step_tol) becomes ``iterations`` fixed steps with a
    frozen flag: an update is applied only while every earlier step was
    above the tolerance, which reproduces the early exit exactly with no
    host sync.  The flag is per problem: under ``vmap`` the reference
    freezes each stream at its own exit.  ``cholesky_ex`` keeps the
    factorization's status on the device; a failed factorization yields
    NaN like the reference's."""
    world = world.to(dtype)
    obs = obs.to(dtype)
    wgt = wgt.to(dtype)
    R = R.to(dtype)
    t = t.to(dtype)
    eye6 = damping * torch.eye(6, dtype=dtype, device=world.device)
    lead = world.shape[:-2]
    frozen = torch.zeros(lead, dtype=torch.bool, device=world.device)
    w2 = wgt[..., None]
    T = lambda a: a.transpose(-1, -2)
    for _ in range(iterations):
        Xc = world @ T(R) + t[..., None, :]
        z = torch.where(torch.abs(Xc[..., 2]) < 1e-12, 1e-12, Xc[..., 2])
        inv_z = 1.0 / z
        x = Xc[..., 0] * inv_z
        y = Xc[..., 1] * inv_z
        r = torch.stack([x, y], -1) - obs                    # [N, 2]
        zeros = torch.zeros_like(inv_z)
        jw_x = torch.stack([-x * y, 1.0 + x * x, -y], -1)
        jw_y = torch.stack([-(1.0 + y * y), x * y, x], -1)
        jv_x = torch.stack([inv_z, zeros, -x * inv_z], -1)
        jv_y = torch.stack([zeros, inv_z, -y * inv_z], -1)
        J = torch.stack([torch.cat([jw_x, jv_x], -1),
                         torch.cat([jw_y, jv_y], -1)], -2)   # [N, 2, 6]
        Jf = J.reshape(lead + (-1, 6))
        H = T((J * w2[..., None]).reshape(lead + (-1, 6))) @ Jf + eye6
        g = T(Jf) @ (r * w2).reshape(lead + (-1, 1))
        L, info = torch.linalg.cholesky_ex(H)
        L = torch.where((info == 0)[..., None, None], L, float("nan"))
        y6 = torch.linalg.solve_triangular(L, g, upper=False)
        dx = -torch.linalg.solve_triangular(T(L), y6, upper=True)[..., 0]
        dR, dt = se3.exp_se3(dx)
        Rn, tn = se3.compose(dR, dt, R, t)
        R = torch.where(frozen[..., None, None], R, Rn)
        t = torch.where(frozen[..., None], t, tn)
        frozen = frozen | ~(torch.amax(torch.abs(dx), dim=-1) > step_tol)
    return R, t


def gauss_newton_pose(R, t, world, obs, weights=None, iterations: int = 10,
                      damping: float = 1e-8, polish_iterations: int = 2):
    """Weighted GN pose refinement with the analytic reprojection Jacobian,
    of one pose or of B poses with a leading axis on every argument.

    The convergence iterations run in float32, then two Newton-polar steps
    R(3I - R^T R)/2 in float64 restore orthogonality, then
    ``polish_iterations`` float64 steps (0 on the VO path)."""
    if weights is None:
        weights = torch.ones(world.shape[:-1], dtype=torch.float64,
                             device=world.device)
    fast_iters = iterations - polish_iterations
    if fast_iters > 0:
        R, t = _gn_pose_loop(R, t, world, obs, weights, fast_iters,
                             max(damping, 1e-12), torch.float32, 1e-6)
        R = R.to(torch.float64)
        eye = torch.eye(3, dtype=torch.float64, device=R.device)
        for _ in range(2):
            R = R @ (1.5 * eye - 0.5 * (R.transpose(-1, -2) @ R))
    if polish_iterations > 0:
        R, t = _gn_pose_loop(R, t, world, obs, weights,
                             min(polish_iterations, iterations),
                             damping, torch.float64, 1e-14)
    return R.to(torch.float64), t.to(torch.float64)
