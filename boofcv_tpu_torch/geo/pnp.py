"""Perspective-n-Point pose estimation (port of ``boofcv_tpu/geo/pnp.py``).

Reference analog: boofcv-geo alg/geo/pose/P3PGrunert.java,
P3PFinsterwalder.java, PnPLepetitEPnP.java (EPnP), the DLT PnP, planar
PnP and the nonlinear refiner (PnPJacobianRodrigues.java).  P3P is batched over hypotheses; the refine is
Gauss-Newton on se(3) with the analytic reprojection Jacobian.
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch.geo import se3
from boofcv_tpu_torch.geo.epipolar import homography_dlt
from boofcv_tpu_torch.geo.smalllinalg import (_eigh_sym, cubic_roots, det3,
                                              inv_spd, quartic_roots, solve33)
from boofcv_tpu_torch.kernels import gn_pose
from boofcv_tpu_torch.utils.profiling import span


def absolute_orientation(world: torch.Tensor, cam: torch.Tensor,
                         dtype=torch.float64):
    """Rigid alignment world -> camera minimising ||R w + t - c|| (Horn's
    quaternion method, batched).  world, cam: [..., N, 3].  Returns
    (R [..., 3, 3], t [..., 3]); R from the eigenvector of the largest
    eigenvalue of the 4x4 quaternion matrix."""
    world = world.to(dtype)
    cam = cam.to(dtype)
    wm = torch.mean(world, dim=-2, keepdim=True)
    cm = torch.mean(cam, dim=-2, keepdim=True)
    M = (world - wm).transpose(-1, -2) @ (cam - cm)          # [..., 3, 3]
    m = lambda i, j: M[..., i, j]
    k0 = m(0, 0) + m(1, 1) + m(2, 2)
    K4 = torch.stack([
        torch.stack([k0, m(1, 2) - m(2, 1), m(2, 0) - m(0, 2),
                     m(0, 1) - m(1, 0)], dim=-1),
        torch.stack([m(1, 2) - m(2, 1), m(0, 0) - m(1, 1) - m(2, 2),
                     m(0, 1) + m(1, 0), m(0, 2) + m(2, 0)], dim=-1),
        torch.stack([m(2, 0) - m(0, 2), m(0, 1) + m(1, 0),
                     -m(0, 0) + m(1, 1) - m(2, 2), m(1, 2) + m(2, 1)],
                    dim=-1),
        torch.stack([m(0, 1) - m(1, 0), m(0, 2) + m(2, 0),
                     m(1, 2) + m(2, 1), -m(0, 0) - m(1, 1) + m(2, 2)],
                    dim=-1),
    ], dim=-2)
    _, vecs = _eigh_sym(K4)
    q = vecs[..., :, -1]
    w_, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w_),
                     2 * (x * z + y * w_)], dim=-1),
        torch.stack([2 * (x * y + z * w_), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w_)], dim=-1),
        torch.stack([2 * (x * z - y * w_), 2 * (y * z + x * w_),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)
    t = cm[..., 0, :] - (R @ wm[..., 0, :, None])[..., 0]
    return R, t


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


def _sym3(m00, m01, m02, m11, m12, m22):
    return torch.stack([torch.stack([m00, m01, m02], -1),
                        torch.stack([m01, m11, m12], -1),
                        torch.stack([m02, m12, m22], -1)], -2)


def _column(M, i):
    """Column i [...] of M [..., 3, 3]."""
    return torch.take_along_dim(M, i[..., None, None].expand(
        i.shape + (3, 1)), dim=-1)[..., 0]


def p3p_finsterwalder(world: torch.Tensor, obs: torch.Tensor,
                      dtype=torch.float64):
    """Finsterwalder's P3P (P3PFinsterwalder.java), batched; the interface
    of :func:`p3p_grunert`.

    With u = s2/s1, v = s3/s1 the two side-ratio constraints are conics in
    (u, v); a root lambda of a cubic makes their pencil degenerate, it
    splits into two lines, and each line meets the second conic in two
    points.  As in the reference, the cubic's three-root branch promotes
    the rest of a float32 solve to float64, and the final rigid alignment
    runs in float32 whatever ``dtype`` is."""
    world = world.to(dtype)
    obs = obs.to(dtype)
    f = torch.cat([obs, torch.ones_like(obs[..., :1])], dim=-1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    P1, P2, P3 = world[..., 0, :], world[..., 1, :], world[..., 2, :]
    a2 = torch.sum((P2 - P3) ** 2, -1)
    b2 = torch.sum((P1 - P3) ** 2, -1)
    c2 = torch.sum((P1 - P2) ** 2, -1)
    ca = torch.sum(f2 * f3, -1)
    cb = torch.sum(f1 * f3, -1)
    cg = torch.sum(f1 * f2, -1)
    z = torch.zeros_like(a2)

    # conic (i):  -b^2 u^2 + 2 b^2 ca uv + (a^2-b^2) v^2 - 2 a^2 cb v + a^2
    Q1 = _sym3(-b2, b2 * ca, z, a2 - b2, -a2 * cb, a2)
    # conic (ii): (a^2-c^2) u^2 + 2 c^2 ca uv - c^2 v^2 - 2 a^2 cg u + a^2
    Q2 = _sym3(a2 - c2, c2 * ca, -a2 * cg, -c2, z, a2)

    # det(Q1 + lam Q2) = 0, a cubic in lam interpolated at lam = 0, +-1, inf
    d0 = det3(Q1)
    d3 = det3(Q2)
    dp = det3(Q1 + Q2)
    dm = det3(Q1 - Q2)
    c1 = (dp - dm) / 2.0 - d3
    c2_ = (dp + dm) / 2.0 - d0
    lam, real = cubic_roots(d3, c2_, c1, d0)           # [..., 3]
    # the first real root (any root of the cubic works in theory)
    first = torch.argmax(real.to(torch.uint8), dim=-1, keepdim=True)
    lam0 = torch.take_along_dim(torch.where(real, lam, float("nan")), first,
                                dim=-1)[..., 0]
    Q = Q1 + lam0[..., None, None] * Q2

    # split the degenerate conic Q (rank 2) into two lines: adj(Q) = -p pᵀ
    # with p the lines' intersection; D = Q + [p]x has rank-1 rows and
    # columns proportional to the two lines
    def cof(i, j, k, l):
        return Q[..., i, j] * Q[..., k, l] - Q[..., i, l] * Q[..., k, j]

    B = _sym3(cof(1, 1, 2, 2), cof(1, 2, 2, 0), cof(1, 0, 2, 1),
              cof(0, 0, 2, 2), cof(0, 1, 2, 0), cof(0, 0, 1, 1))
    diag = -torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], -1)
    i_best = torch.argmax(diag, dim=-1)
    di = torch.take_along_dim(diag, i_best[..., None], dim=-1)[..., 0]
    di = torch.sqrt(torch.clamp(di, min=1e-30))
    p = _column(B, i_best) / di[..., None]
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    zp = torch.zeros_like(px)
    Px = torch.stack([torch.stack([zp, -pz, py], -1),
                      torch.stack([pz, zp, -px], -1),
                      torch.stack([-py, px, zp], -1)], -2)
    D = Q + Px
    # the row of largest norm is line l, the column of largest norm line m
    ri = torch.argmax(torch.sum(D * D, -1), -1)
    l_line = _column(D.transpose(-1, -2), ri)
    ci = torch.argmax(torch.sum(D * D, -2), -1)
    m_line = _column(D, ci)

    def line_conic(line):
        """Conic (ii) on the line lu u + lv v + lw = 0, parameterized by
        the coordinate with the larger coefficient: two (u, v) [..., 2, 2]
        and their flags [..., 2]."""
        lu, lv, lw = line[..., 0], line[..., 1], line[..., 2]
        use_u = torch.abs(lu) >= torch.abs(lv)
        A = Q2[..., 0, 0]
        Bq = 2 * Q2[..., 0, 1]
        Cq = Q2[..., 1, 1]
        Dq = 2 * Q2[..., 0, 2]
        Eq = 2 * Q2[..., 1, 2]
        Fq = Q2[..., 2, 2]
        lus = torch.where(torch.abs(lu) < 1e-30, 1e-30, lu)
        lvs = torch.where(torch.abs(lv) < 1e-30, 1e-30, lv)
        # u = al_u v + be_u
        al_u = -lv / lus
        be_u = -lw / lus
        qa_u = A * al_u ** 2 + Bq * al_u + Cq
        qb_u = 2 * A * al_u * be_u + Bq * be_u + Dq * al_u + Eq
        qc_u = A * be_u ** 2 + Dq * be_u + Fq
        # v = al_v u + be_v
        al_v = -lu / lvs
        be_v = -lw / lvs
        qa_v = Cq * al_v ** 2 + Bq * al_v + A
        qb_v = 2 * Cq * al_v * be_v + Bq * be_v + Eq * al_v + Dq
        qc_v = Cq * be_v ** 2 + Eq * be_v + Fq
        qa = torch.where(use_u, qa_u, qa_v)
        qb = torch.where(use_u, qb_u, qb_v)
        qc = torch.where(use_u, qc_u, qc_v)
        disc = qb * qb - 4 * qa * qc
        ok = (disc >= 0) & (torch.abs(qa) > 1e-30)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        qas = torch.where(torch.abs(qa) < 1e-30, 1e-30, qa)
        outs = []
        for r in ((-qb + sq) / (2 * qas), (-qb - sq) / (2 * qas)):
            uu = torch.where(use_u, al_u * r + be_u, r)
            vv = torch.where(use_u, r, al_v * r + be_v)
            outs.append(torch.stack([uu, vv], -1))
        return torch.stack(outs, -2), torch.stack([ok, ok], -1)

    uv_l, ok_l = line_conic(l_line)
    uv_m, ok_m = line_conic(m_line)
    uv = torch.cat([uv_l, uv_m], dim=-2)                # [..., 4, 2]
    okq = torch.cat([ok_l, ok_m], dim=-1)               # [..., 4]

    u = uv[..., 0]
    v = uv[..., 1]
    den1 = 1.0 + u * u - 2.0 * u * cg[..., None]
    den1 = torch.where(torch.abs(den1) < 1e-30, 1e-30, den1)
    s1 = torch.sqrt(torch.clamp(c2[..., None] / den1, min=0.0))
    s2 = u * s1
    s3 = v * s1
    ok = (okq & (s1 > 0) & (s2 > 0) & (s3 > 0) & torch.isfinite(u)
          & torch.isfinite(v))

    cam = torch.stack([s1[..., None] * f1[..., None, :],
                       s2[..., None] * f2[..., None, :],
                       s3[..., None] * f3[..., None, :]], dim=-2)
    worldr = world[..., None, :, :].expand(cam.shape)
    R, t = rigid_from_three_points(worldr.to(torch.float32),
                                   cam.to(torch.float32))
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


def _gn_pose_f32(R, t, world, obs, wgt, iterations: int, damping: float,
                 step_tol: float):
    """The float32 GN loop, then two Newton-polar steps R(3I - R^T R)/2 in
    float64 that restore orthogonality: the plain version of
    ``kernels/gn_pose`` (CPU tensors take it).  Returns float64 R and t."""
    R, t = _gn_pose_loop(R, t, world, obs, wgt, iterations, damping,
                         torch.float32, step_tol)
    R = R.to(torch.float64)
    eye = torch.eye(3, dtype=torch.float64, device=R.device)
    for _ in range(2):
        R = R @ (1.5 * eye - 0.5 * (R.transpose(-1, -2) @ R))
    return R, t.to(torch.float64)


def _kernel_input(x, shape):
    """``x`` as ``kernels/gn_pose`` takes it and the plain loop reads it:
    float32 or float64 (any other dtype cast to float32, as the loop casts
    it), broadcast to ``shape``, contiguous."""
    if x.dtype != torch.float32 and x.dtype != torch.float64:
        x = x.to(torch.float32)
    if x.shape != shape:
        x = x.expand(shape)
    return x.contiguous()


def gauss_newton_pose(R, t, world, obs, weights=None, iterations: int = 10,
                      damping: float = 1e-8, polish_iterations: int = 2):
    """Weighted GN pose refinement with the analytic reprojection Jacobian,
    of one pose or of B poses with a leading axis on every argument.

    The convergence iterations run in float32, then two Newton-polar steps
    R(3I - R^T R)/2 in float64 restore orthogonality, then
    ``polish_iterations`` float64 steps (0 on the VO path).  CPU tensors
    take the plain version of the first two stages; CUDA tensors one launch
    of ``kernels/gn_pose`` for both, whatever B is.  world's leading shape
    is the problems'; the other arguments broadcast to it, in any real
    dtype, on either route."""
    with span("refine"):
        if weights is None:
            weights = torch.ones(world.shape[:-1], dtype=torch.float64,
                                 device=world.device)
        fast_iters = iterations - polish_iterations
        if fast_iters > 0:
            if world.device.type == "cpu":
                R, t = _gn_pose_f32(R, t, world, obs, weights, fast_iters,
                                    max(damping, 1e-12), 1e-6)
            else:
                shape = world.shape
                lead, n = shape[:-2], shape[-2:-1]
                R, t = gn_pose.gn_pose_cuda(
                    _kernel_input(R, lead + (3, 3)),
                    _kernel_input(t, lead + (3,)),
                    _kernel_input(world, shape),
                    _kernel_input(obs, lead + n + (2,)),
                    _kernel_input(weights, lead + n), fast_iters,
                    max(damping, 1e-12), 1e-6)
        if polish_iterations > 0:
            R, t = _gn_pose_loop(R, t, world, obs, weights,
                                 min(polish_iterations, iterations),
                                 damping, torch.float64, 1e-14)
        return R.to(torch.float64), t.to(torch.float64)


def refine_pnp(R, t, world, obs, iterations: int = 10, damping: float = 1e-8):
    """Gauss-Newton refinement of (R, t) minimizing reprojection error.

    Replaces the reference's ddogleg LM refiner (PnPRefineRodrigues).
    world: [N, 3], obs: [N, 2] normalized coords.  Runs a fixed number of
    iterations; each iteration is one 6x6 solve."""
    return gauss_newton_pose(R, t, world, obs, iterations=iterations,
                             damping=damping)


def pnp_dlt(world: torch.Tensor, obs: torch.Tensor):
    """DLT PnP for N >= 6 points (PoseFromPairLinear6 analog).  world:
    [..., N, 3]; obs: [..., N, 2] normalized coords.  Returns (R, t)
    camera-from-world, R projected onto SO(3); the sign of the null vector
    is fixed by putting the points in front of the camera."""
    world = world.to(torch.float64)
    obs = obs.to(torch.float64)
    X, Y, Z = world[..., 0], world[..., 1], world[..., 2]
    x, y = obs[..., 0], obs[..., 1]
    z = torch.zeros_like(X)
    o = torch.ones_like(X)
    r1 = torch.stack([X, Y, Z, o, z, z, z, z, -x * X, -x * Y, -x * Z, -x],
                     dim=-1)
    r2 = torch.stack([z, z, z, z, X, Y, Z, o, -y * X, -y * Y, -y * Z, -y],
                     dim=-1)
    A = torch.cat([r1, r2], dim=-2)                        # [..., 2N, 12]
    _, v = _eigh_sym(A.transpose(-1, -2) @ A)
    p = v[..., :, 0]
    P = p.reshape(p.shape[:-1] + (3, 4))
    Xh = torch.cat([world, torch.ones_like(world[..., :1])], dim=-1)
    depth = torch.einsum("...j,...nj->...n", P[..., 2, :], Xh)
    sign = torch.where(torch.mean(torch.sign(depth), dim=-1, keepdim=True)
                       < 0, -1.0, 1.0)
    P = P * sign[..., None]
    scale = torch.linalg.norm(P[..., 2, :3], dim=-1)
    M = P[..., :3] / scale[..., None, None]
    t = P[..., 3] / scale[..., None]
    return se3.project_to_so3(M), t


def epnp(world: torch.Tensor, obs: torch.Tensor,
         refine_iterations: int = 10):
    """EPnP (PnPLepetitEPnP.java analog): PnP through 4 control points
    (the centroid and the principal axes).  world: [N, 3], obs: [N, 2]
    normalized coords.  The null-space dimension-1 and -2 solutions are
    both formed, the one with the smaller reprojection error seeds
    ``refine_iterations`` of the GN refine.  Returns (R, t)."""
    world = world.to(torch.float64)
    obs = obs.to(torch.float64)
    n = world.shape[0]
    dev = world.device

    c0 = torch.mean(world, dim=0)
    d = world - c0
    w_eig, v_eig = _eigh_sym(d.T @ d / n)
    scale = torch.sqrt(torch.clamp(w_eig, min=1e-12))
    ctrl = torch.cat([c0[None], c0[None] + (v_eig * scale[None, :]).T])

    # barycentric coordinates [N, 4], each row summing to 1
    ones4 = torch.ones((1, 4), dtype=torch.float64, device=dev)
    Cmat = torch.cat([ctrl.T, ones4])
    rhs = torch.cat([world.T, torch.ones((1, n), dtype=torch.float64,
                                         device=dev)])
    alpha = (inv_spd(Cmat.T @ Cmat) @ (Cmat.T @ rhs)).T

    # M x = 0, x the camera coordinates of the 4 control points
    u = obs[:, 0]
    v = obs[:, 1]
    zero = torch.zeros_like(alpha)
    row_x = torch.stack([alpha, zero, -alpha * u[:, None]],
                        dim=-1).reshape(n, 12)
    row_y = torch.stack([zero, alpha, -alpha * v[:, None]],
                        dim=-1).reshape(n, 12)
    Mm = torch.cat([row_x, row_y])
    _, V = _eigh_sym(Mm.T @ Mm)
    v1 = V[:, 0].reshape(4, 3)
    v2 = V[:, 1].reshape(4, 3)

    iu, ju = torch.triu_indices(4, 4, offset=1, device=dev)
    dw = torch.linalg.norm(ctrl[iu] - ctrl[ju], dim=1)

    def pose_from_ctrl(cc):
        cam = alpha @ cc
        sign = torch.where(torch.mean(cam[:, 2]) < 0, -1.0, 1.0)
        return absolute_orientation(world, cam * sign)

    d1 = torch.linalg.norm(v1[iu] - v1[ju], dim=1)
    beta1 = torch.sum(d1 * dw) / torch.clamp(torch.sum(d1 * d1), min=1e-30)
    Ra, ta = pose_from_ctrl(beta1 * v1)

    e1 = v1[iu] - v1[ju]
    e2 = v2[iu] - v2[ju]
    L = torch.stack([torch.sum(e1 * e1, 1), 2 * torch.sum(e1 * e2, 1),
                     torch.sum(e2 * e2, 1)], dim=1)         # [6, 3]
    bb = solve33(L.T @ L, L.T @ (dw * dw))
    b1 = torch.sqrt(torch.clamp(bb[0], min=1e-30))
    b2 = torch.sign(bb[1]) * torch.sqrt(torch.clamp(bb[2], min=0.0))
    Rb, tb = pose_from_ctrl(b1 * v1 + b2 * v2)

    def total(R, t):
        e = reprojection_error_sq(R, t, world, obs)
        return torch.sum(torch.where(torch.isfinite(e), e, 1e12))
    better = total(Ra, ta) <= total(Rb, tb)
    R = torch.where(better, Ra, Rb)
    t = torch.where(better, ta, tb)
    if refine_iterations > 0:
        R, t = gauss_newton_pose(R, t, world, obs,
                                 iterations=refine_iterations)
    return R, t


def pnp_planar(world_xy: torch.Tensor, obs: torch.Tensor,
               refine_iterations: int = 10):
    """Planar PnP (IPPE use case): pose from N >= 4 points on the world
    plane z = 0.  world_xy: [N, 2]; obs: [N, 2] normalized coords.  The
    plane -> image homography [r1 r2 t] is decomposed (points in front)
    and polished by the GN refine.  Returns (R, t) camera-from-world."""
    world_xy = world_xy.to(torch.float64)
    obs = obs.to(torch.float64)
    H = homography_dlt(world_xy, obs)
    s = 1.0 / torch.linalg.norm(H[:, 0])
    s = torch.where(H[2, 2] * s < 0, -s, s)
    r1 = H[:, 0] * s
    r2 = H[:, 1] * s
    R = se3.project_to_so3(torch.stack(
        [r1, r2, torch.linalg.cross(r1, r2)], dim=1))
    t = H[:, 2] * s
    world3 = torch.cat([world_xy, torch.zeros_like(world_xy[:, :1])], 1)
    return refine_pnp(R, t, world3, obs, iterations=refine_iterations)
