"""Control: the refine replaced by the reference's least-squares pose,
computed one precision below the configuration's.

``geo/pnp.gauss_newton_pose``, where RANSAC refines its best hypothesis
over the inliers, is replaced by ``reference/vo_ref.refine_pose``'s
Gauss-Newton (30 iterations on the weighted reprojection error, the
update ``R <- exp(w) R``, ``t <- exp(w) t + v``) in float32 on the card,
with both operands of every matrix product rounded to TF32 (10 mantissa
bits, to nearest) first: what PyTorch's TF32 switch does where it takes
effect.  The configuration states float32 with TF32 off for these
products.  It runs alike on one stream and on a fleet's stacked poses,
where cuBLAS would keep the batched shapes in float32 whatever the switch
says."""

import torch

ITERATIONS = 30


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b):
    return _tf32(a) @ _tf32(b)


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _exp_so3(w):
    th = torch.linalg.norm(w, dim=-1)[..., None, None]
    k = _hat(w) / torch.clamp(th, min=1e-12)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(th) * k + (1 - torch.cos(th)) * _mm(k, k)


def refine_pose(R, t, world, obs, weights=None, **_):
    """(R, t) -> the least-squares pose over the weighted tracks, leading
    axes as the program's: R [..., 3, 3], t [..., 3], world [..., N, 3],
    obs [..., N, 2], weights [..., N]."""
    out_dtype = R.dtype
    f = torch.float32
    R, t, world, obs = R.to(f), t.to(f), world.to(f), obs.to(f)
    w = (torch.ones(world.shape[:-1], dtype=f, device=world.device)
         if weights is None else weights.to(f))
    lead = world.shape[:-2]
    damp = 1e-9 * torch.eye(6, dtype=f, device=world.device)
    for _ in range(ITERATIONS):
        Xc = _mm(world, R.transpose(-1, -2)) + t[..., None, :]
        iz = 1.0 / Xc[..., 2]
        res = Xc[..., :2] * iz[..., None] - obs
        zero = torch.zeros_like(iz)
        A = torch.stack([
            torch.stack([iz, zero, -Xc[..., 0] * iz * iz], -1),
            torch.stack([zero, iz, -Xc[..., 1] * iz * iz], -1)], -2)
        J = torch.cat([-_mm(A, _hat(Xc)), A], -1).reshape(lead + (-1, 6))
        Jw = J * w.repeat_interleave(2, -1)[..., None]
        H = _mm(Jw.transpose(-1, -2), J) + damp
        g = _mm(Jw.transpose(-1, -2), res.reshape(lead + (-1, 1)))
        step = torch.linalg.solve_ex(H, -g)[0][..., 0]
        dR = _exp_so3(step[..., :3])
        R = _mm(dR, R)
        t = _mm(dR, t[..., None])[..., 0] + step[..., 3:]
    return R.to(out_dtype), t.to(out_dtype)


def apply(port):
    from boofcv_tpu_torch.geo import pnp
    orig = pnp.gauss_newton_pose
    pnp.gauss_newton_pose = refine_pose

    def undo():
        pnp.gauss_newton_pose = orig
    return undo
