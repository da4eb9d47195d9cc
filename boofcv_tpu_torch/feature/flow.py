"""Dense optical flow (port of ``boofcv_tpu/feature/flow.py``, whole):
Horn-Schunck single level and coarse to fine, Brox warping, dense KLT and
block matching.

Reference analog: boofcv-feature alg/flow/ — HornSchunck.java,
HornSchunckPyramid.java, BroxWarpingSpacial.java, DenseOpticalFlowKlt.java,
DenseOpticalFlowBlockPyramid.java.

Every solver is a fixed count of elementwise stencil passes over whole
fields (the reference's ``fori_loop``s): no host sync.  Horn-Schunck pads a
field once an iteration (edge-replicated) and reads its eight neighbours as
views of the padded copy; box sums are two prefix sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.ip import pyramid_ops
from boofcv_tpu_torch.ip.interpolate import bilinear


def _pad_edge(f: torch.Tensor) -> torch.Tensor:
    return F.pad(f[None], (1, 1, 1, 1), mode="replicate")[0]


def _shifted(p: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """The field whose 1-px edge-replicated copy is ``p``, sampled at
    (y+dy, x+dx)."""
    h, w = p.shape[0] - 2, p.shape[1] - 2
    return p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]


def _shift_edge(f: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """f sampled at (y+dy, x+dx) with EDGE clamping (a roll would wrap
    opposite edges together and invent brightness constraints at the
    borders)."""
    return _shifted(_pad_edge(f), dy, dx)


def _gradients_hs(i1, i2):
    """Horn-Schunck derivative estimates: central differences averaged over
    the two frames (HornSchunck.java's kernel)."""
    p1, p2 = _pad_edge(i1), _pad_edge(i2)
    dx = 0.5 * (_shifted(p1, 0, 1) - _shifted(p1, 0, -1)
                + _shifted(p2, 0, 1) - _shifted(p2, 0, -1)) * 0.5
    dy = 0.5 * (_shifted(p1, 1, 0) - _shifted(p1, -1, 0)
                + _shifted(p2, 1, 0) - _shifted(p2, -1, 0)) * 0.5
    return dx, dy, i2 - i1


def _laplacian_avg(f):
    """6/12-weighted neighbourhood average used by Horn-Schunck."""
    p = _pad_edge(f)
    up, dn = _shifted(p, -1, 0), _shifted(p, 1, 0)
    lf, rt = _shifted(p, 0, -1), _shifted(p, 0, 1)
    d1, d2 = _shifted(p, -1, -1), _shifted(p, -1, 1)
    d3, d4 = _shifted(p, 1, -1), _shifted(p, 1, 1)
    return (up + dn + lf + rt) / 6.0 + (d1 + d2 + d3 + d4) / 12.0


def horn_schunck(image1, image2, alpha: float = 20.0,
                 iterations: int = 200, init_flow=None):
    """Single-level Horn-Schunck (HornSchunck.java).  Returns (u, v)."""
    i1 = image1.to(torch.float32)
    i2 = image2.to(torch.float32)
    dx, dy, dt = _gradients_hs(i1, i2)
    if init_flow is None:
        u, v = torch.zeros_like(i1), torch.zeros_like(i1)
    else:
        u, v = init_flow
    den = alpha * alpha + dx * dx + dy * dy
    for _ in range(iterations):
        ub = _laplacian_avg(u)
        vb = _laplacian_avg(v)
        num = dx * ub + dy * vb + dt
        u = ub - dx * num / den
        v = vb - dy * num / den
    return u, v


def _warp_image(image, u, v):
    h, w = image.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=image.device),
        torch.arange(w, dtype=torch.float32, device=image.device),
        indexing="ij")
    return bilinear(image, ys + v, xs + u)


def horn_schunck_pyramid(image1, image2, alpha: float = 20.0,
                         iterations: int = 100,
                         scales=(1, 2, 4, 8)):
    """Coarse-to-fine Horn-Schunck with warping (HornSchunckPyramid.java).
    Returns (u, v) at full resolution."""
    cfg = PyramidConfig(scales=tuple(scales))
    p1 = pyramid_ops.pyramid_average(image1.to(torch.float32), cfg)
    p2 = pyramid_ops.pyramid_average(image2.to(torch.float32), cfg)
    u = torch.zeros_like(p1[-1])
    v = torch.zeros_like(p1[-1])
    for lvl in range(len(scales) - 1, -1, -1):
        i1, i2 = p1[lvl], p2[lvl]
        if u.shape != i1.shape:
            u, v = _upsample_flow(u, v, scales[lvl + 1] / scales[lvl],
                                  i1.shape)
        # warp the second image by the current flow, solve for the rest
        du, dv = horn_schunck(i1, _warp_image(i2, u, v), alpha, iterations)
        u = u + du
        v = v + dv
    return u, v


def _image_grad(f):
    """Central-difference gradient (fx, fy) with edge-replicated borders."""
    fp = _pad_edge(f)
    fy = 0.5 * (fp[2:, 1:-1] - fp[:-2, 1:-1])
    fx = 0.5 * (fp[1:-1, 2:] - fp[1:-1, :-2])
    return fx, fy


def _box_filter(f, r: int):
    """(2r+1)^2 box sum by two prefix-sum passes, zero outside."""
    c = torch.cumsum(F.pad(f, (0, 0, r + 1, r)), dim=0)
    f = c[2 * r + 1:, :] - c[:-2 * r - 1, :]
    c = torch.cumsum(F.pad(f, (r + 1, r)), dim=1)
    return c[:, 2 * r + 1:] - c[:, :-2 * r - 1]


def _upsample_flow(u, v, ratio: float, shape):
    """The coarser level's flow sampled at this level's pixels, scaled."""
    h, w = shape
    dev = u.device
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev) / ratio,
        torch.arange(w, dtype=torch.float32, device=dev) / ratio,
        indexing="ij")
    return bilinear(u, yy, xx) * ratio, bilinear(v, yy, xx) * ratio


def brox_warping(image1, image2, alpha: float = 0.04, gamma: float = 2.0,
                 scales=(1, 2, 4, 8), outer_iterations: int = 5,
                 inner_iterations: int = 50, eps: float = 1e-3):
    """Brox et al. 2004 warping flow (BroxWarpingSpacial.java analog).

    Brightness and gradient constancy with the robust penalty
    sqrt(s^2 + eps^2), a TV-like smoothness term, coarse to fine with
    warping; the lagged-nonlinearity fixed point is iterated with Jacobi
    sweeps where the reference's Java runs SOR.  Intensities are scaled to
    [0, 1] by the pair's largest magnitude first.  The smoothness term
    wraps at the image borders (``torch.roll``), as the reference's does
    (``jnp.roll``, a fault of the reference kept for parity).  Returns
    (u, v) at full resolution."""
    cfg = PyramidConfig(scales=tuple(scales))
    i1 = image1.to(torch.float32)
    i2 = image2.to(torch.float32)
    scale = torch.clamp(torch.maximum(torch.amax(torch.abs(i1)),
                                      torch.amax(torch.abs(i2))), min=1e-6)
    p1 = pyramid_ops.pyramid_average(i1 / scale, cfg)
    p2 = pyramid_ops.pyramid_average(i2 / scale, cfg)
    e2 = eps * eps
    u = torch.zeros_like(p1[-1])
    v = torch.zeros_like(p1[-1])

    shifts = ((0, 1), (0, -1), (1, 1), (1, -1))

    def smooth_weights(w_s):
        """The four neighbour weights (midpoints of w_s) and their sum, the
        same for u and v."""
        wns = [0.5 * (w_s + torch.roll(w_s, sh, ax)) for ax, sh in shifts]
        return wns, wns[0] + wns[1] + wns[2] + wns[3]

    def smooth_sum(wns, tot):
        s = 0.0
        for wn, (ax, sh) in zip(wns, shifts):
            s = s + wn * torch.roll(tot, sh, ax)
        return s

    def level_solve(i1, i2, u, v):
        i1x, i1y = _image_grad(i1)
        for _ in range(outer_iterations):
            i2w = _warp_image(i2, u, v)
            i2x, i2y = _image_grad(i2w)
            it = i2w - i1
            itx = i2x - i1x
            ity = i2y - i1y
            i2xx, i2xy = _image_grad(i2x)
            i2yx, i2yy = _image_grad(i2y)
            # products of the derivatives that the sweeps do not change
            g11 = i2xx * i2xx + i2yx * i2yx
            g12 = i2xx * i2xy + i2yx * i2yy
            g22 = i2xy * i2xy + i2yy * i2yy
            g1 = i2xx * itx + i2yx * ity
            g2 = i2xy * itx + i2yy * ity
            du = torch.zeros_like(u)
            dv = torch.zeros_like(v)
            for _ in range(inner_iterations):
                # robust data weights (lagged nonlinearity)
                r_b = it + i2x * du + i2y * dv
                r_gx = itx + i2xx * du + i2xy * dv
                r_gy = ity + i2yx * du + i2yy * dv
                w_b = torch.rsqrt(r_b * r_b + e2)
                w_g = torch.rsqrt(r_gx * r_gx + r_gy * r_gy + e2)
                # robust smoothness weight on the total flow gradient
                tot_u, tot_v = u + du, v + dv
                ux, uy = _image_grad(tot_u)
                vx, vy = _image_grad(tot_v)
                w_s = torch.rsqrt(ux * ux + uy * uy + vx * vx + vy * vy + e2)
                # Jacobi update of the Euler-Lagrange normal equations
                bx, by, gw = w_b * i2x, w_b * i2y, gamma * w_g
                a11 = bx * i2x + gw * g11
                a12 = bx * i2y + gw * g12
                a22 = by * i2y + gw * g22
                b1 = -(bx * it + gw * g1)
                b2 = -(by * it + gw * g2)
                wns, wsum = smooth_weights(w_s)
                aw = alpha * wsum
                A11 = a11 + aw
                A22 = a22 + aw
                B1 = b1 + alpha * (smooth_sum(wns, tot_u) - wsum * u)
                B2 = b2 + alpha * (smooth_sum(wns, tot_v) - wsum * v)
                det = A11 * A22 - a12 * a12
                det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
                du, dv = ((A22 * B1 - a12 * B2) / det,
                          (A11 * B2 - a12 * B1) / det)
            u, v = u + du, v + dv
        return u, v

    for lvl in range(len(scales) - 1, -1, -1):
        i1 = p1[lvl]
        if u.shape != i1.shape:
            u, v = _upsample_flow(u, v, scales[lvl + 1] / scales[lvl],
                                  i1.shape)
        u, v = level_solve(i1, p2[lvl], u, v)
    return u, v


def dense_klt(image1, image2, radius: int = 3, scales=(1, 2, 4),
              iterations: int = 10):
    """Dense pyramidal Lucas-Kanade (DenseOpticalFlowKlt.java analog: every
    pixel a KLT feature).  The per-pixel 2x2 structure tensor and mismatch
    vector are box-filtered whole images, so one Gauss-Newton iteration is
    a few elementwise maps and box sums.  A pixel stops once its step is
    tiny or its windowed SSD stops improving (the batched analog of
    KltTracker's stop rules), and keeps its best flow.  Returns (u, v,
    valid)."""
    cfg = PyramidConfig(scales=tuple(scales))
    p1 = pyramid_ops.pyramid_average(image1.to(torch.float32), cfg)
    p2 = pyramid_ops.pyramid_average(image2.to(torch.float32), cfg)
    u = torch.zeros_like(p1[-1])
    v = torch.zeros_like(p1[-1])

    def level_solve(i1, i2, u, v):
        ix, iy = _image_grad(i1)
        gxx = _box_filter(ix * ix, radius)
        gxy = _box_filter(ix * iy, radius)
        gyy = _box_filter(iy * iy, radius)
        det = gxx * gyy - gxy * gxy
        ok = det > 1e-6
        sd = torch.where(ok, det, 1.0)
        ub, vb = u, v
        best = torch.full_like(i1, 3.4e38)
        active = torch.ones_like(ok)
        for _ in range(iterations):
            e = _warp_image(i2, u, v) - i1
            ssd = _box_filter(e * e, radius)
            improved = ssd <= best
            take = improved & active
            ub = torch.where(take, u, ub)
            vb = torch.where(take, v, vb)
            best = torch.where(take, ssd, best)
            active = active & improved
            bx = _box_filter(ix * e, radius)
            by = _box_filter(iy * e, radius)
            du = torch.clamp(-(gyy * bx - gxy * by) / sd, -1.0, 1.0)
            dv = torch.clamp(-(gxx * by - gxy * bx) / sd, -1.0, 1.0)
            upd = active & ok
            u = u + torch.where(upd, du, 0.0)
            v = v + torch.where(upd, dv, 0.0)
            active = active & (torch.abs(du) + torch.abs(dv) > 0.02)
        return ub, vb, ok

    ok = None
    for lvl in range(len(scales) - 1, -1, -1):
        i1 = p1[lvl]
        if u.shape != i1.shape:
            u, v = _upsample_flow(u, v, scales[lvl + 1] / scales[lvl],
                                  i1.shape)
        u, v, ok = level_solve(i1, p2[lvl], u, v)
    return u, v, ok


def block_flow(image1, image2, search_radius: int = 4,
               region_radius: int = 3):
    """Dense block-matching flow (DenseOpticalFlowBlockPyramid): for each
    pixel the displacement in [-r, r]^2 with the least SAD over a
    (2*region_radius+1)^2 window.  Off-image candidates read a 1e6
    sentinel (the reference clamps its search to the image); the window
    sums are float32 prefix sums beside it, so costs near the border round
    with the order the scan adds in.  Returns (u, v, sad)."""
    i1 = image1.to(torch.float32)
    i2 = image2.to(torch.float32)
    h, w = i1.shape
    rr = region_radius
    sr = search_radius
    i2p = F.pad(i2, (sr, sr, sr, sr), value=1e6)
    sads = []
    for dy in range(-sr, sr + 1):
        for dx in range(-sr, sr + 1):
            shifted = i2p[sr + dy: sr + dy + h, sr + dx: sr + dx + w]
            e = torch.clamp(torch.abs(i1 - shifted), max=1e6)
            c = F.pad(torch.cumsum(F.pad(e, (rr, rr, rr, rr)), dim=0),
                      (0, 0, 1, 0))
            e = c[2 * rr + 1:, :] - c[: -2 * rr - 1, :]
            c = F.pad(torch.cumsum(e, dim=1), (1, 0))
            sads.append(c[:, 2 * rr + 1:] - c[:, : -2 * rr - 1])
    vol = torch.stack(sads, dim=0)
    best = torch.argmin(vol, dim=0)
    # candidate k is (dy, dx) = (k // n - sr, k % n - sr), n = 2 sr + 1
    n = 2 * sr + 1
    return ((best % n - sr).to(torch.float32),
            (best // n - sr).to(torch.float32), torch.amin(vol, dim=0))
