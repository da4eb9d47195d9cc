"""Stereo disparity: block matching (dense and sparse) and SGM (port of
``boofcv_tpu/feature/disparity.py``).

Reference analog: boofcv-feature alg/feature/disparity/ —
DisparityBlockMatchRowFormat.java (row-format BM), block/select/* (WTA with
left-right and texture validation), DisparityBlockMatchBestFive.java,
DisparitySparseScoreSadRect.java (sparse per-pixel SAD), sgm/*
(SgmDisparityCost, SgmCostAggregation, SgmDisparitySelector,
SgmStereoDisparityHmi).  Images are the *rectified* pair.

Dense paths.  The cost volume is a dense [D, H, W] tensor: every disparity's
shifted right image is one strided view of a padded right image, the window
sum is two prefix sums.  Winner-take-all, the left-right check and the
subpixel parabola index the volume with ``torch.gather`` (the reference
spells the same lookups as pad-and-slice shifts and one-hot sums).  SGM's
scanline recurrence is a Python loop over the scan axis on [2, D, H] state:
the two directions of one axis advance together.

Sparse path.  One SAD replaces the reference's ``sad`` / ``sad_xla`` split
(both score identically), and ``ssd`` scores squared differences.  Both
read the right strip and the left patch through the window-gather kernel
with ``2*ry+1`` rows starting at ``ys - ry``: the kernel's row clamp
reproduces the reference's per-row clip, and its column clamp reads edge
pixels that are then masked.  SAD adds 1e6 per out-of-image element as the
reference's SAD does; SSD scores a window that leaves the image 1e18 as the
reference's SSD does.  One stream ([h, w] images, [N] locations) or B
streams ([B, h, w], [B, N]): two launches of the kernel either way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from boofcv_tpu_torch.ip import census as census_mod
from boofcv_tpu_torch.kernels.window_gather import as_planes, gather_windows
from boofcv_tpu_torch.utils.profiling import span

INVALID = -1.0


class DisparityConfig(NamedTuple):
    """ConfigDisparityBM analog.  The dense matchers read every field; the
    sparse matcher reads all but ``validate_lr`` (it has no right-image
    volume to check against), and takes ``error`` "sad" (or the
    reference's "sad_xla", the same SAD) or "ssd"."""
    min_disparity: int = 0
    max_disparity: int = 64       # exclusive of min: range = max - min
    radius_x: int = 3
    radius_y: int = 3
    max_per_pixel_error: float = -1.0   # <0 disables
    texture_threshold: float = 0.15     # <=0 disables
    validate_lr: int = 1                # max L-R mismatch; <0 disables
    subpixel: bool = True
    error: str = "sad"                  # sad | census


def _shifted_right(right: torch.Tensor, cfg, fill) -> torch.Tensor:
    """[D, H, W] view whose slice d is ``right`` shifted so that column x
    aligns with left x - (min_disparity + d), ``fill`` where that column is
    left of the image."""
    h, w = right.shape
    n_disp = cfg.max_disparity - cfg.min_disparity
    reach = cfg.min_disparity + n_disp - 1
    padded = F.pad(right, (reach, 0), value=fill)        # [H, reach + W]
    # window k of the unfold starts at padded column k: shift reach - k
    return padded.unfold(1, w, 1)[:, :n_disp].flip(1).permute(1, 0, 2)


def _out_of_range(cfg, w: int, device) -> torch.Tensor:
    """[D, 1, W] mask of the columns x < min_disparity + d."""
    n_disp = cfg.max_disparity - cfg.min_disparity
    d = cfg.min_disparity + torch.arange(n_disp, device=device)
    return (torch.arange(w, device=device) < d[:, None])[:, None, :]


def cost_volume(left: torch.Tensor, right: torch.Tensor,
                cfg: DisparityConfig) -> torch.Tensor:
    """[D, H, W] aggregated matching cost.

    cost[d, y, x] = sum over the (2rx+1)x(2ry+1) window of the per-pixel
    error between left(y, x) and right(y, x - (min_disparity + d))."""
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    if cfg.error == "census":
        # the 5x5 code has 24 bits: int32 holds it
        lc = census_mod.dense5x5(left)
        rc = census_mod.dense5x5(right)
        ham = census_mod.hamming_distance(lc[None], _shifted_right(rc, cfg, 0))
        # out-of-range sentinel: far above the largest distance, 24, and
        # small enough for the box filter's f32 prefix sums
        errs = torch.where(_out_of_range(cfg, left.shape[1], left.device),
                           100.0, ham.to(torch.float32))
    else:
        e = torch.abs(left[None] - _shifted_right(right, cfg, float("inf")))
        errs = torch.where(torch.isfinite(e), e, 1e6)
    return _separable_box(errs, cfg.radius_y, cfg.radius_x)


def _separable_box(vol: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    """Box-sum filter of each [H, W] slice of [D, H, W] by two prefix sums
    (zero pad: windows at the borders sum fewer terms)."""
    v = F.pad(vol, (rx, rx, ry, ry))
    cs = F.pad(torch.cumsum(v, dim=1), (0, 0, 1, 0))
    v = cs[:, 2 * ry + 1:, :] - cs[:, : -2 * ry - 1, :]
    cs = F.pad(torch.cumsum(v, dim=2), (1, 0))
    return cs[:, :, 2 * rx + 1:] - cs[:, :, : -2 * rx - 1]


def _wta_select(cost: torch.Tensor, cfg: DisparityConfig) -> torch.Tensor:
    """Winner-take-all and validations; returns the float disparity image
    ([H, W], INVALID where rejected).  SelectRectStandard semantics:
    texture check, left-right check, subpixel parabola."""
    n_disp, h, w = cost.shape
    dev = cost.device
    best = torch.argmin(cost, dim=0)                     # [H, W]
    at = lambda d: torch.gather(cost, 0, d[None])[0]
    cbest = at(best)
    disp = best.to(torch.float32)
    xs = torch.arange(w, device=dev)

    # pixels whose disparity would reach off the left edge are invalid
    valid = xs >= (cfg.min_disparity + best)

    # texture: the second best, the winner's neighbours excluded, must be
    # sufficiently worse: (c2 - c1) / c1 > threshold
    if cfg.texture_threshold > 0:
        d_idx = torch.arange(n_disp, device=dev)[:, None, None]
        near = torch.abs(d_idx - best[None]) <= 1
        c2 = torch.amin(torch.where(near, float("inf"), cost), dim=0)
        ok = (c2 - cbest) > cfg.texture_threshold * torch.clamp(cbest,
                                                                min=1e-6)
        valid &= ok | ~torch.isfinite(c2)

    if cfg.max_per_pixel_error > 0:
        area = (2 * cfg.radius_x + 1) * (2 * cfg.radius_y + 1)
        valid &= cbest <= cfg.max_per_pixel_error * area

    # left-right consistency: the right image's disparity comes from the
    # same volume, costR[d, y, x] = cost[d, y, x + min + d] (edge-clamped),
    # and is read at x - (min + best) (edge-clamped)
    if cfg.validate_lr >= 0:
        d_abs = cfg.min_disparity + torch.arange(n_disp, device=dev)
        col = torch.clamp(xs + d_abs[:, None], max=w - 1)         # [D, W]
        costR = torch.gather(cost, 2, col[:, None, :].expand(n_disp, h, w))
        bestR = torch.argmin(costR, dim=0)
        back = torch.gather(bestR, 1,
                            torch.clamp(xs - (cfg.min_disparity + best),
                                        min=0))
        valid &= torch.abs(back - best) <= cfg.validate_lr

    if cfg.subpixel:
        cm = at(torch.clamp(best - 1, min=0))
        cp = at(torch.clamp(best + 1, max=n_disp - 1))
        denom = cm - 2.0 * cbest + cp
        off = torch.where(denom > 1e-9, 0.5 * (cm - cp) / denom, 0.0)
        off = torch.clamp(off, -0.5, 0.5)
        interior = (best > 0) & (best < n_disp - 1)
        disp = disp + torch.where(interior, off, 0.0)

    return torch.where(valid, disp, INVALID)


def _absolute(disp: torch.Tensor, min_disparity: int) -> torch.Tensor:
    """Selected disparities in pixels (add the range's start), INVALID
    kept."""
    return torch.where(disp >= 0, disp + min_disparity, disp)


def block_match(left: torch.Tensor, right: torch.Tensor,
                cfg: DisparityConfig = DisparityConfig()) -> torch.Tensor:
    """Dense BM disparity (DisparityBlockMatchRowFormat.process analog).

    Returns [H, W] float disparities in pixels, INVALID where rejected."""
    return _absolute(_wta_select(cost_volume(left, right, cfg), cfg),
                     cfg.min_disparity)


def block_match_best5(left: torch.Tensor, right: torch.Tensor,
                      cfg: DisparityConfig = DisparityConfig()
                      ) -> torch.Tensor:
    """Five-window block matching (DisparityBlockMatchBestFive.java): the
    centre window plus the best 2 of the 4 corner-offset windows, which are
    the same volume shifted by (+-ry, +-rx) with replicated edges."""
    cost = cost_volume(left, right, cfg)
    ry, rx = cfg.radius_y, cfg.radius_x
    h, w = cost.shape[1:]
    pad_c = F.pad(cost, (rx, rx, ry, ry), mode="replicate")
    corner = lambda dy, dx: pad_c[:, ry + dy:ry + dy + h,
                                  rx + dx:rx + dx + w]
    c1, c2 = corner(-ry, -rx), corner(-ry, rx)
    c3, c4 = corner(ry, -rx), corner(ry, rx)
    # sum of the two smallest of four = total - the two largest
    total = c1 + c2 + c3 + c4
    m1 = torch.maximum(torch.maximum(c1, c2), torch.maximum(c3, c4))
    m2 = torch.minimum(torch.maximum(c1, c2), torch.maximum(c3, c4))
    m2 = torch.maximum(m2, torch.minimum(torch.maximum(c1, c3),
                                         torch.maximum(c2, c4)))
    five = cost + (total - m1 - m2)
    # the per-pixel-error bound refers to a three-window area
    cfg5 = cfg._replace(max_per_pixel_error=cfg.max_per_pixel_error * 3
                        if cfg.max_per_pixel_error > 0 else -1.0)
    return _absolute(_wta_select(five, cfg5), cfg.min_disparity)


def _sparse_windows(left, right, ys, xs, cfg: DisparityConfig):
    """The two gathers both sparse costs score from: (left patches
    [..., N, PH, P], right windows [..., N, PH, D, P], their in-image column
    mask [..., N, D, P]); window d is the one disparity min + d compares."""
    w = left.shape[-1]
    rx, ry = cfg.radius_x, cfg.radius_y
    n_disp = cfg.max_disparity - cfg.min_disparity
    p = 2 * rx + 1
    ph = 2 * ry + 1
    wide_w = n_disp + 2 * rx                            # columns needed
    ys = ys.to(torch.int32)
    xs = xs.to(torch.int32)
    x0 = (xs - rx - (cfg.min_disparity + n_disp - 1)).contiguous()
    oy = (ys - ry).contiguous()
    strip = gather_windows(right, oy, x0, ph, wide_w)   # [N, PH, W']
    patch_l = gather_windows(left, oy, (xs - rx).contiguous(), ph, p)

    cols = x0[..., None] + torch.arange(wide_w, device=left.device)
    colb = (cols >= 0) & (cols < w)                     # [N, W']
    # window for disparity index d starts at strip column n_disp - 1 - d
    sl = strip.unfold(-1, p, 1).flip(-2)                # [N, PH, D, P]
    inb = colb.unfold(-1, p, 1).flip(-2)                # [N, D, P]
    return patch_l, sl, inb


def _sparse_costs_sad(left, right, ys, xs, cfg: DisparityConfig):
    """[..., N, D] SAD cost table; cost index d scores disparity min + d."""
    patch_l, sl, inb = _sparse_windows(left, right, ys, xs, cfg)
    e = torch.abs(patch_l[..., None, :] - sl).transpose(-3, -2)
    e = torch.where(inb[..., None, :], e, 1e6)          # [N, D, PH, P]
    return torch.sum(e, dim=(-2, -1))


def _sparse_costs_ssd(left, right, ys, xs, cfg: DisparityConfig):
    """[..., N, D] SSD cost table from the same two gathers: the sum of
    squared differences, 1e18 where the right window leaves the image.  The
    reference expands it as |L|^2 + |R|^2 - 2<L, R> (a grouped convolution);
    summing the squares directly agrees to float32 rounding and needs no
    TF32-capable convolution."""
    patch_l, sl, inb = _sparse_windows(left, right, ys, xs, cfg)
    e = (patch_l[..., None, :] - sl).transpose(-3, -2)  # [N, D, PH, P]
    ssd = torch.sum(e * e, dim=(-2, -1))
    return torch.where(torch.all(inb, dim=-1), ssd, 1e18)


def sparse_block_match(left: torch.Tensor, right: torch.Tensor,
                       ys: torch.Tensor, xs: torch.Tensor,
                       cfg: DisparityConfig = DisparityConfig()):
    """Sparse block matching at N integer left-image locations
    (DisparitySparseScoreSadRect): ``cfg.error`` "sad" or "sad_xla" scores
    SAD, "ssd" SSD with the per-pixel-error bound squared; any other value
    raises ``ValueError``.

    Returns (disp [..., N] f32, valid [..., N] bool): winner-take-all with
    the per-pixel-error bound, the texture check and the subpixel parabola
    of the reference."""
    score = {"sad": _sparse_costs_sad, "sad_xla": _sparse_costs_sad,
             "ssd": _sparse_costs_ssd}.get(cfg.error)
    if score is None:
        raise ValueError(f"sparse_block_match scores error 'sad', 'sad_xla' "
                         f"or 'ssd', not {cfg.error!r}")
    with span("sad"):
        left = as_planes(left)
        right = as_planes(right)
        n_disp = cfg.max_disparity - cfg.min_disparity
        costs = score(left, right, ys, xs, cfg)
        at = lambda d: torch.gather(costs, -1, d[..., None])[..., 0]
        best = torch.argmin(costs, dim=-1)
        cbest = at(best)
        valid = (xs - (cfg.min_disparity + best) >= 0) & (cbest < 1e17)
        if cfg.max_per_pixel_error > 0:
            area = (2 * cfg.radius_x + 1) * (2 * cfg.radius_y + 1)
            # SSD costs are squared per-pixel errors: the bound is squared too
            per_pixel = cfg.max_per_pixel_error ** (
                2 if cfg.error == "ssd" else 1)
            valid &= cbest <= per_pixel * area
        if cfg.texture_threshold > 0:
            d_idx = torch.arange(n_disp, device=costs.device)
            near = torch.abs(d_idx - best[..., None]) <= 1
            c2 = torch.amin(torch.where(near, float("inf"), costs), dim=-1)
            valid &= (((c2 - cbest)
                       > cfg.texture_threshold * torch.clamp(cbest, min=1e-6))
                      | ~torch.isfinite(c2))

        disp = best.to(torch.float32)
        if cfg.subpixel:
            # parabola through the best cost and its two neighbours
            cm = at(torch.clamp(best - 1, 0, n_disp - 1))
            cp = at(torch.clamp(best + 1, 0, n_disp - 1))
            denom = cm - 2.0 * cbest + cp
            off = torch.where(denom > 1e-9, 0.5 * (cm - cp) / denom, 0.0)
            interior = (best > 0) & (best < n_disp - 1)
            disp = disp + torch.where(interior, torch.clamp(off, -0.5, 0.5),
                                      0.0)
        return disp + cfg.min_disparity, valid


# ---------------------------------------------------------------------------
# Semi-global matching
# ---------------------------------------------------------------------------

class SgmConfig(NamedTuple):
    """ConfigDisparitySGM analog."""
    min_disparity: int = 0
    max_disparity: int = 64
    penalty_small: float = 5.0     # P1: |dd| = 1 transitions
    penalty_large: float = 60.0    # P2: larger jumps
    paths: int = 4                 # 4 (axis-aligned) or 8 (+ diagonals)
    error: str = "census"          # census | sad
    validate_lr: int = 1
    subpixel: bool = True
    texture_threshold: float = 0.0


def _sgm_scan(cost: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Aggregate along the last axis (left to right) with the SGM
    recurrence (SgmCostAggregation.java's scanline loop in wavefront form).

    cost: [..., D, H, W]; every leading index is a scan of its own (the two
    flips of one axis).  Returns the aggregated volume, same shape (a
    strided view).  One step computes, on [..., D, H] state,
    ``c + min(prev, prev[d-1] + p1, prev[d+1] + p1, min_d prev + p2) -
    min_d prev`` with 1e9 beyond both ends of the disparity axis; the state
    is kept with one padding row at each end of that axis, so the two
    shifted operands are views."""
    n_disp = cost.shape[-3]
    c = cost.movedim(-1, 0).contiguous()                 # [W, ..., D, H]
    shape = list(c.shape)
    shape[-2] = n_disp + 2
    agg = torch.full(shape, 1e9, dtype=cost.dtype, device=cost.device)
    agg[0, ..., 1:-1, :] = c[0]
    for x in range(1, c.shape[0]):
        state = agg[x - 1]
        prev = state[..., 1:-1, :]
        m = torch.amin(prev, dim=-2, keepdim=True)       # [..., 1, H]
        best = torch.minimum(
            torch.minimum(prev, state[..., :-2, :] + p1),
            torch.minimum(state[..., 2:, :] + p1, m + p2))
        torch.sub(c[x] + best, m, out=agg[x, ..., 1:-1, :])
    return agg[..., 1:-1, :].movedim(0, -1)


def _aggregate(cost: torch.Tensor, p1: float, p2: float,
               paths: int = 4) -> torch.Tensor:
    """Sum of the path aggregations of a [D, H, W] cost volume: left-right,
    right-left, top-bottom, bottom-top, and for 8 paths the four
    diagonals."""
    both = lambda vol: _sgm_scan(torch.stack([vol, vol.flip(2)]), p1, p2)
    lr = both(cost)
    agg = lr[0] + lr[1].flip(2)
    tb = both(cost.transpose(1, 2))
    agg = agg + tb[0].transpose(1, 2)
    agg = agg + tb[1].flip(2).transpose(1, 2)
    if paths >= 8:
        # diagonals by a row-shifted shear: row y moves by y columns
        # (modulo w + h), so a diagonal becomes a column
        n_disp, h, w = cost.shape
        dev = cost.device
        rows = torch.arange(h, device=dev)
        span = torch.arange(w + h, device=dev)
        padded = F.pad(cost, (0, h))
        for sign in (1, -1):
            shift = (sign * rows) % (w + h)
            take = lambda vol, idx: torch.gather(
                vol, 2, idx[None].expand(n_disp, h, w + h))
            sh = take(padded, (span[None, :] - shift[:, None]) % (w + h))
            back = (span[None, :] + shift[:, None]) % (w + h)
            dg = both(sh.transpose(1, 2))
            agg = agg + take(dg[0].transpose(1, 2), back)[:, :, :w]
            agg = agg + take(dg[1].flip(2).transpose(1, 2), back)[:, :, :w]
    return agg


def sgm(left: torch.Tensor, right: torch.Tensor,
        cfg: SgmConfig = SgmConfig()) -> torch.Tensor:
    """Semi-global matching disparity (SgmStereoDisparity.java analog).

    Census (or SAD) per-pixel cost, 4- or 8-path aggregation, WTA with the
    left-right check and subpixel interpolation.  Returns [H, W] float
    disparities, INVALID where rejected."""
    bm_cfg = DisparityConfig(
        min_disparity=cfg.min_disparity, max_disparity=cfg.max_disparity,
        radius_x=0, radius_y=0, error=cfg.error,
        texture_threshold=cfg.texture_threshold,
        validate_lr=cfg.validate_lr, subpixel=cfg.subpixel)
    cost = cost_volume(left, right, bm_cfg)              # per-pixel cost
    cost = torch.clamp(cost, max=1e5)    # clamp the out-of-bounds sentinel
    agg = _aggregate(cost, cfg.penalty_small, cfg.penalty_large, cfg.paths)
    return _absolute(_wta_select(agg, bm_cfg), cfg.min_disparity)


# ---------------------------------------------------------------------------
# SGM with hierarchical mutual-information cost (SgmStereoDisparityHmi)
# ---------------------------------------------------------------------------

def _quantize(image: torch.Tensor, bins: int) -> torch.Tensor:
    return torch.clamp(image.to(torch.float32) * (bins / 256.0),
                       0, bins - 1).to(torch.int64)


def mi_cost_table(left, right, disparity, bins: int = 64,
                  sigma: float = 1.5):
    """Mutual-information matching-cost table from a disparity prior.

    Hirschmuller 2008 (SgmMutualInformation / StereoMutualInformation in
    the reference): joint histogram of corresponding intensities ->
    Gaussian-smoothed -log probabilities; cost(l, r) = h_joint(l, r)
    - h_l(l) - h_r(r), shifted to be >= 0.  ``disparity`` uses INVALID (<0)
    for missing pixels.  The histogram adds weights 0 and 1, so the order
    its sums run in does not change it."""
    from boofcv_tpu_torch.ip import blur

    w = left.shape[1]
    lq = _quantize(left, bins)
    rq = _quantize(right, bins)
    xs = torch.arange(w, device=left.device).to(torch.float32)
    xr = torch.round(xs - disparity).to(torch.int64)
    ok = (disparity >= 0) & (xr >= 0) & (xr < w)
    r_at = torch.gather(rq, 1, torch.clamp(xr, 0, w - 1))
    joint = torch.zeros(bins * bins, dtype=torch.float32,
                        device=left.device).index_add_(
        0, (lq * bins + r_at).reshape(-1), ok.reshape(-1).to(torch.float32))
    joint = joint.reshape(bins, bins)
    pj = joint / torch.clamp(torch.sum(joint), min=1.0)
    # smooth -> -log -> smooth (Hirschmuller's double convolution)
    entropy = lambda p: blur.gaussian(
        -torch.log(blur.gaussian(p, sigma=sigma) + 1e-8), sigma=sigma)
    hj = entropy(pj)
    hl = entropy(torch.sum(pj, dim=1)[None, :])[0]
    hr = entropy(torch.sum(pj, dim=0)[None, :])[0]
    cost = hj - hl[:, None] - hr[None, :]
    return cost - torch.amin(cost)


def _mi_cost_volume(left, right, table, cfg: SgmConfig, bins: int):
    """[D, H, W] table lookups of (left bin, shifted right bin), 1e5 where
    the shifted column is left of the image."""
    lq = _quantize(left, bins)
    rs = _shifted_right(_quantize(right, bins), cfg, 0)
    c = table.reshape(-1)[lq[None] * bins + rs]
    return torch.where(_out_of_range(cfg, left.shape[1], left.device),
                       1e5, c)


def sgm_hmi(left: torch.Tensor, right: torch.Tensor,
            cfg: SgmConfig = SgmConfig(), levels: int = 3,
            bins: int = 64) -> torch.Tensor:
    """Hierarchical-MI SGM (SgmStereoDisparityHmi.java analog).

    The MI cost needs a disparity prior; hierarchically: census-SGM at the
    coarsest pyramid level seeds the first MI table, then each finer level
    re-estimates disparity with an MI table computed from the upsampled
    prior.  Returns [H, W] float disparity, INVALID where rejected."""
    def down(p):
        # crop odd dims, then 2x2 means
        hh, ww = p.shape[0] // 2 * 2, p.shape[1] // 2 * 2
        p = p[:hh, :ww]
        return 0.25 * (p[0::2, 0::2] + p[1::2, 0::2]
                       + p[0::2, 1::2] + p[1::2, 1::2])

    pyr_l, pyr_r = [left.to(torch.float32)], [right.to(torch.float32)]
    for _ in range(levels - 1):
        pyr_l.append(down(pyr_l[-1]))
        pyr_r.append(down(pyr_r[-1]))

    scale = 2 ** (levels - 1)
    coarse_cfg = cfg._replace(
        min_disparity=cfg.min_disparity // scale,
        max_disparity=max(cfg.max_disparity // scale, 2), error="census")
    disp = sgm(pyr_l[-1], pyr_r[-1], coarse_cfg)

    for lvl in range(levels - 2, -1, -1):
        li, ri = pyr_l[lvl], pyr_r[lvl]
        hh, ww = li.shape
        # upsample the prior (nearest) and double it; the edge pad covers
        # the odd row or column the even-cropped level lost
        up = disp.repeat_interleave(2, 0).repeat_interleave(2, 1)
        py, px = max(hh - up.shape[0], 0), max(ww - up.shape[1], 0)
        if py or px:
            up = F.pad(up[None], (0, px, 0, py), mode="replicate")[0]
        up = up[:hh, :ww]
        prior = torch.where(up >= 0, up * 2.0, INVALID)
        lvl_scale = 2 ** lvl
        lcfg = cfg._replace(
            min_disparity=cfg.min_disparity // lvl_scale,
            max_disparity=max(cfg.max_disparity // lvl_scale, 2))
        table = mi_cost_table(li, ri, prior, bins=bins)
        cost = _mi_cost_volume(li, ri, table, lcfg, bins)
        # the SGM aggregation on the MI cost, four paths
        agg = _aggregate(cost, cfg.penalty_small / 10.0,
                         cfg.penalty_large / 10.0)
        bm_cfg = DisparityConfig(
            min_disparity=lcfg.min_disparity,
            max_disparity=lcfg.max_disparity, radius_x=0, radius_y=0,
            texture_threshold=cfg.texture_threshold,
            validate_lr=cfg.validate_lr, subpixel=cfg.subpixel)
        disp = _absolute(_wta_select(agg, bm_cfg), lcfg.min_disparity)
    return disp
