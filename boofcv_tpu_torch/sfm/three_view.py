"""Uncalibrated three-view metric reconstruction (port of
``boofcv_tpu/sfm/three_view.py``, whole).

Reference analog: boofcv-sfm alg/sfm/structure/ThreeViewEstimateMetricScene
.java:80,157 — associated triples -> robust trifocal tensor -> projective
cameras -> linear dual-quadratic self-calibration (with the focus sweep as
its fallback) -> metric upgrade -> triangulation -> bundle adjustment with
a free focal.

The trifocal RANSAC solves its K linear 8-point samples as one batch and
scores [K, N] transfer errors at once; the self-calibration and the upgrade
are small numpy solves on the host, as in the reference; the final BA is
``geo/ba.py``'s LM-Schur.  Random draws come from an explicit
``torch.Generator``; ``idx`` [K, 8] replaces the draw.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.geo import ba, robust, se3, selfcalib, triangulate, \
    trifocal


class ThreeViewResult(NamedTuple):
    K: np.ndarray            # [3, 3] shared intrinsics estimate
    Rs: np.ndarray           # [3, 3, 3] world->view rotations
    ts: np.ndarray           # [3, 3]
    points: np.ndarray       # [N, 3] metric points (inliers only valid)
    inliers: np.ndarray      # [N] bool trifocal inlier mask
    reproj_rmse: float


def cameras_from_trifocal(T):
    """Projective camera pair (P2, P3) with P1 = [I | 0] from the tensor
    (TrifocalExtractGeometries.extractCamera)."""
    e2, e3 = trifocal.extract_epipoles(T)
    # P2 = [[T1 e3, T2 e3, T3 e3] | e2]
    cols2 = torch.stack([T[k] @ e3 for k in range(3)], dim=1)
    P2 = torch.cat([cols2, e2[:, None]], dim=1)
    M = torch.outer(e3, e3) - torch.eye(3, dtype=T.dtype, device=T.device)
    cols3 = torch.stack([M @ T[k].T @ e2 for k in range(3)], dim=1)
    P3 = torch.cat([cols3, e3[:, None]], dim=1)
    return P2, P3


def ransac_trifocal(generator, p1, p2, p3, num_hypotheses: int = 256,
                    inlier_threshold_px: float = 2.0, valid_mask=None,
                    idx=None):
    """Robust trifocal fit over point triples [N, 2] (ConfigTrifocal +
    RansacTrifocal): 8-point linear samples, squared transfer error in
    view 3.  The model is (T [3, 3, 3],)."""
    return robust.ransac(
        generator, (p1, p2, p3), lambda s: (trifocal.trifocal_linear(*s),),
        lambda m, q: trifocal.transfer_error(m[0], *q), sample_size=8,
        num_hypotheses=num_hypotheses,
        inlier_threshold=inlier_threshold_px ** 2, valid_mask=valid_mask,
        idx=idx)


def _self_calibrate(Ps, w: int):
    """Shared K and the rectifying H from the three projective cameras: the
    linear dual quadratic, and where its focal is not finite and within
    (0.2 w, 6 w), the coarse-then-fine focus sweep (the reference pairs its
    linear solve with SelfCalibrationGuessAndCheckFocus: sub-pixel noise
    pushes the linear dual quadric off the PSD cone)."""
    K = None
    try:
        K, H = selfcalib.self_calibrate_dual_quadratic(Ps)
        K = np.asarray(K, np.float64)
        H = np.asarray(H, np.float64)
        f_lin = 0.5 * (K[0, 0] + K[1, 1])
        if not np.isfinite(K).all() or not (0.2 * w < f_lin < 6.0 * w):
            K = None
    except Exception:
        K = None
    if K is None:
        cands = np.geomspace(0.25 * w, 5.0 * w, 60)
        f_best, H = selfcalib.guess_and_check_focus(
            Ps, focal_candidates=cands)
        # refine with a finer sweep around the coarse winner
        lo, hi = f_best / 1.12, f_best * 1.12
        f_best, H = selfcalib.guess_and_check_focus(
            Ps, focal_candidates=np.linspace(lo, hi, 25))
        K = np.diag([f_best, f_best, 1.0])
        H = np.asarray(H, np.float64)
    return K, H


def estimate_metric_scene(p1, p2, p3, image_shape, generator=None,
                          num_hypotheses: int = 256,
                          inlier_threshold_px: float = 2.0,
                          ba_iterations: int = 20, idx=None,
                          device=None) -> ThreeViewResult:
    """Full pipeline on associated pixel triples [N, 2] each.

    image_shape: (h, w).  Observations are re-centred on the principal
    point first (the linear dual-quadratic self-calibration assumes a
    centred principal point, as the reference's does).  ``generator``
    None: a generator on the device seeded 0; ``idx`` [K, 8] replaces its
    draw.  ``device`` None: the card."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    h, w = image_shape
    c = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
    q = [np.asarray(p, np.float64) - c for p in (p1, p2, p3)]
    qt = [torch.from_numpy(a).to(dev) for a in q]

    res = ransac_trifocal(generator, *qt, num_hypotheses=num_hypotheses,
                          inlier_threshold_px=inlier_threshold_px,
                          idx=None if idx is None else
                          torch.as_tensor(idx, device=dev).long())
    P2, P3 = cameras_from_trifocal(res.model[0])
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    Ps = np.stack([P1, P2.cpu().numpy(), P3.cpu().numpy()])
    K, H = _self_calibrate(Ps, w)

    # metric upgrade: P_m = P H = K [R | t]
    Kinv = np.linalg.inv(K)
    Rs, ts = [], []
    for P in Ps:
        A = Kinv @ (P @ H)
        scale = np.cbrt(abs(np.linalg.det(A[:, :3])))
        A = A / (scale if scale > 1e-12 else 1.0)
        if np.linalg.det(A[:, :3]) < 0:
            A = -A
        Rs.append(se3.project_to_so3(torch.from_numpy(A[:, :3])).numpy())
        ts.append(A[:, 3])
    Rs = np.stack(Rs)
    ts = np.stack(ts)

    # normalized observations + triangulation
    obs = np.stack([qq @ Kinv[:2, :2].T + Kinv[:2, 2] for qq in q])  # [3,N,2]
    tri = lambda o, t: triangulate.triangulate_nview_linear(
        torch.from_numpy(o).to(dev), torch.from_numpy(Rs).to(dev),
        torch.from_numpy(t).to(dev)).cpu().numpy()
    X = tri(obs, ts)
    # cheirality: mirror the scene if the points land behind camera 1
    inl = res.inliers.cpu().numpy()
    if inl.any() and np.median(X[inl, 2]) < 0:
        X = -X
        ts = -ts

    # metric BA over the inlier triples with the focal free ("pinhole_f"),
    # from three focal seeds; the self-calibrated f only starts it
    n = X.shape[0]
    f0 = 0.5 * (K[0, 0] + K[1, 1])
    obs_px = np.stack(q)                                      # [3, N, 2]
    best = None
    for mult in (1.0, 0.7, 1.45):
        f_i = f0 * mult
        ts_i = ts
        if mult != 1.0:
            # structure consistent with this focal: rescaled observations,
            # triangulated again, with the same cheirality flip (the cost
            # is mirror-invariant, so a mirror could win otherwise)
            X_i = tri(obs * (f0 / f_i), ts)
            if inl.any() and np.median(X_i[inl, 2]) < 0:
                X_i = -X_i
                ts_i = -ts
        else:
            X_i = X
        prob = ba.make_problem(
            R=Rs, t=ts_i, points=X_i, obs_xy=obs_px.transpose(1, 0, 2),
            obs_view=np.tile(np.arange(3, dtype=np.int32), (n, 1)),
            obs_valid=np.tile(inl[:, None], (1, 3)),
            intr=np.full((3, 1), f_i), model="pinhole_f",
            fixed_views=np.array([True, False, False]), device=dev)
        prob_opt, info = ba.optimize(prob, iterations=ba_iterations)
        c_fin = float(info["final_cost"])
        f_ref = float(prob_opt.intr[:, 0].mean())
        # reject degenerate collapses (focal driven to ~0 or exploding)
        if not np.isfinite(c_fin) or not (0.05 * w < f_ref < 20.0 * w):
            continue
        if best is None or c_fin < best[0]:
            best = (c_fin, prob_opt, f_ref)
    if best is None:
        raise ValueError("three-view metric BA failed for every focal seed")
    c_fin, prob_opt, f_ref = best
    K = np.diag([f_ref, f_ref, 1.0])
    rmse = float(np.sqrt(2.0 * c_fin / max(int(inl.sum()) * 3, 1))) \
        / max(f_ref, 1e-9)
    return ThreeViewResult(K, prob_opt.R.cpu().numpy(),
                           prob_opt.t.cpu().numpy(),
                           prob_opt.points.cpu().numpy(), inl, rmse)


def estimate_from_images(img1, img2, img3, generator=None,
                         max_features: int = 300, detect=None,
                         max_assoc_error: float = 0.25, device=None,
                         **kwargs) -> ThreeViewResult:
    """End-to-end three-view pipeline from raw images: detect/describe ->
    AssociateThreeByPairs -> trifocal RANSAC -> self-calibration -> metric
    BA (ExampleTrifocalStereoUncalibrated + ThreeViewEstimateMetricScene).

    ``detect``: optional override returning ``reconstruction.ImageFeatures``
    (the tests use synthetic detections); default SURF.  Extra kwargs reach
    :func:`estimate_metric_scene`."""
    from boofcv_tpu_torch.feature import associate
    from boofcv_tpu_torch.sfm import reconstruction

    dev = resolve_device(device)
    detect = detect or (lambda im: reconstruction.detect_describe(
        im, max_features, device=dev))
    f1, f2, f3 = detect(img1), detect(img2), detect(img3)
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    i1, i2, i3, valid = associate.associate_three_by_pairs(
        t(f1.desc), t(f2.desc), t(f3.desc), max_error=max_assoc_error ** 2,
        valid1=t(f1.valid), valid2=t(f2.valid), valid3=t(f3.valid))
    v = valid.cpu().numpy()
    i1, i2, i3 = (i.cpu().numpy()[v] for i in (i1, i2, i3))
    if v.sum() < 12:
        raise ValueError(f"only {int(v.sum())} associated triples")
    p1 = np.stack([np.asarray(f1.xs)[i1], np.asarray(f1.ys)[i1]], 1)
    p2 = np.stack([np.asarray(f2.xs)[i2], np.asarray(f2.ys)[i2]], 1)
    p3 = np.stack([np.asarray(f3.xs)[i3], np.asarray(f3.ys)[i3]], 1)
    if not hasattr(img1, "shape") or len(img1.shape) < 2:
        raise ValueError("img1 must be an [H, W] array (needed for the "
                         "principal-point re-centering)")
    h, w = img1.shape[0], img1.shape[1]
    return estimate_metric_scene(p1, p2, p3, (h, w), generator=generator,
                                 device=dev, **kwargs)
