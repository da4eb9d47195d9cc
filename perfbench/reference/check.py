"""The comparison that decides ``correct``: sampled steps of the timed run
worked out again by the plain reference (``vo_ref.py``).

A sample is one stream's step: the program's state before and after it
(numpy arrays named as ``StereoVoState``'s fields, templates as lists by
level) and the stream's 8-bit frame pair.  The reference follows the
program from the state before the step; the stages that this skips are
the spawns that made that state, and every spawn in the sample (the
bootstrap at the head of each replay among them) is checked on its own.

Numbers, each the worst over the sample:

- ``klt_gap_p90_px``: tracks the program carried through the step (alive
  before and after, the same uid): the 90th percentile, over them, of the
  distance between the program's position and the reference KLT's from
  the same start and templates (the largest distance swings with the
  convergence tolerance's stop, which float32 and float64 decide
  differently for a track or two a step; see PERF.md);
- ``pose_gap_px``: largest distance, in pixels, between the projections of
  those tracks' world points through the program's pose and through the
  reference's least-squares pose over the same tracks;
- ``spawn_world_gap``: largest distance between a spawned track's world
  point and the reference's lift of it (its own disparity at the track's
  pixel, the program's pose), over the reference's distance to the camera;
- ``template_gap``: largest absolute gap of a spawned track's templates
  (pixels and Sobel gradients, every level) from the reference's;
- ``wrongly_retired``: of the tracks alive before a step that the
  reference clearly keeps (its KLT tracks them with no fault, and they lie
  within half the inlier threshold of its own pose: ``robust_pose`` over
  the tracks its KLT kept), the share that the program did not carry,
  pooled over every step of the sample;
- ``wrongly_kept``: of the tracks the program carried, the share that the
  reference clearly drops (its KLT faults them, or they lie beyond twice
  the inlier threshold of its pose), pooled likewise.

A track between half and twice the threshold counts in neither share.
The two shares are pooled, not the worst step's: RANSAC's best
hypothesis, drawn from the program's generator, lies up to a pixel off
the least-squares pose in some steps and retires a few tracks that this
pose fits within half the threshold (see PERF.md).  The harness adds
``failed_share`` (poses that came back unusable) and ``uncovered``.
"""

from __future__ import annotations

import numpy as np

from vo_ref import (OK, klt, lift, project, pyramid, refine_pose,
                    reprojection_px, robust_pose, sad_disparity,
                    sample_patches, sobel)

NUMBERS = ("klt_gap_p90_px", "pose_gap_px", "spawn_world_gap", "template_gap",
           "wrongly_retired", "wrongly_kept")


def _step_numbers(sample: dict, vo: dict, fixed: dict, cam: dict,
                  out: dict, tally: dict) -> None:
    s0, s1 = sample["s0"], sample["s1"]
    scales = vo["pyramid_scales"]
    r = vo["template_radius"]
    fx, cx, cy = cam["fx"], cam["cx"], cam["cy"]
    left = np.asarray(sample["left"], np.float64)
    right = np.asarray(sample["right"], np.float64)
    levels = pyramid(left, scales)
    carried = s0["alive"] & s1["alive"] & (s0["uid"] == s1["uid"])
    spawned = s1["alive"] & (s1["uid"] != s0["uid"])

    if not sample["boot"] and s0["alive"].any():
        kc = vo["klt"]
        ty, tx, fault = klt(levels, s0["templates"]["desc"],
                            s0["templates"]["grad_x"],
                            s0["templates"]["grad_y"], s0["ys"], s0["xs"],
                            scales, r, iterations=kc["max_iterations"],
                            tol=kc["convergence_tol"],
                            max_err=kc["max_per_pixel_error"],
                            min_det=kc["min_determinant"])
        if carried.any():
            gap = np.hypot(ty - s1["ys"], tx - s1["xs"])[carried]
            out["klt_gap_p90_px"] = max(out["klt_gap_p90_px"],
                                        float(np.percentile(gap, 90)))
        # the track state: which tracks the step should keep
        thr = vo["inlier_threshold_px"]
        tracked = s0["alive"] & (fault == OK)
        obs = np.stack([(tx - cx) / fx, (ty - cy) / cam["fy"]], -1)
        Rr, tr = robust_pose(s0["R"], s0["t"], s0["world"][tracked],
                             obs[tracked], thr, fx)
        err = np.full(len(obs), np.inf)
        alive = s0["alive"]
        err[alive] = reprojection_px(Rr, tr, s0["world"][alive], obs[alive],
                                     fx)
        keep = tracked & (err <= 0.5 * thr)
        drop = s0["alive"] & (~tracked | (err > 2.0 * thr))
        tally["retired"] += [int((keep & ~carried).sum()), int(keep.sum())]
        tally["kept"] += [int((carried & drop).sum()), int(carried.sum())]
    if not sample["boot"] and carried.sum() >= 6:
        world = s1["world"][carried]
        obs = np.stack([(s1["xs"][carried] - cx) / fx,
                        (s1["ys"][carried] - cy) / cam["fy"]], -1)
        Rr, tr = refine_pose(s0["R"], s0["t"], world, obs)
        gap = np.hypot(*(project(s1["R"], s1["t"], world)
                         - project(Rr, tr, world)).T)
        out["pose_gap_px"] = max(out["pose_gap_px"], float(gap.max() * fx))
    if spawned.any():
        sx = s1["xs"][spawned]
        sy = s1["ys"][spawned]
        disp, ok = sad_disparity(left, right, sy, sx, vo["min_disparity"],
                                 vo["max_disparity"], vo["disparity_radius"],
                                 fixed["texture_threshold"])
        if ok.any():
            Xw = lift(sx, sy, disp, fx, cx, cy, cam["baseline"], s1["R"],
                      s1["t"])
            dist = np.linalg.norm(Xw + s1["R"].T @ s1["t"], axis=1)
            gap = np.linalg.norm(s1["world"][spawned] - Xw, axis=1) / dist
            out["spawn_world_gap"] = max(out["spawn_world_gap"],
                                         float(gap[ok].max()))
        worst = 0.0
        for lvl, s in enumerate(scales):
            gx, gy = sobel(levels[lvl])
            for img, key in ((levels[lvl], "desc"), (gx, "grad_x"),
                             (gy, "grad_y")):
                ref = sample_patches(img, sy / s, sx / s, r)
                prog = np.asarray(s1["templates"][key][lvl],
                                  np.float64)[spawned]
                worst = max(worst, float(np.max(np.abs(prog - ref))))
        out["template_gap"] = max(out["template_gap"], worst)


def compare(samples: list, vo: dict, fixed: dict, cam: dict) -> dict:
    """The numbers of ``NUMBERS`` over every sample (0 where a sample has
    nothing of that kind)."""
    out = {k: 0 for k in NUMBERS}
    tally = {"retired": np.zeros(2, np.int64), "kept": np.zeros(2, np.int64)}
    for sample in samples:
        _step_numbers(sample, vo, fixed, cam, out, tally)
    for key, (wrong, total) in (("wrongly_retired", tally["retired"]),
                                ("wrongly_kept", tally["kept"])):
        out[key] = float(wrong / total) if total else 0
    return out
