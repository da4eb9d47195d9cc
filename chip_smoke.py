#!/usr/bin/env python3
"""Drive the PyTorch port's stereo-VO main path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line(s); any failure exits non-zero:

1. environment: card name and power limit, torch / CUDA versions, nvcc,
   TF32 switches; fails without a CUDA device;
2. build: both kernels (``window_gather``, ``klt_track``) from
   ``boofcv_tpu_torch/kernels/csrc``, one ``nvcc`` each, started together;
3. each kernel vs its plain version on the card at the main path's shapes.
   ``window_gather`` (KLT 512 windows of 24x16 on every pyramid level of
   640x480, sparse-SAD strips 7x102 and 7x7 with negative columns and rows
   past the image, odd image sizes): bit-equal.  ``klt_track`` (512 tracks
   on two consecutive 640x480 frames of the scene, pyramid 1/2/4/8, with
   border tracks and zero-template slots; and 256 tracks on 128x160, 3
   levels): fault codes equal on >= 99 % of tracks, positions within 2e-3 px
   where both say TRACK_OK (the kernel sums the 49 patch terms in another
   order than ``torch.sum``).  Times from CUDA events (200 back-to-back
   calls: the rate at which the host can launch them) and from the profiler
   (the kernel's own time on the device), each beside its bound;
4. the slice at full width: the 640x480 reference scene (41 frames) through
   ``StereoVisualOdometry`` with the default config (512 tracks, pyramid
   1/2/4/8, disparity 0-96, 256 RANSAC hypotheses), checked against the
   ground-truth poses, with each kernel's launches counted, then the
   sequence runner timed after a warm-up;
5. host syncs by call site in two steady-state steps, the kernels one
   steady-state step launches with the device time they take, and the
   step's stages timed one by one;
6. both kernels with the stream axis, one launch for B streams, against
   their plain versions and against 2-D launches on each stream's data
   (bit-equal): ``window_gather`` at [8, 512] origins for 7x102 and 7x7,
   ``klt_track`` at [8, 512] tracks on 8 different frames and on one frame
   shared by the streams (stride 0); times and bounds at B = 8 and 16;
7. the B-stream path at full width: batched bootstrap and
   ``make_batched_sequence_runner(shared_frames=True)`` over 12 frames for
   B = 4, 8, 16 (and 1, 32, 64, 128, 256, to see where the aggregate rate
   stops following B), and B = 8 on 8 different sequences (the scene started at
   8 offsets).  Every stream must keep every pose inside the accuracy bars,
   stream 0 must agree with the single-stream runner (same seed, same
   frames) within 1e-4 on ``t``, ``klt_track`` must launch once per step
   and ``window_gather`` twice per spawn or bootstrap whatever B is, and a
   steady-state batched step must make one host sync.  Aggregate frames/s
   (median of 3 runs), the profiled step at B = 1 and B = 16, the stage
   table and peak device memory at B = 16;
8. a 1280x720 single-stream run (12 frames, K fx=720, seed 3).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

H, W = 480, 640
K = np.array([[480.0, 0.0, W / 2], [0.0, 480.0, H / 2], [0.0, 0.0, 1.0]])
BASELINE = 0.4
N_FRAMES = 41
T_BATCHED = 12            # frames of each batched run and of the 1280x720 run
H_720P, W_720P, FX_720P = 720, 1280, 720.0
B_ROWS = (1, 4, 8, 16, 32, 64, 128, 256)    # streams of the batched runs
KERNELS = {
    "window_gather": {
        "source": "boofcv_tpu_torch/kernels/csrc/window_gather.cu",
        "replaces": "boofcv_tpu/kernels/window_gather.py:95"},
    "klt_track": {
        "source": "boofcv_tpu_torch/kernels/csrc/klt_track.cu",
        "replaces": "boofcv_tpu/kernels/window_gather.py:95 + "
                    "boofcv_tpu/feature/klt.py:107"},
}
# published peaks of one H100 SXM: device memory rate, f32 outside the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str):
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel: str | None = None) -> float:
    """Device time of one ``fn()`` from the profiler: the median time of
    the kernel whose name contains ``kernel`` (which must run once per
    call), or with no name the summed time of every kernel, per call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if kernel is None:
        check(len(events) > 0, "the profiler saw no kernel")
        return sum(e.device_time for e in events) / reps / 1e3
    times = [e.device_time for e in events if kernel in e.name]
    # on a busy host the profiler drops events of a long run of launches
    # (30 of 50 seen once); the median of half of them is still the kernel's
    check(reps // 2 <= len(times) <= reps,
          f"the profiler saw {kernel} {len(times)} times in {reps} calls")
    return float(np.median(times)) / 1e3


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the f32 rate."""
    t_b, t_f = n_bytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return {"bound_ms": 1e3 * max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations",
            "bytes": int(n_bytes), "flops": int(flops)}


def touched_bytes(h: int, w: int, oy, ox, wy: int, wx: int,
                  shared: bool = False) -> int:
    """Bytes of the distinct pixels of an [h, w] f32 image that windows at
    (oy, ox) [N] read (clamped reads).  With [B, N] origins: of B images,
    stream b's windows on image b, or with ``shared`` of the one image every
    stream reads."""
    dev = oy.device
    rows = (oy.long()[..., None] + torch.arange(wy, device=dev)).clamp_(
        0, h - 1)
    cols = (ox.long()[..., None] + torch.arange(wx, device=dev)).clamp_(
        0, w - 1)
    flat = rows[..., :, None] * w + cols[..., None, :]
    if oy.dim() == 2 and not shared:
        flat = flat + (torch.arange(oy.shape[0], device=dev) * (h * w)
                       )[:, None, None, None]
    return 4 * int(torch.unique(flat).numel())


def phase_environment():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc {shutil.which('nvcc')} "
          f"ninja {shutil.which('ninja')}")
    import boofcv_tpu_torch  # noqa: F401  (sets the precision policy)
    print(f"tf32: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is enabled")


def phase_build():
    """Both kernels, one nvcc each, started together."""
    from boofcv_tpu_torch.kernels import _nvcc, klt_track, window_gather
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(window_gather._kernel_lib),
                  pool.submit(klt_track._kernel_lib)]:
            f.result()
    wall = time.perf_counter() - t0
    for name in KERNELS:
        rec = _nvcc.build_record(name)
        print(f"build: {name} built={rec['built']} "
              f"nvcc_s={rec['build_s']:.3f} flags={' '.join(rec['flags'])}")
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name} ptxas: {line.strip()}")
    print(f"build: both kernels built and loaded in {wall:.3f}s")


def phase_kernel(dev) -> dict:
    """Kernel vs plain version at the main path's shapes."""
    from boofcv_tpu_torch.kernels import window_gather as wg
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for s in (1, 2, 4, 8):                              # KLT, every level
        h, w = H // s, W // s
        cy = torch.rand(512, generator=g, device=dev) * h
        cx = torch.rand(512, generator=g, device=dev) * w
        oy, ox, _, _ = wg.aligned_window_origin(cy, cx, 3, h, w, 24, 16)
        cases.append((f"klt_{h}x{w}", h, w, oy, ox, 24, 16))
    ys = torch.randint(0, H, (512,), generator=g, device=dev,
                       dtype=torch.int32)
    xs = torch.randint(0, W, (512,), generator=g, device=dev,
                       dtype=torch.int32)
    ys[:4] = torch.tensor([0, 1, H - 1, H - 2], dtype=torch.int32)
    xs[:4] = torch.tensor([0, 2, W - 1, 50], dtype=torch.int32)
    cases.append(("sad_strip_7x102", H, W, ys - 3, xs - 3 - 95, 7, 102))
    cases.append(("sad_patch_7x7", H, W, ys - 3, xs - 3, 7, 7))
    for h, w in ((37, 53), (15, 20)):
        oy = torch.randint(-30, h + 10, (300,), generator=g, device=dev,
                           dtype=torch.int32)
        ox = torch.randint(-110, w + 10, (300,), generator=g, device=dev,
                           dtype=torch.int32)
        cases.append((f"odd_{h}x{w}", h, w, oy, ox, 24, 16))
    max_err = 0.0
    imgs = {}
    for name, h, w, oy, ox, wy, wx in cases:
        img = imgs.setdefault((h, w), torch.rand((h, w), generator=g,
                                                 device=dev) * 255.0)
        got = wg.gather_windows_cuda(img, oy.contiguous(), ox.contiguous(),
                                     wy, wx)
        want = wg.gather_windows_reference(img, oy, ox, wy, wx)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        print(f"kernel: {name} n={oy.shape[0]} window={wy}x{wx} "
              f"equal={torch.equal(got, want)} max_abs_err={err}")
        check(torch.equal(got, want), f"kernel differs from plain at {name}")
    # bounds at the three main-path shapes, from these origins
    bounds = {}
    for name, h, w, oy, ox, wy, wx in (cases[0], cases[4], cases[5]):
        n = oy.shape[0]
        bounds[name] = bound(touched_bytes(h, w, oy, ox, wy, wx)
                             + 4 * n * wy * wx + 8 * n, 0)
        print(f"kernel: window_gather {name} n={n} window={wy}x{wx} "
              f"bytes={bounds[name]['bytes']} "
              f"bound_ms={bounds[name]['bound_ms']:.6f} bound_by=bytes")
    # times at the KLT shape on the full-resolution level
    name, h, w, oy, ox, wy, wx = cases[0]
    img = imgs[(h, w)]
    kern = lambda: wg.gather_windows_cuda(img, oy, ox, wy, wx)
    plain = lambda: wg.gather_windows_reference(img, oy, ox, wy, wx)
    ms = cuda_ms(kern, 200)
    plain_ms = cuda_ms(plain, 200)
    dev_ms = device_ms(kern, 50, "window_gather_kernel")
    plain_dev_ms = device_ms(plain, 50)
    print(f"kernel: window_gather {name} n=512 24x16 kernel_ms={ms:.6f} "
          f"plain_ms={plain_ms:.6f} (CUDA events, 200 back-to-back calls) "
          f"device_ms={dev_ms:.6f} plain_device_ms={plain_dev_ms:.6f} "
          f"(profiler) library_ms=None (no single PyTorch call)")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
            "bound_ms": bounds[name]["bound_ms"],
            "bound_by": bounds[name]["bound_by"], "library_ms": None}


def _klt_case_scene(dev, left0, left1, jitter=None):
    """512 tracks a stream: templates on ``left0``, pyramid of ``left1``
    ([H, W] tensors, or [B, H, W] for B streams; ``left1`` may be one frame
    expanded over the streams).  464 corners from the VO's own detector
    (moved by ``jitter`` [B, 464] px where the streams share ``left0``, so
    that they track different points), 32 tracks within 6 px of a border
    (negative and clamped window origins), 16 dead slots with all-zero
    templates (8 at (0, 0), 8 inside the image)."""
    from boofcv_tpu_torch.core.pyramid import PyramidConfig
    from boofcv_tpu_torch.feature import klt
    from boofcv_tpu_torch.ip import pyramid_ops
    from boofcv_tpu_torch.sfm import stereo_vo
    scales = (1, 2, 4, 8)
    det = stereo_vo._detect_candidates(left0, stereo_vo.StereoVoConfig(), 512)
    rng = np.random.default_rng(5)
    edge = rng.uniform(0, 6, 8).astype(np.float32)
    mid_y = rng.uniform(10, H - 11, 8).astype(np.float32)
    mid_x = rng.uniform(10, W - 11, 8).astype(np.float32)
    tail_y = np.concatenate([edge, H - 1 - edge, mid_y, mid_y,
                             np.zeros(8, np.float32), mid_y])
    tail_x = np.concatenate([mid_x, mid_x, edge, W - 1 - edge,
                             np.zeros(8, np.float32), mid_x])
    lead = left0.shape[:-2]
    det_y = det.ys.to(torch.float32)[..., :464]
    det_x = det.xs.to(torch.float32)[..., :464]
    if jitter is not None:
        det_y, det_x = det_y + jitter, det_x - jitter
    tail = lambda a: torch.from_numpy(a).to(dev).expand(lead + (48,))
    ys = torch.cat([det_y, tail(tail_y)], dim=-1).contiguous()
    xs = torch.cat([det_x, tail(tail_x)], dim=-1).contiguous()
    p0 = pyramid_ops.pyramid_average(left0, PyramidConfig(scales))
    p1 = pyramid_ops.pyramid_average(left1, PyramidConfig(scales))
    tm = klt.sample_templates(p0, pyramid_ops.gradient(p0), ys, xs, scales, 3)
    dead = torch.zeros(512, dtype=torch.bool, device=dev)
    dead[-16:] = True
    zero = lambda ts: tuple(torch.where(dead[:, None, None], 0.0, t)
                            for t in ts)
    tm = klt.KltTemplates(zero(tm.desc), zero(tm.grad_x), zero(tm.grad_y))
    return p1, tm, ys, xs, scales


def _klt_small_scene(dev):
    """256 tracks on a 128x160 noise texture shifted by (2, -3), 3 levels
    (the size of the card tests)."""
    from boofcv_tpu_torch.core.pyramid import PyramidConfig
    from boofcv_tpu_torch.feature import klt
    from boofcv_tpu_torch.io import simulate
    from boofcv_tpu_torch.ip import pyramid_ops
    scales = (1, 2, 4)
    tex = simulate.noise_texture(np.random.default_rng(3), size=256)
    f0 = torch.from_numpy(tex[40:168, 50:210].copy()).to(dev)
    f1 = torch.from_numpy(tex[42:170, 47:207].copy()).to(dev)
    rng = np.random.default_rng(1)
    ys = torch.from_numpy(rng.uniform(0, 127, 256).astype(np.float32)).to(dev)
    xs = torch.from_numpy(rng.uniform(0, 159, 256).astype(np.float32)).to(dev)
    p0 = pyramid_ops.pyramid_average(f0, PyramidConfig(scales))
    p1 = pyramid_ops.pyramid_average(f1, PyramidConfig(scales))
    tm = klt.sample_templates(p0, pyramid_ops.gradient(p0), ys, xs, scales, 3)
    return p1, tm, ys, xs, scales


def _klt_image_bytes(pyr, tm, ys, xs, scales, cfg) -> int:
    """Bytes of the distinct pixels the windows of all levels read: the
    plain version's level loop, with the origins of each level counted.
    Streams that view one frame (stride 0) share its pixels."""
    from boofcv_tpu_torch.feature import klt
    from boofcv_tpu_torch.kernels import window_gather as wg
    total = 0
    cy, cx = ys / scales[-1], xs / scales[-1]
    for lvl in range(len(scales) - 1, -1, -1):
        h, w = pyr[lvl].shape[-2:]
        shared = pyr[lvl].dim() == 3 and pyr[lvl].stride(0) == 0
        oy, ox, _, _ = wg.aligned_window_origin(cy, cx, cfg.template_radius,
                                                h, w, 24, 16)
        total += touched_bytes(h, w, oy, ox, 24, 16, shared)
        cy_l, cx_l, f = klt._track_level_windowed(
            pyr[lvl], tm.desc[lvl], tm.grad_x[lvl], tm.grad_y[lvl], cy, cx,
            cfg)
        good = f == klt.TRACK_OK
        cy, cx = torch.where(good, cy_l, cy), torch.where(good, cx_l, cx)
        if lvl > 0:
            cy = cy * (scales[lvl] / scales[lvl - 1])
            cx = cx * (scales[lvl] / scales[lvl - 1])
    return total


def _klt_args(pyr, tm, ys, xs, scales, cfg):
    """The arguments of ``klt_track_cuda`` for a scene."""
    from boofcv_tpu_torch.kernels import window_gather as wg
    f32 = lambda seq: [t.contiguous() for t in seq]
    return ([wg.as_planes(p) for p in pyr], f32(tm.desc), f32(tm.grad_x),
            f32(tm.grad_y), ys, xs, scales, cfg.template_radius,
            cfg.max_iterations, cfg.max_per_pixel_error, cfg.min_determinant,
            cfg.convergence_tol)


def _klt_bound(pyr, tm, ys, xs, scales, cfg) -> tuple:
    """(bound, evaluations) of one ``klt_track`` launch from this run's
    data: every input once, every output once (the distinct image pixels of
    the mode it runs in, the templates, positions in and out, fault and
    count out); about 15 flops per patch pixel and evaluation, 6 per pixel
    and level for the 2x2 system."""
    from boofcv_tpu_torch.kernels import klt_track as kt
    n = ys.numel()
    n_evals = int(kt.klt_track_cuda(*_klt_args(pyr, tm, ys, xs, scales,
                                               cfg))[3].sum())
    area = (2 * cfg.template_radius + 1) ** 2
    img_bytes = _klt_image_bytes(pyr, tm, ys, xs, scales, cfg)
    tmpl_bytes = len(scales) * 3 * n * area * 4
    bnd = bound(img_bytes + tmpl_bytes + 8 * n + 16 * n,
                15 * area * n_evals + 6 * area * n * len(scales))
    bnd.update(image_bytes=img_bytes, template_bytes=tmpl_bytes)
    return bnd, n_evals


def phase_klt_kernel(dev, frames) -> dict:
    """``klt_track`` vs the plain version on the card."""
    from boofcv_tpu_torch.feature import klt
    from boofcv_tpu_torch.kernels import klt_track as kt
    cfg = klt.KltConfig()
    out = {}
    left = lambda i: torch.from_numpy(frames[i][0]).to(dev)
    for name, scene in (("main_480x640",
                         _klt_case_scene(dev, left(0), left(1))),
                        ("small_128x160", _klt_small_scene(dev))):
        pyr, tm, ys, xs, scales = scene
        n = ys.shape[0]
        before = kt.launch_count()
        gy, gx, gf = klt.track_pyramid(pyr, tm, ys, xs, scales, cfg)
        check(kt.launch_count() == before + 1,
              "track_pyramid on CUDA tensors did not launch klt_track once")
        wy_, wx_, wf = klt.track_pyramid_reference(pyr, tm, ys, xs, scales,
                                                   cfg)
        torch.cuda.synchronize()
        same = gf == wf
        both_ok = (gf == klt.TRACK_OK) & (wf == klt.TRACK_OK)
        dy = float((gy - wy_).abs()[both_ok].max())
        dx = float((gx - wx_).abs()[both_ok].max())
        counts = {int(c): int((wf == c).sum()) for c in wf.unique()}
        print(f"kernel: klt_track {name} n={n} levels={len(scales)} "
              f"faults_equal={int(same.sum())}/{n} both_ok="
              f"{int(both_ok.sum())} max_abs_dy={dy:.3e} max_abs_dx={dx:.3e} "
              f"plain_fault_counts={counts}")
        for i in torch.nonzero(~same).flatten().tolist():
            print(f"kernel: klt_track {name} mismatch track {i} start=("
                  f"{float(ys[i]):.4f}, {float(xs[i]):.4f}) kernel=("
                  f"{float(gy[i]):.6f}, {float(gx[i]):.6f}, {int(gf[i])}) "
                  f"plain=({float(wy_[i]):.6f}, {float(wx_[i]):.6f}, "
                  f"{int(wf[i])})")
        check(bool(torch.isfinite(gy).all() and torch.isfinite(gx).all()),
              f"klt_track {name}: non-finite position")
        check(int(same.sum()) >= 0.99 * n,
              f"klt_track {name}: fault codes equal on {int(same.sum())} of "
              f"{n} tracks (< 99 %)")
        check(int(both_ok.sum()) >= n // 2,
              f"klt_track {name}: only {int(both_ok.sum())} tracks OK")
        check(max(dy, dx) <= 2e-3,
              f"klt_track {name}: positions differ by {max(dy, dx)} px")
        out[name] = max(dy, dx)
        if name != "main_480x640":
            continue
        check(int((wf[-16:] != klt.TRACK_OK).sum()) == 16
              and int((gf[-16:] != klt.TRACK_OK).sum()) == 16,
              "a zero-template slot tracked")
        args = _klt_args(pyr, tm, ys, xs, scales, cfg)
        bnd, n_evals = _klt_bound(pyr, tm, ys, xs, scales, cfg)
        print(f"kernel: klt_track {name} evaluations={n_evals} "
              f"({n_evals / n / len(scales):.3f} per track and level, at "
              f"most {cfg.max_iterations}) image_bytes={bnd['image_bytes']} "
              f"template_bytes={bnd['template_bytes']} bytes={bnd['bytes']} "
              f"flops={bnd['flops']} bound_ms={bnd['bound_ms']:.6f} "
              f"bound_by={bnd['bound_by']}")
        kern = lambda: kt.klt_track_cuda(*args)
        plain = lambda: klt.track_pyramid_reference(pyr, tm, ys, xs, scales,
                                                    cfg)
        ms = cuda_ms(kern, 200)
        plain_ms = cuda_ms(plain, 20)
        dev_ms = device_ms(kern, 50, "klt_track_kernel")
        plain_dev_ms = device_ms(plain, 5)
        print(f"kernel: klt_track {name} kernel_ms={ms:.6f} (CUDA events, "
              f"200 back-to-back calls) plain_ms={plain_ms:.6f} (20 calls) "
              f"device_ms={dev_ms:.6f} plain_device_ms={plain_dev_ms:.6f} "
              f"(profiler) library_ms=None (no single PyTorch call)")
        out.update({"ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
                    "plain_device_ms": plain_dev_ms,
                    "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
                    "library_ms": None})
    out["max_abs_err"] = max(out.pop("main_480x640"),
                             out.pop("small_128x160"))
    return out


def _scene(n_frames: int, k, h: int, w: int, seed: int):
    """The reference benchmark scene: forward creep with slow yaw over a
    textured plane at z=8 (bench.py's sequence), rendered on the host."""
    from boofcv_tpu_torch.io import simulate
    poses = []
    for i in range(n_frames):
        a = 0.002 * i
        R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                      [-np.sin(a), 0.0, np.cos(a)]])
        c = np.array([0.01 * i, 0.0, 0.05 * i])
        poses.append((R, -R @ c))
    frames = simulate.render_stereo_sequence(
        np.random.default_rng(seed), k, BASELINE, poses, h, w,
        plane_origin=(0.0, 0.0, 8.0), texture_scale=55.0)
    return poses, frames


def _accuracy(Rs, ts, poses) -> tuple:
    """(ATE, total motion, final rotation error in degrees) of world->camera
    poses ``Rs`` [T, 3, 3], ``ts`` [T, 3] (numpy) against the ground truth
    ``poses`` [T + 1] of the frames from the bootstrap frame on; the
    estimate's world is the bootstrap frame's camera."""
    R0, t0 = poses[0]
    gt = []
    for R, t in poses[1:]:
        Rrel = R @ R0.T
        gt.append((Rrel, t - Rrel @ t0))
    centres = np.stack([-R.T @ t for R, t in zip(Rs, ts)])
    gt_c = np.stack([-R.T @ t for R, t in gt])
    ate = float(np.mean(np.linalg.norm(centres - gt_c, axis=1)))
    return (ate, float(np.linalg.norm(gt_c[-1])),
            _rot_err_deg(Rs[-1].T, gt[-1][0]))


def _rot_err_deg(Rest_c2w, Rgt_w2c) -> float:
    dR = Rest_c2w.T @ Rgt_w2c.T
    return float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2,
                                              -1, 1))))


def _stage_table(tag, cfg, state, lefts, rights) -> None:
    """Host wall ms of each stage of a steady-state step, a synchronize
    before and after each, medians over 10 frames; then a forced spawn.
    ``state`` of one stream with [H, W] frames in ``lefts[i]``, or stacked
    with [B, H, W] frames."""
    from boofcv_tpu_torch.feature import klt
    from boofcv_tpu_torch.geo import pnp, robust
    from boofcv_tpu_torch.ip import pyramid_ops
    from boofcv_tpu_torch.sfm import stereo_vo
    ms = collections.defaultdict(list)

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            ms[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    track_estimate, spawn_fn = stereo_vo._make_step_parts(cfg, K, BASELINE)
    patches = [(pyramid_ops, "pyramid_average", "pyramid"),
               (klt, "track_pyramid", "klt_track_pyramid"),
               (robust, "sample_indices", "ransac_sample_indices"),
               (robust, "ransac", "ransac_total"),
               (pnp, "gauss_newton_pose", "gn_refine")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    try:
        for mod, attr, name in patches:
            setattr(mod, attr, timed(name, getattr(mod, attr)))
        te = timed("track_estimate", track_estimate)
        for i in range(10):
            state, pyramid, l32, r32, _, _ = te(state, lefts[i], rights[i])
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    timed("spawn_forced", spawn_fn)(state, pyramid, l32, r32)
    step = stereo_vo.make_step(cfg, K, BASELINE)
    for i in range(10):
        timed("full_step", step)(state, lefts[i], rights[i])
    med = {k: float(np.median(v)) for k, v in ms.items()}
    med["ransac_p3p_bank_score_select"] = (med.pop("ransac_total")
                                           - med["ransac_sample_indices"])
    print(f"stages: {tag} host wall ms with a synchronize around each, "
          "medians of 10 steady-state frames (spawn: one forced call): "
          + " ".join(f"{k}={v:.3f}" for k, v in med.items()))


def phase_slice(dev, poses, frames) -> dict:
    from boofcv_tpu_torch.kernels import klt_track as kt
    from boofcv_tpu_torch.kernels import window_gather as wg
    from boofcv_tpu_torch.sfm import stereo_vo
    cfg = stereo_vo.StereoVoConfig()
    vo = stereo_vo.StereoVisualOdometry(cfg, K, BASELINE, H, W, seed=0,
                                        device=dev)

    # the main path, counted: bootstrap + 40 steps through process()
    wg.reset_launch_count()
    kt.reset_launch_count()
    oks, centres, rots, frame_s = [], [], [], []
    spawns, next_uid = 0, 0
    for left, right in frames:
        t1 = time.perf_counter()
        oks.append(vo.process(left, right))
        frame_s.append(time.perf_counter() - t1)
        R, c = vo.camera_to_world()
        centres.append(c)
        rots.append(R)
        uid = int(vo.state.next_uid)
        if len(oks) == 1:
            boot_state = vo.state
        elif uid != next_uid:
            spawns += 1          # a spawn that filled at least one slot
        next_uid = uid
    torch.cuda.synchronize()
    launches = {"window_gather": wg.launch_count(),
                "klt_track": kt.launch_count()}
    gt = np.stack([-R.T @ t for R, t in poses])
    ate = float(np.mean(np.linalg.norm(np.stack(centres) - gt, axis=1)))
    total = float(np.linalg.norm(gt[-1]))
    rot = _rot_err_deg(rots[-1], poses[-1][0])
    n_ok = sum(oks[1:])
    print(f"slice: pose_ok={n_ok}/{N_FRAMES - 1} ate={ate:.6f} "
          f"total_motion={total:.6f} ate_frac={ate / total:.6f} "
          f"final_rot_err_deg={rot:.6f} inliers_last={vo.metrics['inliers']}"
          f" alive_last={vo.metrics['alive']}")
    print(f"slice: launches in bootstrap+{N_FRAMES - 1} steps: klt_track="
          f"{launches['klt_track']} window_gather="
          f"{launches['window_gather']} (spawns seen after the bootstrap: "
          f"{spawns})")
    print(f"slice: process() per-frame wall ms (step + pose readback): "
          f"median={1e3 * np.median(frame_s[1:]):.3f} "
          f"p90={1e3 * np.percentile(frame_s[1:], 90):.3f} "
          f"bootstrap={1e3 * frame_s[0]:.3f}")
    check(launches["klt_track"] == N_FRAMES - 1,
          f"klt_track launched {launches['klt_track']} times in "
          f"{N_FRAMES - 1} track_pyramid calls")
    check(launches["window_gather"] >= 2 + 2 * spawns
          and launches["window_gather"] % 2 == 0,
          f"window_gather launched {launches['window_gather']} times: "
          f"expected 2 for the bootstrap and 2 for each of >= {spawns} spawns")
    check(ate < 0.15 * total, f"ATE {ate} >= 0.15 x motion {total}")
    check(rot < 2.0, f"final rotation error {rot} deg >= 2")
    check(n_ok == N_FRAMES - 1, f"pose_ok on {n_ok} of {N_FRAMES - 1} frames")

    # throughput: the sequence runner from the bootstrap state
    run = stereo_vo.make_sequence_runner(cfg, K, BASELINE)
    lefts = torch.stack([torch.from_numpy(l) for l, _ in frames[1:]]).to(dev)
    rights = torch.stack([torch.from_numpy(r) for _, r in frames[1:]]).to(dev)
    s_end, ((Rs, ts), ms) = run(boot_state, lefts, rights)   # warm-up
    torch.cuda.synchronize()
    same = bool(torch.equal(s_end.R, vo.state.R))
    fps = []
    for _ in range(3):
        t1 = time.perf_counter()
        s_end, ((Rs, ts), ms) = run(boot_state, lefts, rights)
        torch.cuda.synchronize()
        fps.append((N_FRAMES - 1) / (time.perf_counter() - t1))
    check(bool(ms["pose_ok"].all()), "sequence runner lost a pose")
    check(bool(torch.isfinite(Rs).all() and torch.isfinite(ts).all()),
          "non-finite pose from the sequence runner")
    print(f"slice: sequence runner {N_FRAMES - 1} frames fps_runs="
          f"{[round(f, 3) for f in fps]} median_fps={np.median(fps):.3f} "
          f"ms_per_frame={1e3 / np.median(fps):.3f} "
          f"final_R_equals_process={same}")
    print(f"slice: peak device memory MiB="
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f}")

    # host syncs in one steady-state step
    step = stereo_vo.make_step(cfg, K, BASELINE)
    k = lefts.shape[0] // 2
    state = run(boot_state, lefts[:k], rights[:k])[0]
    torch.cuda.synchronize()
    state, _ = _count_syncs("single stream", step, state, lefts[k:k + 2],
                            rights[k:k + 2])
    _profile_step("B=1 (single-stream step)", step, state, lefts[k + 2:k + 9],
                  rights[k + 2:k + 9])
    _stage_table("B=1", cfg, state, lefts[k + 2:], rights[k + 2:])
    return {"launches": launches, "ts": ts.cpu().numpy()}


def _count_syncs(tag, step, state, lefts, rights) -> tuple:
    """Run ``step`` over the frames with sync warnings on; returns the last
    state and the count of host syncs, printed by call site."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for left, right in zip(lefts, rights):
                state, _ = step(state, left, right)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "called a synchronizing CUDA operation" in str(w.message))
    n = sum(syncs.values())
    print(f"syncs: {tag}: {n} host syncs in {len(lefts)} steady-state "
          f"steps, by call site: {dict(sorted(syncs.items()))}")
    return state, n


LIBRARY_OPS = ("aten::linalg_cholesky_ex", "aten::linalg_solve_triangular",
               "aten::rand")


def _profile_step(tag, step, state, lefts, rights) -> None:
    """Step time (host wall, median of the steps before the last, each ended
    by a synchronize, not profiled), then the last step under the profiler:
    kernels launched, device busy ms, the idle share of the unprofiled step,
    and the host and device time of the library calls the step makes."""
    wall = []
    for left, right in zip(lefts[:-1], rights[:-1]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, _ = step(state, left, right)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t1))
    step_ms = float(np.median(wall))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(state, lefts[-1], rights[-1])
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t1)
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    klt_ms = sum(e.device_time for e in kernels
                 if "klt_track_kernel" in e.name) / 1e3
    print(f"device: {tag}: step {step_ms:.3f} ms (host wall, median of "
          f"{len(wall)}); one profiled step launches {len(kernels)} kernels, "
          f"device busy {busy_ms:.3f} ms ({prof_ms:.3f} ms wall under the "
          f"profiler), idle share {1 - busy_ms / step_ms:.4f} of the "
          f"unprofiled step; klt_track_kernel {klt_ms:.6f} ms of it")
    by_key = {e.key: e for e in prof.key_averages()}
    for name in LIBRARY_OPS:
        e = by_key.get(name)
        if e is not None:
            print(f"device: {tag}: {name} calls={e.count} host_ms="
                  f"{e.cpu_time_total / 1e3:.3f} device_ms="
                  f"{e.device_time_total / 1e3:.3f} (one profiled step; "
                  f"host time includes the ops it calls)")
    check(len(kernels) > 0, f"{tag}: the profiled step ran nothing on the "
                            "device")
    check(klt_ms > 0, f"{tag}: the profiled step did not run "
                      "klt_track_kernel")


def _times(kern, plain, kernel_name: str, plain_reps: int) -> dict:
    """ms over 200 back-to-back calls (CUDA events) and device ms (profiler)
    of a kernel's wrapper, and the same of its plain version."""
    return {"ms": cuda_ms(kern, 200), "plain_ms": cuda_ms(plain, plain_reps),
            "device_ms": device_ms(kern, 50, kernel_name),
            "plain_device_ms": device_ms(plain, max(plain_reps // 4, 2)),
            "library_ms": None}


def _print_times(what: str, bnd: dict, t: dict) -> dict:
    print(f"kernel: {what} bytes={bnd['bytes']} flops={bnd['flops']} "
          f"bound_ms={bnd['bound_ms']:.6f} bound_by={bnd['bound_by']} "
          f"device_ms={t['device_ms']:.6f} (profiler) kernel_ms={t['ms']:.6f} "
          f"(CUDA events, 200 back-to-back calls) plain_ms="
          f"{t['plain_ms']:.6f} plain_device_ms={t['plain_device_ms']:.6f} "
          f"library_ms=None (no single PyTorch call)")
    return {**t, "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"]}


def phase_batched_kernels(dev, frames) -> dict:
    """Both kernels with the stream axis: B streams in one launch, against
    the plain versions and against 2-D launches on each stream's data."""
    from boofcv_tpu_torch.feature import klt
    from boofcv_tpu_torch.kernels import klt_track as kt
    from boofcv_tpu_torch.kernels import window_gather as wg
    lefts = torch.stack([torch.from_numpy(frames[i][0])
                         for i in range(17)]).to(dev)
    out = {"window_gather": {}, "klt_track": {}}

    # window_gather: the sparse SAD's two shapes, [B, 512] origins
    g = torch.Generator(device=dev).manual_seed(1)
    ys = torch.randint(0, H, (16, 512), generator=g, device=dev,
                       dtype=torch.int32)
    xs = torch.randint(0, W, (16, 512), generator=g, device=dev,
                       dtype=torch.int32)
    ys[:, :4] = torch.tensor([0, 1, H - 1, H - 2], dtype=torch.int32)
    xs[:, :4] = torch.tensor([0, 2, W - 1, 50], dtype=torch.int32)
    shapes = (("sad_strip_7x102", ys - 3, xs - 3 - 95, 7, 102),
              ("sad_patch_7x7", ys - 3, xs - 3, 7, 7))
    for name, oy, ox, wy, wx in shapes:
        for mode in ("frames", "shared"):
            imgs = lefts[:8] if mode == "frames" else lefts[0].expand(8, H, W)
            oy8, ox8 = oy[:8].contiguous(), ox[:8].contiguous()
            before = wg.launch_count()
            got = wg.gather_windows(imgs, oy8, ox8, wy, wx)
            check(wg.launch_count() == before + 1,
                  "a batched gather_windows did not launch once")
            want = wg.gather_windows_reference(imgs, oy8, ox8, wy, wx)
            per_stream = all(torch.equal(got[b], wg.gather_windows_cuda(
                imgs[b], oy8[b], ox8[b], wy, wx)) for b in range(8))
            torch.cuda.synchronize()
            print(f"kernel: window_gather batched {name} {mode} origins="
                  f"[8, 512] equal_plain={torch.equal(got, want)} "
                  f"streams_equal_2d_launches={per_stream}")
            check(torch.equal(got, want),
                  f"batched window_gather differs from plain at {name} {mode}")
            check(per_stream, f"batched window_gather differs from the 2-D "
                              f"launches at {name} {mode}")
    name, oy, ox, wy, wx = shapes[0]
    for b in (8, 16):
        imgs = lefts[:b]
        oyb, oxb = oy[:b].contiguous(), ox[:b].contiguous()
        bnd = bound(touched_bytes(H, W, oyb, oxb, wy, wx)
                    + 4 * b * 512 * wy * wx + 8 * b * 512, 0)
        t = _times(lambda: wg.gather_windows_cuda(imgs, oyb, oxb, wy, wx),
                   lambda: wg.gather_windows_reference(imgs, oyb, oxb, wy,
                                                       wx),
                   "window_gather_kernel", 50)
        out["window_gather"][f"B{b}_{name}"] = _print_times(
            f"window_gather batched {name} origins=[{b}, 512] on {b} frames",
            bnd, t)

    # klt_track: [B, 512] tracks, B different frames and one shared frame
    cfg = klt.KltConfig()
    max_err = 0.0
    for b in (8, 16):
        for mode in ("frames", "shared"):
            if mode == "frames":      # stream i: frame i -> frame i + 1
                scene = _klt_case_scene(dev, lefts[:b], lefts[1:b + 1])
            else:                     # every stream: frame 0 -> frame 1
                jitter = torch.rand((b, 464), device=dev, generator=g) - 0.5
                scene = _klt_case_scene(dev, lefts[0].expand(b, H, W),
                                        lefts[1].expand(b, H, W), jitter)
            pyr, tm, ys_, xs_, scales = scene
            check(all((p.stride(0) == 0) == (mode == "shared") for p in pyr),
                  f"the {mode} pyramid has the other layout")
            what = f"klt_track batched tracks=[{b}, 512] {mode}"
            if b == 8:
                before = kt.launch_count()
                gy, gx, gf = klt.track_pyramid(pyr, tm, ys_, xs_, scales, cfg)
                check(kt.launch_count() == before + 1,
                      "a batched track_pyramid did not launch klt_track once")
                wy_, wx_, wf = klt.track_pyramid_reference(pyr, tm, ys_, xs_,
                                                           scales, cfg)
                per_stream = True
                for i in range(b):
                    one = klt.KltTemplates(*(tuple(t[i] for t in seq)
                                             for seq in tm))
                    oy_, ox_, of = klt.track_pyramid(
                        tuple(p[i] for p in pyr), one, ys_[i], xs_[i], scales,
                        cfg)
                    per_stream &= (torch.equal(gy[i], oy_)
                                   and torch.equal(gx[i], ox_)
                                   and torch.equal(gf[i], of))
                torch.cuda.synchronize()
                n = gf.numel()
                same = int((gf == wf).sum())
                both_ok = (gf == klt.TRACK_OK) & (wf == klt.TRACK_OK)
                err = max(float((gy - wy_).abs()[both_ok].max()),
                          float((gx - wx_).abs()[both_ok].max()))
                max_err = max(max_err, err)
                print(f"kernel: {what} faults_equal={same}/{n} both_ok="
                      f"{int(both_ok.sum())} max_abs_err_px={err:.3e} "
                      f"streams_equal_2d_launches={per_stream}")
                check(bool(torch.isfinite(gy).all()
                           and torch.isfinite(gx).all()),
                      f"{what}: non-finite position")
                check(same >= 0.99 * n, f"{what}: fault codes equal on {same} "
                                        f"of {n} tracks (< 99 %)")
                check(int(both_ok.sum()) >= n // 2,
                      f"{what}: only {int(both_ok.sum())} tracks OK")
                check(err <= 2e-3, f"{what}: positions differ by {err} px")
                check(per_stream, f"{what}: a stream differs from its 2-D "
                                  "launch")
            args = _klt_args(pyr, tm, ys_, xs_, scales, cfg)
            bnd, n_evals = _klt_bound(pyr, tm, ys_, xs_, scales, cfg)
            print(f"kernel: {what} evaluations={n_evals} image_bytes="
                  f"{bnd['image_bytes']} template_bytes="
                  f"{bnd['template_bytes']}")
            t = _times(lambda: kt.klt_track_cuda(*args),
                       lambda: klt.track_pyramid_reference(
                           pyr, tm, ys_, xs_, scales, cfg),
                       "klt_track_kernel", 8)
            out["klt_track"][f"B{b}_{mode}"] = _print_times(what, bnd, t)
    out["klt_track"]["max_abs_err"] = max_err
    return out


def _expected_gathers(metrics, cfg) -> int:
    """``window_gather`` launches of a bootstrap and the steps that gave
    ``metrics``: 2 for the bootstrap, 2 for every step in which some stream
    fell below the respawn threshold (its live tracks before the spawn are
    the pose's inliers when the pose was accepted, as it must be here)."""
    low = metrics["inliers"].to(torch.float32) / cfg.num_tracks \
        < cfg.respawn_below
    return 2 + 2 * int(low.reshape(low.shape[0], -1).any(dim=1).sum())


def phase_batched(dev, poses, frames, single) -> dict:
    """The B-stream path: batched bootstrap + batched sequence runner."""
    from boofcv_tpu_torch.kernels import klt_track as kt
    from boofcv_tpu_torch.kernels import window_gather as wg
    from boofcv_tpu_torch.sfm import stereo_vo
    cfg = stereo_vo.StereoVoConfig()
    T = T_BATCHED
    L = torch.stack([torch.from_numpy(l) for l, _ in frames]).to(dev)
    R = torch.stack([torch.from_numpy(r) for _, r in frames]).to(dev)
    boot = stereo_vo.make_batched_bootstrap(cfg, K, BASELINE)
    launches = {}

    def drive(tag, b, run, boot_frames, lefts, rights, stream_poses):
        """One counted run (also the warm-up), its checks, then 3 timed."""
        wg.reset_launch_count()
        kt.reset_launch_count()
        s0 = boot(stereo_vo.init_batched_state(cfg, b, H, W, seed=0),
                  *boot_frames)
        s_end, ((Rs, ts), ms) = run(s0, lefts, rights)
        torch.cuda.synchronize()
        launches[tag] = {"klt_track": kt.launch_count(),
                         "window_gather": wg.launch_count()}
        check(Rs.shape == (T, b, 3, 3) and ts.shape == (T, b, 3),
              f"{tag}: poses shaped {tuple(Rs.shape)}, {tuple(ts.shape)}")
        check(bool(torch.isfinite(Rs).all() and torch.isfinite(ts).all()),
              f"{tag}: non-finite pose")
        n_ok = ms["pose_ok"].sum(dim=0).tolist()
        Rn, tn = Rs.cpu().numpy(), ts.cpu().numpy()
        acc = [_accuracy(Rn[:, i], tn[:, i], stream_poses(i))
               for i in range(b)]
        want_wg = _expected_gathers(ms, cfg)
        print(f"batched: {tag} pose_ok per stream={n_ok} of {T}; worst "
              f"stream ate={max(a[0] for a in acc):.6f} of motion "
              f"{acc[0][1]:.6f}, final_rot_err_deg="
              f"{max(a[2] for a in acc):.6f}; alive_last="
              f"{ms['alive'][-1].tolist()}; launches klt_track="
              f"{launches[tag]['klt_track']} window_gather="
              f"{launches[tag]['window_gather']} (expected {T} and "
              f"{want_wg})")
        check(all(n == T for n in n_ok), f"{tag}: pose_ok {n_ok} of {T}")
        for i, (ate, total, rot) in enumerate(acc):
            check(ate < 0.15 * total,
                  f"{tag} stream {i}: ATE {ate} >= 0.15 x motion {total}")
            check(rot < 2.0, f"{tag} stream {i}: final rotation error {rot} "
                             "deg >= 2")
        check(launches[tag]["klt_track"] == T,
              f"{tag}: klt_track launched {launches[tag]['klt_track']} times "
              f"in {T} batched steps")
        check(launches[tag]["window_gather"] == want_wg,
              f"{tag}: window_gather launched "
              f"{launches[tag]['window_gather']} times, expected {want_wg}")
        fps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run(s0, lefts, rights)
            torch.cuda.synchronize()
            fps.append(b * T / (time.perf_counter() - t1))
        med = float(np.median(fps))
        print(f"batched: {tag} aggregate frames/s runs="
              f"{[round(f, 3) for f in fps]} median={med:.3f} per stream="
              f"{med / b:.3f} ms_per_batched_step={1e3 * b / med:.3f}")
        return s0, s_end, ts

    shared = stereo_vo.make_batched_sequence_runner(cfg, K, BASELINE,
                                                    shared_frames=True)
    # B = 4, 8, 16 are the reference benchmark's rows; the others show
    # where the aggregate rate stops following B
    ends = {}
    for b in B_ROWS:
        if b == 16:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        s0, s_end, ts = drive(
            f"B={b} shared frames", b, shared,
            (L[0].expand(b, H, W), R[0].expand(b, H, W)), L[1:T + 1],
            R[1:T + 1], lambda i: poses[:T + 1])
        # stream 0 has the single-stream run's seed and frames
        dt = float(np.abs(ts[:, 0].cpu().numpy() - single["ts"][:T]).max())
        print(f"batched: B={b} stream 0 against the single-stream runner "
              f"(seed 0, same frames): max |dt|={dt:.3e} (bar 1e-4)")
        check(dt <= 1e-4, f"B={b}: stream 0 differs from the single-stream "
                          f"run by {dt} on t")
        ends[b] = s_end
        if b == 16:
            print(f"batched: B=16 peak device memory MiB="
                  f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} (the "
                  f"{N_FRAMES}-frame sequence on the device included)")

    # steady-state step at B = 16: syncs, profile, stage table; and the
    # profile at the largest B, where the device has most to do
    step = stereo_vo.make_batched_step(cfg, K, BASELINE)
    ex = lambda a, b, lo, hi: [f.expand(b, H, W) for f in a[lo:hi]]
    k = T + 1
    state, n_sync = _count_syncs("B=16 batched step", step, ends[16],
                                 ex(L, 16, k, k + 2), ex(R, 16, k, k + 2))
    check(n_sync == 2, f"{n_sync} host syncs in 2 batched steps: expected one "
                       "a step")
    _profile_step("B=16 (batched step)", step, state, ex(L, 16, k + 2, k + 9),
                  ex(R, 16, k + 2, k + 9))
    _stage_table("B=16", cfg, state, ex(L, 16, k + 2, k + 12),
                 ex(R, 16, k + 2, k + 12))
    top = B_ROWS[-1]
    _profile_step(f"B={top} (batched step)", step, ends[top],
                  ex(L, top, k, k + 7), ex(R, top, k, k + 7))
    del ends

    # 8 different sequences: the scene started at 8 offsets
    stacked = stereo_vo.make_batched_sequence_runner(cfg, K, BASELINE)
    seq = lambda a: torch.stack([a[i + 1:i + 1 + T] for i in range(8)], dim=1)
    _, s_end, _ = drive("B=8 different sequences", 8, stacked,
                        (L[:8], R[:8]), seq(L), seq(R),
                        lambda i: poses[i:i + T + 1])

    # a spawn in one stream beside seven that need none: the spawn runs
    # once for all (two window_gather launches), each stream picks its own
    # result, and the seven end where they end in a step without a spawn
    nxt = lambda a: torch.stack([a[i + 1 + T] for i in range(8)])
    wg.reset_launch_count()
    calm, _ = step(s_end, nxt(L), nxt(R))
    check(wg.launch_count() == 0 and bool(torch.equal(calm.next_uid,
                                                      s_end.next_uid)),
          "a stream spawned in the step that was to be the calm one")
    alive = s_end.alive.clone()
    alive[1, 100:] = False
    hit, m = step(s_end._replace(alive=alive), nxt(L), nxt(R))
    torch.cuda.synchronize()
    others = [i for i in range(8) if i != 1]
    dt = float((hit.t[others] - calm.t[others]).abs().max())
    same = bool(torch.equal(hit.alive[others], calm.alive[others])
                and torch.equal(hit.next_uid[others], calm.next_uid[others])
                and torch.equal(hit.xs[others], calm.xs[others]))
    print(f"batched: spawn in stream 1 of 8: window_gather launches="
          f"{wg.launch_count()} alive {int(alive[1].sum())} -> "
          f"{int(hit.alive[1].sum())} next_uid {int(s_end.next_uid[1])} -> "
          f"{int(hit.next_uid[1])}; the other streams: tracks and ids "
          f"equal={same} max |dt|={dt:.3e} against the step without a spawn")
    check(wg.launch_count() == 2, f"a spawn launched window_gather "
                                  f"{wg.launch_count()} times")
    check(int(hit.next_uid[1]) > int(s_end.next_uid[1])
          and int(hit.alive[1].sum()) > 200, "stream 1 did not refill")
    check(same and dt <= 1e-6, "a spawn in stream 1 changed another stream")
    return launches


def phase_720p(dev) -> None:
    """1280x720 single stream, 12 frames (K fx=720, same motion, seed 3)."""
    from boofcv_tpu_torch.sfm import stereo_vo
    h, w, T = H_720P, W_720P, T_BATCHED
    k = np.array([[FX_720P, 0.0, w / 2], [0.0, FX_720P, h / 2],
                  [0.0, 0.0, 1.0]])
    t0 = time.perf_counter()
    poses, frames = _scene(T + 1, k, h, w, seed=3)
    render_s = time.perf_counter() - t0
    cfg = stereo_vo.StereoVoConfig()
    state = stereo_vo.make_bootstrap(cfg, k, BASELINE)(
        stereo_vo.init_state(cfg, h, w, device=dev),
        torch.from_numpy(frames[0][0]).to(dev),
        torch.from_numpy(frames[0][1]).to(dev))
    run = stereo_vo.make_sequence_runner(cfg, k, BASELINE)
    lefts = torch.stack([torch.from_numpy(l) for l, _ in frames[1:]]).to(dev)
    rights = torch.stack([torch.from_numpy(r) for _, r in frames[1:]]).to(dev)
    _, ((Rs, ts), ms) = run(state, lefts, rights)          # warm-up
    torch.cuda.synchronize()
    fps = []
    for _ in range(3):
        t1 = time.perf_counter()
        run(state, lefts, rights)
        torch.cuda.synchronize()
        fps.append(T / (time.perf_counter() - t1))
    n_ok = int(ms["pose_ok"].sum())
    ate, total, rot = _accuracy(Rs.cpu().numpy(), ts.cpu().numpy(), poses)
    print(f"720p: {w}x{h} single stream pose_ok={n_ok}/{T} ate={ate:.6f} of "
          f"motion {total:.6f} final_rot_err_deg={rot:.6f} fps_runs="
          f"{[round(f, 3) for f in fps]} median_fps={np.median(fps):.3f} "
          f"(rendered {T + 1} frames on the host in {render_s:.2f}s)")
    check(n_ok == T, f"720p: pose_ok on {n_ok} of {T} frames")
    check(ate < 0.15 * total, f"720p: ATE {ate} >= 0.15 x motion {total}")
    check(rot < 2.0, f"720p: final rotation error {rot} deg >= 2")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    try:
        phase_environment()
        phase_build()
        t0 = time.perf_counter()
        poses, frames = _scene(N_FRAMES, K, H, W, seed=0)
        print(f"scene: rendered {N_FRAMES} frames {W}x{H} on the host in "
              f"{time.perf_counter() - t0:.2f}s")
        measured = {"window_gather": phase_kernel(dev),
                    "klt_track": phase_klt_kernel(dev, frames)}
        single = phase_slice(dev, poses, frames)
        batched = phase_batched_kernels(dev, frames)
        launches = {"single stream": single["launches"],
                    **phase_batched(dev, poses, frames, single)}
        phase_720p(dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    measured["klt_track"]["max_abs_err"] = max(
        measured["klt_track"]["max_abs_err"],
        batched["klt_track"].pop("max_abs_err"))
    for name in KERNELS:
        for path, counts in launches.items():
            if counts[name] < 1:
                print(f"chip_smoke: FAILED: {name} was not launched on the "
                      f"path {path!r}", file=sys.stderr)
                return 1
    # top-level times and bound: the single-stream shapes, as in every
    # earlier record; "batched": the B = 8 and B = 16 shapes
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
         "launches": sum(c[name] for c in launches.values()),
         "launches_by_path": {p: c[name] for p, c in launches.items()},
         **measured[name], "batched": batched[name]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
