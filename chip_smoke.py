#!/usr/bin/env python3
"""Drive the PyTorch port's stereo-VO main path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line(s); any failure exits non-zero:

1. environment: card name and power limit, torch / CUDA versions, nvcc,
   TF32 switches; fails without a CUDA device;
2. build: the window-gather kernel from ``boofcv_tpu_torch/kernels/csrc``;
3. kernel vs plain version on the card at the main path's shapes
   (KLT 512 windows of 24x16 on every pyramid level of 640x480, sparse-SAD
   strips 7x102 and 7x7 with negative columns and rows past the image, odd
   image sizes): bit-equal, with both times from CUDA events;
4. the slice at full width: the 640x480 reference scene (41 frames) through
   ``StereoVisualOdometry`` with the default config (512 tracks, pyramid
   1/2/4/8, disparity 0-96, 256 RANSAC hypotheses), checked against the
   ground-truth poses, then the sequence runner timed after a warm-up;
5. host syncs by call site in two steady-state steps, and the kernels one
   steady-state step launches with the device time they take.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
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
KERNEL_SOURCE = "boofcv_tpu_torch/kernels/csrc/window_gather.cu"
KERNEL_REPLACES = "boofcv_tpu/kernels/window_gather.py:95"


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
    from boofcv_tpu_torch.kernels import _nvcc, window_gather
    t0 = time.perf_counter()
    window_gather._kernel_lib()
    rec = _nvcc.build_record("window_gather")
    print(f"build: window_gather built={rec['built']} "
          f"nvcc_s={rec['build_s']:.3f} load_s={time.perf_counter() - t0:.3f}"
          f" arch_flags={' '.join(rec['arch_flags'])} "
          f"flags={' '.join(_nvcc.NVCC_FLAGS)}")


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
    # times at the KLT shape on the full-resolution level
    _, h, w, oy, ox, wy, wx = cases[0]
    img = imgs[(h, w)]
    ms = cuda_ms(lambda: wg.gather_windows_cuda(img, oy, ox, wy, wx), 200)
    plain_ms = cuda_ms(lambda: wg.gather_windows_reference(img, oy, ox, wy,
                                                           wx), 200)
    print(f"kernel: klt_{h}x{w} n=512 24x16 kernel_ms={ms:.6f} "
          f"plain_ms={plain_ms:.6f}")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def _scene():
    """The reference benchmark scene: forward creep with slow yaw over a
    textured plane at z=8 (bench.py's sequence), rendered on the host."""
    from boofcv_tpu_torch.io import simulate
    poses = []
    for i in range(N_FRAMES):
        a = 0.002 * i
        R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                      [-np.sin(a), 0.0, np.cos(a)]])
        c = np.array([0.01 * i, 0.0, 0.05 * i])
        poses.append((R, -R @ c))
    frames = simulate.render_stereo_sequence(
        np.random.default_rng(0), K, BASELINE, poses, H, W,
        plane_origin=(0.0, 0.0, 8.0), texture_scale=55.0)
    return poses, frames


def _rot_err_deg(Rest_c2w, Rgt_w2c) -> float:
    dR = Rest_c2w.T @ Rgt_w2c.T
    return float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2,
                                              -1, 1))))


def phase_slice(dev) -> int:
    from boofcv_tpu_torch.kernels import window_gather as wg
    from boofcv_tpu_torch.sfm import stereo_vo
    t0 = time.perf_counter()
    poses, frames = _scene()
    print(f"slice: rendered {N_FRAMES} frames {W}x{H} on the host in "
          f"{time.perf_counter() - t0:.2f}s")
    cfg = stereo_vo.StereoVoConfig()
    vo = stereo_vo.StereoVisualOdometry(cfg, K, BASELINE, H, W, seed=0,
                                        device=dev)

    # the main path, counted: bootstrap + 40 steps through process()
    wg.reset_launch_count()
    oks, centres, rots, frame_s = [], [], [], []
    for left, right in frames:
        t1 = time.perf_counter()
        oks.append(vo.process(left, right))
        frame_s.append(time.perf_counter() - t1)
        R, c = vo.camera_to_world()
        centres.append(c)
        rots.append(R)
        if len(oks) == 1:
            boot_state = vo.state
    torch.cuda.synchronize()
    launches = wg.launch_count()
    gt = np.stack([-R.T @ t for R, t in poses])
    ate = float(np.mean(np.linalg.norm(np.stack(centres) - gt, axis=1)))
    total = float(np.linalg.norm(gt[-1]))
    rot = _rot_err_deg(rots[-1], poses[-1][0])
    n_ok = sum(oks[1:])
    print(f"slice: pose_ok={n_ok}/{N_FRAMES - 1} ate={ate:.6f} "
          f"total_motion={total:.6f} ate_frac={ate / total:.6f} "
          f"final_rot_err_deg={rot:.6f} inliers_last={vo.metrics['inliers']}"
          f" alive_last={vo.metrics['alive']}")
    print(f"slice: window_gather launches in bootstrap+{N_FRAMES - 1} steps "
          f"= {launches}")
    print(f"slice: process() per-frame wall ms (step + pose readback): "
          f"median={1e3 * np.median(frame_s[1:]):.3f} "
          f"p90={1e3 * np.percentile(frame_s[1:], 90):.3f} "
          f"bootstrap={1e3 * frame_s[0]:.3f}")
    check(launches >= 4 * (N_FRAMES - 1),
          f"window_gather launched {launches} < {4 * (N_FRAMES - 1)} times")
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
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _ = step(state, lefts[k], rights[k])
            step(state, lefts[k + 1], rights[k + 1])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "called a synchronizing CUDA operation" in str(w.message))
    print(f"syncs: {sum(syncs.values())} host syncs in 2 steady-state "
          f"steps, by call site: {dict(sorted(syncs.items()))}")

    # device work of one steady-state step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(state, lefts[k + 1], rights[k + 1])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t1)
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    print(f"device: one steady-state step launches {len(kernels)} kernels, "
          f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"(profiled)")
    check(len(kernels) > 0, "the profiled step ran nothing on the device")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    try:
        phase_environment()
        phase_build()
        kern = phase_kernel(dev)
        launches = phase_slice(dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{
        "name": "window_gather", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
