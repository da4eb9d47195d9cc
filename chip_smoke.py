#!/usr/bin/env python3
"""Drive the PyTorch port's main paths (stereo VO, bundle adjustment, the
breadth surface, the other VO families and 2-D motion, multi-view SfM,
fiducials, QR codes and calibration targets, the rest of ip/ and
feature/, the TLD tracker, bag of words, DeepBoof, io/, the commands, the
examples and the sharded paths of dist/) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line(s); any failure exits non-zero:

1. environment: card name and power limit, torch / CUDA versions, nvcc,
   TF32 switches; fails without a CUDA device;
2. build: the five kernels (``window_gather``, ``klt_track``,
   ``gn_pose``, ``schur_fill``, ``pnp_bank``) from
   ``boofcv_tpu_torch/kernels/csrc``,
   one ``nvcc`` each, and the native
   host library (``boofcv_tpu_torch/native/ccl.cpp`` and ``merge.cpp``,
   one ``g++``), started together; ptxas's registers, spills and stack
   frame of every kernel instantiation;
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
   (the kernel's own time on the device), each beside its bound, and for
   the two sparse-SAD shapes beside an empty launch of the same grid (a
   kernel in ``window_gather.cu`` that returns at once); ``klt_track``'s
   device time on the first 1, 2 and 4 levels of the main scene;
4. the slice at full width: the 640x480 reference scene (41 frames) through
   ``StereoVisualOdometry`` with the default config (512 tracks, pyramid
   1/2/4/8, disparity 0-96, 256 RANSAC hypotheses), checked against the
   ground-truth poses, with each kernel's launches counted (``gn_pose``
   and ``pnp_bank`` once a step), then the sequence runner timed after a
   warm-up; the
   warm-up's 40 refine inputs (what ``ransac_pnp`` hands
   ``gauss_newton_pose``) through ``gn_pose`` and its plain route
   (``geo/pnp._gn_pose_f32``) on the card, at the refine's step tolerance
   and at 0: R and t within 1e-5, NaN in the same places; the last timed
   as the path runs it and with every iteration, beside its bound;
   ``pnp_bank`` against the plain route (``geo/robust._plain_bank``) on
   RANSAC banks of the VO cells' shapes (200 samples, 600 tracks; one
   stream and 16): counts equal, R and t within 1e-5 and masks equal
   where the winner is the plain route's, a near-tie where it is not
   (``bank_verdict``), two launches bit-equal, times beside the bound
   and the plain route's launches;
5. host syncs by call site in two steady-state steps, the kernels one
   steady-state step launches with the device time they take, and the
   step's stages timed one by one;
6. both kernels with the stream axis, one launch for B streams, against
   their plain versions and against 2-D launches on each stream's data
   (bit-equal): ``window_gather`` at [8, 512] origins for 7x102 and 7x7,
   ``klt_track`` at [8, 512] tracks on 8 different frames and on one frame
   shared by the streams (stride 0), and at [64, 512] and [256, 512] on the
   shared frame (the batched runner's shapes; the gather's 7x102 strips
   too, beside ``F.grid_sample``); times and bounds at B = 8, 16, 64 and
   256;
7. the B-stream path at full width: batched bootstrap and
   ``make_batched_sequence_runner(shared_frames=True)`` over 12 frames for
   B = 4, 8, 16 (and 1, 32, 64, 128, 256, to see where the aggregate rate
   stops following B), and B = 8 on 8 different sequences (the scene started at
   8 offsets).  Every stream must keep every pose inside the accuracy bars,
   stream 0 must agree with the single-stream runner (same seed, same
   frames) within 1e-4 on ``t``, ``klt_track`` and ``gn_pose`` must
   launch once per step and ``window_gather`` twice per spawn or bootstrap
   whatever B is (the B = 16 run's refine inputs held to phase 4's
   ``gn_pose`` limits and timed), and a
   steady-state batched step must make one host sync.  Aggregate frames/s
   (median of 3 runs), the profiled step at B = 1 and B = 16, the stage
   table and peak device memory at B = 16;
8. a 1280x720 single-stream run (12 frames, K fx=720, seed 3);
9. ``ba:`` the LM-Schur solver on the reference benchmark's window scene
   (100 keyframes, 2000 points, 10 observations a point, seed 7), 10
   iterations, float32 with mixed precision and float64: reprojection RMS
   at most 7.5e-4, costs that never rise, two solves bit-equal, no host
   sync inside ``optimize``, the float64 cost within 5 % of a numpy/scipy
   solver's run on the host, ``schur_fill`` launched once a group an
   iteration; ms per solve, kernels, device busy time, peak memory;
10. ``ba_stages:`` one iteration part by part, the library calls' host and
    device ms, the iteration's bound, and the Schur fill-in five ways: the
    ``schur_fill`` kernel (the solver's), the plain version's products and
    sorted segmented sum, ``index_add_``, ``index_put_`` with accumulate,
    the dense one-hot product; the kernel's device ms, bound and gap from
    the plain version are its record in the kernels' JSON line;
11. ``ba_vo:`` the VO over the first 16 frames with
    ``SlidingWindowBA(window=8)`` behind it: every state pushed, the window
    solved from the third frame on; the hand kernels' launches counted
    (``schur_fill`` too);
12. ``ba_scale:`` 1000 views, 100,000 points, 3 iterations: ms per
    iteration, the Cholesky's share, ``schur_fill``'s launches, peak
    memory;
13. the dense-image breadth path at the reference breadth benchmark's size,
    each phase with ms per call, kernels, device busy ms, idle share, host
    syncs (none allowed), peak memory, its bound and a numpy baseline timed
    on the host: ``breadth_bm:`` SAD block matching on a 640x480 pair, 96
    disparities, radius 3 (median error against the true plane at most 0.5
    px, valid share at least 0.6, within 0.1 px of the numpy BM);
    ``breadth_sgm:`` 4-path census SGM on the same pair (the same two bars;
    two aggregations bit-equal); ``breadth_surf:`` integral image, Fast
    Hessian (500 features an octave, 2 octaves), Haar orientation, SURF-64
    (at least 300 features of unit norm; at least 80 % found again in the
    image moved by (4, 6) px); ``breadth_assoc:`` mutual nearest neighbour
    over 10,000 x 10,000 x 64 descriptors, full matrix and tiled (the
    numpy count within 5; tiled equal to full); ``breadth_flow:``
    Horn-Schunck, 200 iterations (endpoint error within 0.05 px of a numpy
    solver's); ``breadth_canny:`` Canny, low 2, high 8, on a smoothed
    640x480 texture (the hysteresis trips and syncs, the host chain
    finisher, the mask against a numpy Canny on 99.9 % of the pixels);
    ``breadth_sift:`` SIFT detect + describe, 200 an octave, 4 octaves (unit
    descriptors after the 0.2 clip; at least 60 % of the keypoints found
    again within 1.5 px after a (4, 6) px move); ``breadth_flow2:`` Brox
    warping, dense KLT and block flow on the flow scene (endpoint error
    bars from the CPU results at 120x160); ``breadth_zhang99:``
    ``calibrate_mono_planar`` on 12 views of an 8x6 grid, 20 iterations (fx,
    fy, cx, cy within 0.1 % of a numpy Zhang99); ``geo_robust:`` RANSAC for
    F, E (Nister) and H over 1,000 correspondences, 30 % outliers, 512
    hypotheses (at least 95 % of the true inliers kept, at most 1 % of the
    outliers); ``breadth_cpu_vs_card:`` each module family on the card
    against the same call on the CPU at the test size.  These phases
    launch neither ``window_gather`` nor ``klt_track`` (the reference's
    modules reach no TPU kernel); the PnP solvers' refine is ``gn_pose``;
14. ``sparse_ssd:`` the sparse matcher scoring SSD at the main path's shape
    (512 points, 96 disparities): ``window_gather`` launches twice, its
    costs equal the CPU's (the plain gather) to 1e-5;
15. the other odometry families and 2-D motion at 640x480, each driven
    through its user entry point over 17 frames (the first, 2 warm-up, 12
    timed, one with sync warnings on, one profiled): ``vo_depth:``,
    ``vo_dual:``, ``vo_quad:`` and ``vo_direct:`` on the reference scene
    with the reference configs' defaults (512 tracks / 4 levels / D = 96;
    256 SURF features; scales 1/2/4 with 10 iterations a level; the RGB-D
    families read the plane's exact depth), held to the stereo bars (quad:
    ATE below 0.25 x motion); ``vo_mono_plane:`` (plane 4 m ahead),
    ``vo_overhead:`` (overhead 320x320, camera 1.5 m up, pitched 0.6 rad)
    and ``stitch2d:`` (12 px a frame) with 300 tracks, each held to its
    JAX test's bars (mono-plane: 0.11 x motion, above the JAX reference's
    own drift on this scene); ``point_tracker:`` the KLT, combined,
    two-pass and DDA trackers on a texture moving (1, 2) px a frame (median
    motion error at most 0.1 px, DDA 0.5 px).  Each prints frames/s,
    kernels a frame, busy ms, idle share, syncs a frame, peak memory and
    its bar; every KLT path must launch ``klt_track``, the dual-track
    spawn ``window_gather`` and the depth, dual and quad VO ``gn_pose``;
    each KLT path's ``track_pyramid`` calls of one frame go through the
    kernel and the plain version on the card, held to phase 3's limits at
    the path's own levels, tracks, image, radius and iteration cap, and
    each PnP path's refine calls of that frame to phase 4's ``gn_pose``
    limits;
16. multi-view geometry and SfM (none of it reaches a hand kernel but
    ``sfm_incremental:``'s PnP refine, ``gn_pose``), each
    phase with ms per call (CUDA events around the whole call after a
    warm-up), kernels, device busy ms and idle share of one profiled call,
    host syncs by call site, peak memory and its bar: ``pose_graph:``
    (1,000 poses, 999 odometry edges and 100 loop closures, 20 float64
    iterations: final cost below 1e-3 of the first, costs never rise, two
    solves bit-equal); ``spherical:`` (two 640x480 views onto a 1024x2048
    canvas and the first back: within 1 grey level on 95 % of the covered
    pixels); ``cloud:`` (radius filter and 8-NN on 16,384 points against a
    float64 numpy brute force on 99.9 % of the queries; the voxel
    downsample on the host); ``three_view:`` (1,000 triples, 20 %
    outliers: focal within 10 %, 95 % of the inliers kept);
    ``sfm_uncalibrated:`` (the orbit scene, 20 views x 1,000 points, 190
    pairs in chunks of 64: every view, focal within 5 %, camera centres
    within 0.01 of the span after a similarity alignment);
    ``sfm_incremental:`` (10 views x 1,500 points, 0.3 px noise: every view,
    centres within 0.01 of the span, more than 60 % of the points).  The
    ``kernel:`` lines also hold ``F.grid_sample`` (nearest, border,
    align_corners) against the plain gather at each of its shapes and time
    it as the library call;
17. recognition (none of it reaches a hand kernel but the fiducials'
    pose refine, ``gn_pose``), each call measured as in 16: ``binary:`` a 1280x720 frame of shapes and a chessboard (Otsu,
    threshold, point noise, ``label_blobs`` on the card: equal to the
    native CCL in both numberings, its sweeps and syncs; native
    ``contours_with_holes`` equal to the Python tracer); ``fiducial:`` a
    1280x720 frame of 8 binary and 2 image markers at all four quarter
    turns under perspective, noise sigma 4 (every marker found, corner error
    median below 1 px and max below ``FID_MAX_CORNER_PX``, ``estimate_pose``
    reprojection RMS below 1 px, card = CPU); ``qr:`` codes of versions 2,
    10 and 25 (level M, 4 px modules) under a homography in 1280x720
    frames, noise sigma 6 (each decoded exactly, card = CPU);
    ``calib_targets:`` 12 640x480 views each of a 9x7 chessboard (auto with
    an occluded view, and known size), a square grid, a circle grid and a
    hexagonal circle grid, then Zhang99 from each (``CAL_BARS``);
18. the rest of ip/ and feature/ (none of it reaches a hand kernel but
    SFOT, which tracks through ``klt_track``), each call measured as in 16
    and held against the same call on the CPU: ``ip_rest:`` colour round
    trips at 1280x720, ``filter_frequency`` against numpy's FFT, the three
    wavelet denoisers (the JAX test's MSE bar), ``equalize_histogram``
    (no host sync) and ``equalize_local``, ``mls.deform`` with 20 control
    points, a planar blur and Sobel bit-equal to calls a band;
    ``background:`` the basic, Gaussian and GMM models of a static camera
    and of a panning one (a known homography a frame) over 30 640x480
    frames with a crossing square (the JAX tests' detection and
    false-positive bars); ``segmentation:`` ``slic`` with 400 segments
    (boundary recall), ``segment_mean_shift`` (the native merge's host
    time), ``watershed`` from 64 markers (trips, flag reads, syncs),
    ``segment_fh04`` (native merge = ``_fh04_merge_numpy``; regions against
    the truth); ``lines:`` ``hough_binary`` and ``hough_gradient`` find
    every planted line, grid-RANSAC segments connected along a pentagon's
    edges; ``template:`` SSD, SAD and NCC of a 32x32 template find it
    exactly, ``conv2d`` timed beside shifted adds; ``dense:`` HOG and dense
    SIFT; ``trackers:`` circulant, mean-shift, SFOT and Comaniciu over 30
    frames of a moving target (the JAX tests' distances);
19. recognition's TLD, bag of words and DeepBoof, ``io/`` and the
    functions the port's modules lacked, each call measured as in 16 and
    held against the same call on the CPU: ``tld:`` the TLD tracker on two
    640x480 scenes (the trackers' moving 64 px target over 30 frames; the
    reference test's object followed, gone, and back 1.7x larger), two
    ``klt_track`` launches a frame on the path ``tld``, each held against
    the plain version and timed at TLD's shape (25 tracks, 2 levels, 15
    iterations), bars from the JAX TLD's run on the same frames;
    ``scene:`` a bag-of-words classifier of 60 textures at 256x256 (dense
    SIFT, 64 words, kNN 5) on 30 held-out ones, at least 80 % right, labels
    = the CPU's; ``deepboof:`` VGG-CIFAR10 (256 images) and NIN-ImageNet
    (32 of 224x224) forward passes, logits within 1e-3 of the CPU's, and
    150 SGD steps to 100 % training accuracy; ``io:`` PNG, PNM, YAML and
    PLY round trips on the host; ``ip_more:`` the derivative stencils,
    ``convolve_down``, ``sparse_sample``, ``bicubic``, the Gaussian pyramid
    and scale space, FAST, Harris, Kitchen-Rosenfeld, the Hessian and
    median intensities and four PnP solvers (512 points);
20. ``cli_vo:`` the main path through the user's command: the 41 frames of
    phase 4 written as PNG pairs, then ``cli.stereo_vo_demo.main`` in this
    process; the trajectory equal within 1e-6 to a ``StereoVisualOdometry``
    run on the same decoded frames and within the VO bars, with and
    without ``--calib``; frames/s end to end (PNG decode included), the
    step's share, host syncs by call site, a profiled frame's kernels and
    idle share, the hand kernels' launches (``gn_pose`` once a step);
21. ``examples:`` every example of the port (64) once on the card
    in-process: each returns 0 with ``OK`` last; its ms and launches;
22. ``cli:`` the eight other commands on the data ``tests/test_cli.py``
    builds, each held to that test's bar;
23. ``dist:`` the sharded paths of ``dist/`` through ``dist.make_mesh`` on
    a one-rank NCCL group (the host has one card): ``optimize_sharded`` at
    ``ba_scale:``'s V = 1000, P = 100,000, f32 mixed, 3 iterations, in
    both solver modes against ``ba.optimize`` on the same problem
    ("cholesky": costs within 1e-6 relative, two solves bit-equal; "pcg",
    120 CG iterations: final cost within 5e-3 of ``ba.optimize``'s in the
    reference test's form and below half its first; costs never rise; no
    host sync), with ms per iteration, kernels, busy ms, idle share, the
    NCCL kernels' device ms, bytes to the collectives and peak memory
    beside ``ba.optimize``'s; ``ransac_pnp_sharded`` (512 points, 20 %
    outliers, 256 hypotheses: R and t within 1e-5 of the truth);
    ``match_pairs_sharded`` on ``sfm_uncalibrated:``'s scene (190 pairs:
    inliers above 0.7 of each pair's common points, relative rotations
    within 1e-2); ``reconstruct_uncalibrated(mesh=)`` (the pairwise graph
    equal to the unsharded call's, ``sfm_uncalibrated:``'s bars); neither
    ``window_gather`` nor ``klt_track`` launched, ``gn_pose`` by the
    sharded RANSAC's refine (its inputs held to phase 4's limits); then a
    CPU leg, printed as such: the BA at test
    size on four gloo processes on the host's CPU, 1-D and 2-D meshes and
    PCG, against the one-process ``ba.optimize``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.

    python3 chip_smoke.py --sweep [--baseline [TAG=]DIR ...] [--out DIR]
                                  [--kernel NAME ...]

times the hand kernels alone, shape by shape, and nothing else:
device ms of one launch (the profiler's median kernel time, ``device_ms``),
ms a call over 200 back-to-back calls through the wrapper (CUDA events:
the host's launch rate) and the bound (``bound``), for ``gn_pose`` at [600]
and [16, 600] pose problems, 50 iterations, beside the plain route's times
(``_sweep_gn_pose``; this tree only), for ``window_gather`` at
[512] windows of 7x102, 7x7 and 24x16, [16, 512] 7x102 on 16 frames,
[64, 512] and [256, 512] on one shared frame (each bit-equal to the plain
version; an empty launch of each grid beside it), ``schur_fill`` on each
group of the first LM iteration at BAL Venice's counts (the benchmark's
``venice.lm10`` problem; ``_sweep_schur_fill``, this tree only) beside
the plain version run on the card, ``pnp_bank`` at [200 x 4, 600] and
[16, 200 x 4, 600] beside the plain route's device ms and launches
(``_sweep_pnp_bank``, this tree only), and ``klt_track`` at
[512] tracks on 4 levels of 640x480 (also on 1 and 2 levels, and with the
iteration cap at 1, 2 and 4), [4, 512], [8, 512] and [16, 512] on as many
frames, [64, 512] and [256, 512] on one shared frame.  ``klt_track`` runs
on this tree as it ships and built with each of its two Gauss-Newton loops
at every track count (``single_loop``, ``split_loop``: where they cross is
the kernel's ``KLT_SPLIT_ABOVE``).  ``--baseline DIR`` (repeatable) is
another checkout of the repository (for example the parent commit,
unpacked with ``git archive``): its kernel package is imported beside this
tree's and builds its own kernels, so each shape is timed through each
tree's own wrapper, in turns (baseline, this tree, this tree, baseline) in
one process on one card, with each tree's faults, positions and windows
compared bit for bit with this tree's.  Each library's ``cuobjdump -sass``
and ptxas report go under ``--out`` (default
``boofcv_tpu_torch/kernels/_build/sweep``, git-ignored).  ``--kernel
NAME`` (repeatable) times only the kernels named.
"""

from __future__ import annotations

import argparse
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
DMAX = 96                 # disparities of the dense BM and SGM phases
N_ASSOC = 10_000          # descriptors a side of the association phase
HS_ITERATIONS = 200       # Horn-Schunck iterations of the flow phase
HS_INSET = 40             # px cut off each border before its error is read
KERNELS = {
    "window_gather": {
        "source": "boofcv_tpu_torch/kernels/csrc/window_gather.cu",
        "replaces": "boofcv_tpu/kernels/window_gather.py:95"},
    "klt_track": {
        "source": "boofcv_tpu_torch/kernels/csrc/klt_track.cu",
        "replaces": "boofcv_tpu/kernels/window_gather.py:95 + "
                    "boofcv_tpu/feature/klt.py:107"},
    "gn_pose": {
        "source": "boofcv_tpu_torch/kernels/csrc/gn_pose.cu",
        "replaces": "no TPU kernel: XLA fuses the lax.while_loop of "
                    "boofcv_tpu/geo/pnp.py:575"},
    "schur_fill": {
        "source": "boofcv_tpu_torch/kernels/csrc/schur_fill.cu",
        "replaces": "no TPU kernel: XLA fuses the one-hot einsum of "
                    "boofcv_tpu/geo/ba.py:_local_system"},
    "pnp_bank": {
        "source": "boofcv_tpu_torch/kernels/csrc/pnp_bank.cu",
        "replaces": "no TPU kernel: XLA fuses the batched P3P, K x N "
                    "scoring and argmax of boofcv_tpu/geo/robust.py:ransac"},
}
# published peaks of one H100 SXM: device memory rate, f32 outside the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# what leads every profiler trace: a wait after its first launches, then
# this many launches of an empty kernel (see _trace)
PROFILER_LEAD_S = 0.02
PROFILER_PADS = 64


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


def _trace(run, attempts: int = 5, cpu: bool = True):
    """(the CUDA events of ``run()`` under the profiler, the profiler).

    On this kind of host the profiler loses the first device events of a
    trace: none in a young process, later on now none, now the first few
    hundred, whatever the trace holds (the host-side launch records are all
    there; waiting before the first launch or after the last changes
    nothing, so what counts is the time since the trace's first launch).  A
    trace of one or two kernels then comes back empty.  So every trace is
    led by launches of a kernel that returns at once
    (``torch.cuda._sleep(1)``, kernel ``spin_kernel``, as
    ``perfbench/harness/trace.py`` pads): a few, then ``PROFILER_LEAD_S`` of
    waiting, then ``PROFILER_PADS`` more, then ``run()``.  What is lost is
    padding as a rule: while one pad is seen, everything after the pads was
    seen.  A trace that shows no pad, or the pads and nothing after them
    (seen once in a whole run), is taken again with four times the wait and
    the pads.  The pads are left out of the events returned.  ``cpu=False``
    traces the device alone (no operator events: a call of 10^5 launches
    costs half the time to trace)."""
    def launch_pads(count):
        for _ in range(count):
            torch.cuda._sleep(1)

    lead, pads = PROFILER_LEAD_S, PROFILER_PADS
    for attempt in range(attempts):
        torch.cuda.synchronize()
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                                if cpu else [])
        with profile(activities=activities) as prof:
            launch_pads(8)
            torch.cuda.synchronize()
            time.sleep(lead)
            launch_pads(pads)
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type.name == "CUDA"]
        kept = [e for e in events if "spin_kernel" not in e.name]
        if kept and len(kept) < len(events):
            return kept, prof
        # pads seen and nothing after them: the profiler dropped the call's
        # events (seen on this kind of host); a call that runs nothing on
        # the device shows none in any attempt and fails below
        seen = "some" if kept != events else "none"
        print(f"profiler: {seen} of 8 + {pads} leading pads seen ({lead} s "
              f"between them), {len(kept)} other device events (attempt "
              f"{attempt + 1} of {attempts})")
        lead, pads = 4 * lead, 4 * pads
    raise SmokeFailure(f"the profiler lost the head of {attempts} traces, "
                       f"or the profiled call ran nothing on the device")


def device_ms(fn, reps: int, kernel: str | None = None) -> float:
    """Device time of one ``fn()`` from the profiler: the median time of
    the kernel whose name contains ``kernel`` (which must run once per
    call), or with no name the summed time of every kernel, per call."""
    fn()

    def run():
        for _ in range(reps):
            fn()
    # the median of half of the launches is still the kernel's; a trace with
    # fewer is taken again
    for attempt in range(3):
        events, _ = _trace(run)
        if kernel is None:
            return sum(e.device_time for e in events) / reps / 1e3
        times = [e.device_time for e in events if kernel in e.name]
        if reps // 2 <= len(times) <= reps:
            return float(np.median(times)) / 1e3
        print(f"profiler: saw {kernel} {len(times)} times in {reps} calls "
              f"(attempt {attempt + 1} of 3)")
    raise SmokeFailure(f"the profiler saw {kernel} {len(times)} times in "
                       f"{reps} calls, three times over")


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


def _timed_native_build() -> float:
    """Seconds to build (if needed) and load the native host library."""
    from boofcv_tpu_torch import native
    t0 = time.perf_counter()
    native.library()
    return time.perf_counter() - t0


def _short_kernel_name(mangled: str) -> str:
    """A kernel's name from ptxas's mangled one: the name and its integer,
    bool and index-type template arguments
    (``klt_track_kernel<24,16,20,2,true>``)."""
    import re
    m = re.search(r"(\d+)([a-z_]+_kernel)(I.*?E)?(?:v|E|P|S|N|\d|$)",
                  mangled)
    if not m:
        return mangled
    tmpl = m.group(3) or ""
    args = [v if t == "i" else ("true" if v == "1" else "false")
            for t, v in re.findall(r"L([ib])(\d+)E", tmpl)]
    args += {"iE": ["int"], "xE": ["long long"]}.get(tmpl[-2:], [])
    return m.group(2) + (f"<{','.join(args)}>" if args else "")


def ptxas_summary(text: str) -> list:
    """(kernel, registers, spill stores, spill loads, stack frame bytes) of
    each entry function in ``nvcc -Xptxas -v``'s report."""
    import re
    out, fn, frame = [], None, (0, 0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = _short_kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            out.append((fn, int(m.group(1)), frame[1], frame[2], frame[0]))
            fn = None
    return out


def phase_build():
    """The four kernels, one nvcc each, and the native host library
    (g++), started together."""
    from boofcv_tpu_torch import native
    from boofcv_tpu_torch.kernels import _nvcc
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        futures = [pool.submit(_timed_native_build)] + [
            pool.submit(mod._KERNEL.library)
            for mod in _kernel_modules().values()]
        for f in futures:
            f.result()
    wall = time.perf_counter() - t0
    print(f"build: native host library (g++ {' '.join(native.FLAGS)}) "
          f"built and loaded in {futures[0].result():.3f}s")
    for name in KERNELS:
        rec = _nvcc.build_record(name)
        print(f"build: {name} built={rec['built']} "
              f"nvcc_s={rec['build_s']:.3f} flags={' '.join(rec['flags'])}")
        if not rec["ptxas"]:
            print(f"build: {name} ptxas: not measured (no report beside "
                  f"the library)")
        for fn, regs, stores, loads, stack in ptxas_summary(rec["ptxas"]):
            print(f"build: {name} ptxas: {fn} registers={regs} "
                  f"spill_stores={stores} spill_loads={loads} "
                  f"stack_frame={stack}")
    print(f"build: the kernels and the native library built and loaded in "
          f"{wall:.3f}s")


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
    lib = grid_sample_call(img, oy, ox, wy, wx)
    _check_grid_sample(f"{name} origins=[512]", lib, plain())
    lib_ms = cuda_ms(lib, 200)
    lib_dev_ms = device_ms(lib, 50)
    print(f"kernel: window_gather {name} n=512 24x16 kernel_ms={ms:.6f} "
          f"plain_ms={plain_ms:.6f} (CUDA events, 200 back-to-back calls) "
          f"device_ms={dev_ms:.6f} plain_device_ms={plain_dev_ms:.6f} "
          f"(profiler) library_ms={lib_ms:.6f} library_device_ms="
          f"{lib_dev_ms:.6f} (F.grid_sample nearest, border, align_corners, "
          f"on a prebuilt grid)")
    # the two shapes the single-stream main path launches today (the sparse
    # SAD of a spawn or bootstrap)
    sad = {}
    for sname, h, w, oy, ox, wy, wx in (cases[4], cases[5]):
        oy, ox = oy.contiguous(), ox.contiguous()
        lib = grid_sample_call(imgs[(h, w)], oy, ox, wy, wx)
        _check_grid_sample(f"{sname} origins=[512]", lib,
                           wg.gather_windows_reference(imgs[(h, w)], oy, ox,
                                                       wy, wx))
        t = _times(lambda: wg.gather_windows_cuda(imgs[(h, w)], oy, ox, wy,
                                                  wx),
                   lambda: wg.gather_windows_reference(imgs[(h, w)], oy, ox,
                                                       wy, wx),
                   "window_gather_kernel", 200, library=lib)
        sad[sname] = _print_times(
            f"window_gather {sname} origins=[512] window={wy}x{wx}",
            bounds[sname], t)
        # what a launch of this grid costs the device before it reads a
        # pixel: the same grid and block, a kernel that returns at once
        n = oy.shape[0]
        empty = device_ms(lambda: wg.launch_empty(n, wy, wx, dev), 50,
                          "window_gather_empty_kernel")
        sad[sname]["empty_launch_device_ms"] = empty
        print(f"kernel: window_gather {sname} an empty launch of the same "
              f"grid ({n} windows'): device_ms={empty:.6f} (profiler); the "
              f"gather's {sad[sname]['device_ms']:.6f} is "
              f"{sad[sname]['device_ms'] / empty:.2f}x that")
    # top level: the larger of the two shapes the main path launches; the
    # 24x16 KLT window has not been on it since klt_track took KLT over
    return {"max_abs_err": max_err, **sad["sad_strip_7x102"],
            "single_stream_sad_patch_7x7": sad["sad_patch_7x7"],
            "klt_window_24x16_off_the_main_path": {
                "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
                "plain_device_ms": plain_dev_ms,
                "bound_ms": bounds[name]["bound_ms"],
                "bound_by": bounds[name]["bound_by"], "library_ms": lib_ms,
                "library_device_ms": lib_dev_ms}}


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
              f"(profiler) library_ms=None (no single PyTorch call tracks a "
              f"pyramid: each track's Gauss-Newton steps hang on its own "
              f"last step, level after level)")
        out.update({"ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
                    "plain_device_ms": plain_dev_ms,
                    "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
                    "library_ms": None})
        # the level sweep: the same tracks on the first 1, 2 and 4 levels
        # (a level adds a window fetch and up to max_iterations evaluations
        # to every track's chain)
        by_levels = {}
        for k in (1, 2, 4):
            sub = (args[0][:k], args[1][:k], args[2][:k], args[3][:k], ys,
                   xs, scales[:k]) + args[7:]
            ev = int(kt.klt_track_cuda(*sub)[3].sum())
            t_k = device_ms(lambda: kt.klt_track_cuda(*sub), 50,
                            "klt_track_kernel")
            by_levels[k] = {"device_ms": t_k, "evaluations": ev}
            print(f"kernel: klt_track {name} levels={k} device_ms={t_k:.6f} "
                  f"(profiler) evaluations={ev} ({ev / n / k:.3f} a track "
                  f"and level)")
        out["device_ms_by_levels"] = by_levels
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


def _kernel_modules() -> dict:
    """The hand kernels' wrapper modules by kernel name."""
    from boofcv_tpu_torch.kernels import (gn_pose, klt_track, pnp_bank,
                                          schur_fill, window_gather)
    return {"window_gather": window_gather, "klt_track": klt_track,
            "gn_pose": gn_pose, "schur_fill": schur_fill,
            "pnp_bank": pnp_bank}


def _reset_launches() -> None:
    """Zero every hand kernel's launch counter."""
    for mod in _kernel_modules().values():
        mod.reset_launch_count()


# the hand kernels a stereo VO step runs (its spawns the gather)
STEREO_VO_KERNELS = ("window_gather", "klt_track", "gn_pose", "pnp_bank")


def _launches(names=tuple(KERNELS)) -> dict:
    """The launches since :func:`_reset_launches` of the hand kernels
    ``names`` (default: every one), by kernel name.  A path's record
    names the kernels it runs: each must have launched on it."""
    mods = _kernel_modules()
    return {name: mods[name].launch_count() for name in names}


def _capture_refine(fn) -> list:
    """Run ``fn()`` with ``pnp.gauss_newton_pose`` wrapped to keep the
    arguments of each call (as ``robust.ransac_pnp`` passes them): [(R, t,
    world, obs, weights, iterations, damping, polish_iterations), ...]."""
    import inspect
    from boofcv_tpu_torch.geo import pnp
    calls, inner = [], pnp.gauss_newton_pose
    sig = inspect.signature(inner)

    def recording(*a, **k):
        b = sig.bind(*a, **k)
        b.apply_defaults()
        calls.append(tuple(b.arguments.values()))
        return inner(*a, **k)
    pnp.gauss_newton_pose = recording
    try:
        fn()
    finally:
        pnp.gauss_newton_pose = inner
    return calls


def _gn_bound(args, iterations: int) -> dict:
    """Bound of one ``gn_pose`` launch that runs every iteration: every
    input once, R and t out in float64; about 152 float32 operations a
    point and iteration (projection, residual, the two Jacobian rows and
    the 27 weighted sums of J^T W J and J^T W r)."""
    world = args[2]
    b = world[..., 0, 0].numel()
    return bound(sum(x.numel() * x.element_size() for x in args) + 96 * b,
                 152 * world[..., 0].numel() * iterations)


def _gn_check(tag: str, calls) -> tuple:
    """``gn_pose`` against the plain route (``geo/pnp._gn_pose_f32``) on the
    inputs a path gave the refine (``calls``, from :func:`_capture_refine`),
    each with the path's iterations and damping, at the refine's step
    tolerance (1e-6) and at 0: R and t within 1e-5 (float32's resolution at
    the loop's scale: the kernel sums the points in another order), NaN
    where the plain route gives NaN.  Returns (largest gap, calls checked,
    (the last call's tensors, iterations, damping))."""
    from boofcv_tpu_torch.geo import pnp
    from boofcv_tpu_torch.kernels import gn_pose as gp
    worst, checked, last = 0.0, 0, None
    for j, (R, t, world, obs, wgt, iters, damping, polish) in \
            enumerate(calls):
        fast = iters - polish
        if fast <= 0:
            continue
        args = [x.contiguous() for x in (R, t, world, obs, wgt)]
        damping = max(damping, 1e-12)
        last = (args, fast, damping)
        for tol in (1e-6, 0.0):
            got = gp.gn_pose_cuda(*args, fast, damping, tol)
            want = pnp._gn_pose_f32(*args, fast, damping, tol)
            for g, w in zip(got, want):
                check(torch.equal(g.isnan(), w.isnan()),
                      f"gn_pose {tag} call {j} step_tol={tol}: NaN where "
                      f"the plain route has none, or none where it has")
                gap = float((g - w).nan_to_num().abs().max())
                check(gap <= 1e-5, f"gn_pose {tag} call {j} step_tol={tol}: "
                                   f"{gap:.3e} from the plain route")
                worst = max(worst, gap)
        checked += 1
    check(checked > 0, f"gn_pose {tag}: no refine call to check")
    return worst, checked, last


def phase_gn_kernel(dev, tag: str, calls) -> dict:
    """:func:`_gn_check` on the inputs the VO path's ``ransac_pnp`` gave the
    refine; then its last call timed as the path runs it and with every
    iteration run (step tolerance 0), beside its bound."""
    from boofcv_tpu_torch.geo import pnp
    from boofcv_tpu_torch.kernels import gn_pose as gp
    worst, checked, (args, fast, damping) = _gn_check(tag, calls)
    lead = tuple(args[2].shape[:-1])
    what = f"gn_pose {tag} [{', '.join(map(str, lead))}] iterations={fast}"
    print(f"kernel: {what}: {checked} refine calls of the path against the "
          f"plain route, step_tol 1e-6 and 0: max_abs_err={worst:.3e} "
          f"(limit 1e-5)")
    t = _times(lambda: gp.gn_pose_cuda(*args, fast, damping, 1e-6),
               lambda: pnp._gn_pose_f32(*args, fast, damping, 1e-6),
               "gn_pose_kernel", 5)
    out = _print_times(f"{what} step_tol=1e-6 (as the path runs it)",
                       _gn_bound(args, fast), t)
    # the bound counts every iteration; with the path's tolerance a problem
    # may leave the loop early, so the share is read with tolerance 0
    out.pop("bound_ms")
    out.pop("bound_by")
    full = _times(lambda: gp.gn_pose_cuda(*args, fast, damping, 0.0),
                  lambda: pnp._gn_pose_f32(*args, fast, damping, 0.0),
                  "gn_pose_kernel", 5)
    out["every_iteration"] = _print_times(f"{what} step_tol=0 (every "
                                          f"iteration)",
                                          _gn_bound(args, fast), full)
    out["every_iteration"]["share"] = (out["every_iteration"]["bound_ms"]
                                       / full["device_ms"])
    return {"max_abs_err": worst, "calls_checked": checked,
            "shape": list(lead), "iterations": fast, **out}


# the VO cells' RANSAC: K = 200 index sets against N = 600 tracks, 1.5 px
# at fx 480 in normalized coordinates
BANK_K, BANK_N, BANK_THR = 200, 600, (1.5 / 480.0) ** 2
# pnp_bank against its plain route: the kernel solves and scores in the
# plain route's precision but sums rows and the MSAC in another order, so
# the two agree to rounding.  Where that rounding moves a near-tie, the two
# may pick different winners: then their float64 orders (counts - msac /
# (worst + 1)) agree to BANK_ORDER_RTOL and their inlier masks on all but
# BANK_MASK_SHARE of the points.  Where they pick the same sample and
# solution, R and t agree to BANK_POSE_TOL (float32 resolution), the masks
# are equal and the MSAC agrees to BANK_MSAC_RTOL.
BANK_ORDER_RTOL, BANK_MASK_SHARE = 1e-6, 1e-3
BANK_POSE_TOL, BANK_MSAC_RTOL = 1e-5, 1e-5


def _bank_scene(dev, lead, n=BANK_N, k=BANK_K, seed=0) -> tuple:
    """[*lead] RANSAC banks as the VO step hands them to ``pnp_bank``:
    float64 world points 3-12 m ahead, their normalized projections
    through each stream's pose with 1e-3 noise, a fifth replaced by random
    observations, a fifth of the tracks masked, and K index sets drawn by
    ``robust.sample_indices`` from a generator a stream."""
    from boofcv_tpu_torch.geo import robust
    rng = np.random.default_rng(seed)
    b = int(np.prod(lead))
    world = np.concatenate([rng.uniform(-4, 4, (b, n, 2)),
                            rng.uniform(3, 12, (b, n, 1))], -1)
    obs = world[..., :2] / world[..., 2:] + rng.normal(0, 1e-3, (b, n, 2))
    bad = rng.uniform(size=(b, n, 1)) < 0.2
    obs = np.where(bad, rng.uniform(-0.6, 0.6, (b, n, 2)), obs)
    valid = rng.uniform(size=(b, n)) >= 0.2
    world, obs, valid = (torch.from_numpy(a.reshape(lead + a.shape[1:])
                                          ).to(dev)
                         for a in (world, obs, valid))
    gens = [torch.Generator(device=dev).manual_seed(seed + i)
            for i in range(b)]
    idx = robust.sample_indices(gens if lead else gens[0], k, 3, n, valid)
    return world, obs, valid, idx


def bank_table(world, obs, idx, valid, thr=BANK_THR) -> tuple:
    """The plain route's whole bank on the same tensors: every solution's
    (R, t) [..., K*4, ...], inlier mask, count, MSAC and float64 order, as
    ``robust.ransac`` forms them."""
    from boofcv_tpu_torch.geo import pnp, robust
    take = lambda a: robust._take(a, idx)
    R, t, ok = pnp.p3p_grunert(take(world), take(obs), dtype=torch.float32)
    lead = idx.shape[:-2]
    k4 = idx.shape[-2] * 4
    R, t, ok = (R.reshape(lead + (k4, 3, 3)), t.reshape(lead + (k4, 3)),
                ok.reshape(lead + (k4,)))
    err = pnp.reprojection_error_sq(R, t, world.float()[..., None, :, :],
                                    obs.float()[..., None, :, :])
    err = torch.where(ok[..., None], err, float("inf"))
    err = torch.where(torch.isnan(err), float("inf"), err)
    if valid is not None:
        err = torch.where(valid[..., None, :], err, float("inf"))
    is_in = err <= thr
    counts = is_in.sum(-1)
    msac = torch.clamp(err, max=thr).sum(-1)
    worst = msac.amax(-1, keepdim=True)
    order = counts.double() - (msac / (worst + 1.0)).double()
    return R, t, is_in, counts, msac, order


def bank_verdict(out, world, obs, idx, valid, thr=BANK_THR,
                 what="pnp_bank") -> dict:
    """``pnp_bank_cuda``'s result ``out`` against the plain route's bank on
    the same tensors, stream by stream, under the criteria above: fails
    on a miss.  Returns the streams, those with the plain route's winner
    and those with a near-tie, the largest R/t gap of the former and the
    most mask points that differ in the latter."""
    from boofcv_tpu_torch.geo import robust
    (R, t, ok), inl, count, err = out
    plain = robust._plain_bank(None, world, obs, idx.shape[-2], thr, valid,
                               "grunert", idx)
    Rs, ts, is_in, counts, msac, order = bank_table(world, obs, idx, valid,
                                                    thr)
    lead = idx.shape[:-2]
    flat = lambda a: a.reshape((-1,) + a.shape[len(lead):]).cpu().double()
    R, t, inl, count, err = (flat(a) for a in (R, t, inl, count, err))
    Rs, ts, is_in, counts, msac, order = (flat(a) for a in (
        Rs, ts, is_in, counts, msac, order))
    check(torch.equal(flat(plain.num_inliers),
                      counts.gather(-1, order.argmax(-1, True))[:, 0]),
          f"{what}: the table's winners are not the plain route's")
    n = inl.shape[-1]
    v = {"streams": R.shape[0], "same_winner": 0, "near_ties": 0,
         "pose_err": 0.0, "mask_differ": 0}
    for s in range(R.shape[0]):
        jp = int(order[s].argmax())
        check(int(count[s]) == int(counts[s, jp]),
              f"{what}: stream {s}: {int(count[s])} inliers, the plain "
              f"route's winner {int(counts[s, jp])}")
        gap = torch.maximum((Rs[s] - R[s]).abs().amax((-1, -2)),
                            (ts[s] - t[s]).abs().amax(-1))
        jk = int(torch.nan_to_num(gap, nan=float("inf")).argmin())
        if jk == jp or float(gap[jp]) <= BANK_POSE_TOL:
            close = lambda a, b: bool(np.allclose(
                a.numpy(), b.numpy(), rtol=0, atol=BANK_POSE_TOL,
                equal_nan=True))
            check(close(R[s], Rs[s, jp]) and close(t[s], ts[s, jp]),
                  f"{what}: stream {s}: R, t {float(gap[jp]):.3e} from "
                  f"the plain route's winner (limit {BANK_POSE_TOL})")
            check(torch.equal(inl[s], is_in[s, jp]),
                  f"{what}: stream {s}: the inlier mask differs from the "
                  f"plain route's winner's")
            check(bool(np.isclose(float(err[s]), float(msac[s, jp]),
                                  rtol=BANK_MSAC_RTOL, atol=0)),
                  f"{what}: stream {s}: MSAC {float(err[s])} against "
                  f"{float(msac[s, jp])}")
            v["same_winner"] += 1
            v["pose_err"] = max(v["pose_err"],
                                float(torch.nan_to_num(gap[jp])))
        else:
            o_k, o_p = float(order[s, jk]), float(order[s, jp])
            check(abs(o_k - o_p) <= BANK_ORDER_RTOL * abs(o_p),
                  f"{what}: stream {s}: another winner, order {o_k} "
                  f"against the plain route's {o_p}: not a near-tie")
            differ = int((inl[s] != is_in[s, jp]).sum())
            check(differ <= BANK_MASK_SHARE * n,
                  f"{what}: stream {s}: near-tie winners' masks differ on "
                  f"{differ} of {n} points")
            v["near_ties"] += 1
            v["mask_differ"] = max(v["mask_differ"], differ)
    return v


def _bank_bound(world, obs, valid, idx) -> dict:
    """Bound of one ``pnp_bank`` launch: every input once and the outputs
    (mask, pose, counts) once; about 25 float32 operations a point and
    solution (the 3x3 product and translation, the division, the
    residual) and about 1,000 a sample for the solve."""
    b = int(np.prod(idx.shape[:-2]))
    k, n = idx.shape[-2], world.shape[-2]
    n_bytes = sum(x.numel() * x.element_size()
                  for x in (world, obs, valid, idx)) + b * (n + 61)
    return bound(n_bytes, 25 * b * k * 4 * n + 1000 * b * k)


def _bank_case(tag: str, world, obs, valid, idx) -> dict:
    """``pnp_bank`` against the plain route (``robust._plain_bank``) on
    the same banks (:func:`bank_verdict`; two launches bit-equal), the
    kernel's device ms and ms a call beside its bound, the plain route's
    device ms, ms a call and launches a call."""
    from boofcv_tpu_torch.geo import robust
    from boofcv_tpu_torch.kernels import pnp_bank as pb
    k = idx.shape[-2]
    kern = lambda: pb.pnp_bank_cuda(world, obs, idx, valid, BANK_THR)
    plain = lambda: robust._plain_bank(None, world, obs, k, BANK_THR, valid,
                                       "grunert", idx)
    shape = tuple(idx.shape[:-2]) + (k * 4, world.shape[-2])
    what = f"pnp_bank {tag} [{', '.join(map(str, shape))}]"
    out = kern()
    again = kern()
    check(all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(out),
        torch.utils._pytree.tree_leaves(again))),
          f"{what}: two launches differ")
    v = bank_verdict(out, world, obs, idx, valid, what=what)
    events, _ = _trace(plain, cpu=False)
    print(f"kernel: {what}: against the plain route in {v['streams']} "
          f"streams: the plain route's winner in {v['same_winner']} (R, t "
          f"within {v['pose_err']:.3e}, limit {BANK_POSE_TOL}; masks "
          f"equal), a near-tie in {v['near_ties']} (masks differ on at most "
          f"{v['mask_differ']} of {world.shape[-2]}); counts equal; two "
          f"launches bit-equal; plain route launches a call={len(events)}")
    out = _print_times(what, _bank_bound(world, obs, valid, idx),
                       _times(kern, plain, "pnp_bank_kernel", 5))
    return {**out, **v, "plain_launches": len(events)}


def phase_bank_kernel(dev) -> tuple:
    """``pnp_bank`` at the VO cells' shapes, one stream and 16: returns
    (the one stream's numbers, the 16 streams')."""
    return (_bank_case("single stream", *_bank_scene(dev, ())),
            _bank_case("B=16", *_bank_scene(dev, (16,))))


def _stage_timer():
    """(ms by name, timed): ``timed(name, fn)`` wraps ``fn`` so that each
    call, with a synchronize before and after, adds its host wall ms to
    ``ms[name]``."""
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
    return ms, timed


def _stage_table(tag, cfg, state, lefts, rights) -> None:
    """Host wall ms of each stage of a steady-state step, a synchronize
    before and after each, medians over 10 frames; then a forced spawn.
    ``state`` of one stream with [H, W] frames in ``lefts[i]``, or stacked
    with [B, H, W] frames."""
    from boofcv_tpu_torch.feature import klt
    from boofcv_tpu_torch.geo import pnp, robust
    from boofcv_tpu_torch.ip import pyramid_ops
    from boofcv_tpu_torch.sfm import stereo_vo
    ms, timed = _stage_timer()
    track_estimate, spawn_fn = stereo_vo._make_step_parts(cfg, K, BASELINE)
    patches = [(pyramid_ops, "pyramid_average", "pyramid"),
               (klt, "track_pyramid", "klt_track_pyramid"),
               (robust, "sample_indices", "ransac_sample_indices"),
               (robust, "ransac", "ransac_total"),
               (robust, "_kernel_bank", "ransac_total"),
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
    from boofcv_tpu_torch.sfm import stereo_vo
    cfg = stereo_vo.StereoVoConfig()
    vo = stereo_vo.StereoVisualOdometry(cfg, K, BASELINE, H, W, seed=0,
                                        device=dev)

    # the main path, counted: bootstrap + 40 steps through process()
    _reset_launches()
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
    launches = _launches(STEREO_VO_KERNELS)
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
          f"{launches['window_gather']} gn_pose={launches['gn_pose']} "
          f"pnp_bank={launches['pnp_bank']} "
          f"(spawns seen after the bootstrap: {spawns})")
    print(f"slice: process() per-frame wall ms (step + pose readback): "
          f"median={1e3 * np.median(frame_s[1:]):.3f} "
          f"p90={1e3 * np.percentile(frame_s[1:], 90):.3f} "
          f"bootstrap={1e3 * frame_s[0]:.3f}")
    check(launches["klt_track"] == N_FRAMES - 1,
          f"klt_track launched {launches['klt_track']} times in "
          f"{N_FRAMES - 1} track_pyramid calls")
    check(launches["gn_pose"] == N_FRAMES - 1,
          f"gn_pose launched {launches['gn_pose']} times in {N_FRAMES - 1} "
          f"steps (one refine a step)")
    check(launches["pnp_bank"] == N_FRAMES - 1,
          f"pnp_bank launched {launches['pnp_bank']} times in "
          f"{N_FRAMES - 1} steps (one RANSAC bank a step)")
    check(launches["window_gather"] >= 2 + 2 * spawns
          and launches["window_gather"] % 2 == 0,
          f"window_gather launched {launches['window_gather']} times: "
          f"expected 2 for the bootstrap and 2 for each of >= {spawns} spawns")
    check(ate < 0.15 * total, f"ATE {ate} >= 0.15 x motion {total}")
    check(rot < 2.0, f"final rotation error {rot} deg >= 2")
    check(n_ok == N_FRAMES - 1, f"pose_ok on {n_ok} of {N_FRAMES - 1} frames")

    # throughput: the sequence runner from the bootstrap state
    run = stereo_vo.make_sequence_runner(cfg, K, BASELINE)
    outs = []
    lefts = torch.stack([torch.from_numpy(l) for l, _ in frames[1:]]).to(dev)
    rights = torch.stack([torch.from_numpy(r) for _, r in frames[1:]]).to(dev)
    # warm-up, with the refine's inputs kept for phase_gn_kernel
    refine_calls = _capture_refine(lambda: outs.append(run(
        boot_state, lefts, rights)))
    s_end, ((Rs, ts), ms) = outs.pop()
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
    return {"launches": launches, "ts": ts.cpu().numpy(),
            "refine_calls": refine_calls}


def _count_sync_warnings(fn):
    """(fn's result, host syncs by call site) with sync warnings on."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "called a synchronizing CUDA operation" in str(w.message))


def _count_syncs(tag, step, state, lefts, rights) -> tuple:
    """Run ``step`` over the frames with sync warnings on; returns the last
    state and the count of host syncs, printed by call site."""
    def steps():
        s = state
        for left, right in zip(lefts, rights):
            s, _ = step(s, left, right)
        return s
    state, syncs = _count_sync_warnings(steps)
    n = sum(syncs.values())
    print(f"syncs: {tag}: {n} host syncs in {len(lefts)} steady-state "
          f"steps, by call site: {dict(sorted(syncs.items()))}")
    return state, n


LIBRARY_OPS = ("aten::linalg_cholesky_ex", "aten::linalg_solve_triangular",
               "aten::rand")


def _print_library_ops(tag: str, prof, what: str) -> dict:
    """Host and device ms of the library calls under the profiler; returns
    their device ms by name."""
    by_key = {e.key: e for e in prof.key_averages()}
    out = {}
    for name in LIBRARY_OPS:
        e = by_key.get(name)
        if e is not None:
            out[name] = e.device_time_total / 1e3
            print(f"{tag} {name} calls={e.count} host_ms="
                  f"{e.cpu_time_total / 1e3:.3f} device_ms="
                  f"{out[name]:.3f} ({what}; host time includes the ops it "
                  f"calls)")
    return out


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
    wall_prof = []

    def last_step():
        t1 = time.perf_counter()
        step(state, lefts[-1], rights[-1])
        torch.cuda.synchronize()
        wall_prof.append(1e3 * (time.perf_counter() - t1))
    kernels, prof = _trace(last_step)
    prof_ms = wall_prof[-1]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    klt_ms = sum(e.device_time for e in kernels
                 if "klt_track_kernel" in e.name) / 1e3
    print(f"device: {tag}: step {step_ms:.3f} ms (host wall, median of "
          f"{len(wall)}); one profiled step launches {len(kernels)} kernels, "
          f"device busy {busy_ms:.3f} ms ({prof_ms:.3f} ms wall under the "
          f"profiler), idle share {1 - busy_ms / step_ms:.4f} of the "
          f"unprofiled step; klt_track_kernel {klt_ms:.6f} ms of it")
    _print_library_ops(f"device: {tag}:", prof, "one profiled step")
    check(len(kernels) > 0, f"{tag}: the profiled step ran nothing on the "
                            "device")
    check(klt_ms > 0, f"{tag}: the profiled step did not run "
                      "klt_track_kernel")


def _times(kern, plain, kernel_name: str, plain_reps: int,
           library=None) -> dict:
    """ms over 200 back-to-back calls (CUDA events) and device ms (profiler)
    of a kernel's wrapper, and the same of its plain version and of the one
    PyTorch call ``library`` that computes the same function (if any)."""
    t = {"ms": cuda_ms(kern, 200), "plain_ms": cuda_ms(plain, plain_reps),
         "device_ms": device_ms(kern, 50, kernel_name),
         "plain_device_ms": device_ms(plain, max(plain_reps // 4, 2)),
         "library_ms": None}
    if library is not None:
        t["library_ms"] = cuda_ms(library, 200)
        t["library_device_ms"] = device_ms(library, 50)
    return t


def _print_times(what: str, bnd: dict, t: dict) -> dict:
    lib = ("library_ms=None (no single PyTorch call)"
           if t["library_ms"] is None else
           f"library_ms={t['library_ms']:.6f} library_device_ms="
           f"{t['library_device_ms']:.6f} (F.grid_sample nearest, border, "
           f"align_corners, on a prebuilt grid)")
    print(f"kernel: {what} bytes={bnd['bytes']} flops={bnd['flops']} "
          f"bound_ms={bnd['bound_ms']:.6f} bound_by={bnd['bound_by']} "
          f"device_ms={t['device_ms']:.6f} (profiler) kernel_ms={t['ms']:.6f} "
          f"(CUDA events, 200 back-to-back calls) plain_ms="
          f"{t['plain_ms']:.6f} plain_device_ms={t['plain_device_ms']:.6f} "
          f"{lib}")
    return {**t, "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"]}


def grid_sample_call(img, oy, ox, wy: int, wx: int):
    """The window gather as one PyTorch call, ``F.grid_sample(mode=
    "nearest", padding_mode="border", align_corners=True)`` at the windows'
    integer pixel centres: a closure over the image [h, w] (or [B, h, w])
    and a grid built here from the origins [N] (or [B, N]), returning
    [..., N, wy, wx].  Border padding is the gather's clamp."""
    import torch.nn.functional as F
    h, w = img.shape[-2:]
    lead = oy.shape[:-1]
    b = int(np.prod(lead)) if lead else 1
    n = oy.shape[-1]
    ys = oy.float()[..., :, None] + torch.arange(wy, device=oy.device)
    xs = ox.float()[..., :, None] + torch.arange(wx, device=ox.device)
    gy = (ys * (2.0 / (h - 1)) - 1.0)[..., :, :, None].expand(
        lead + (n, wy, wx))
    gx = (xs * (2.0 / (w - 1)) - 1.0)[..., :, None, :].expand(
        lead + (n, wy, wx))
    grid = torch.stack([gx, gy], dim=-1).reshape(b, n * wy, wx, 2)
    inp = img.reshape(b, 1, h, w)
    return lambda: F.grid_sample(
        inp, grid, mode="nearest", padding_mode="border",
        align_corners=True).reshape(lead + (n, wy, wx))


def _check_grid_sample(what: str, call, want) -> None:
    got = call()
    torch.cuda.synchronize()
    eq = torch.equal(got, want)
    print(f"kernel: window_gather {what}: F.grid_sample(nearest, border, "
          f"align_corners) equals the plain version={eq} max_abs_err="
          f"{float((got - want).abs().max())}")
    check(eq, f"grid_sample differs from the plain gather at {what}")


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
        lib = grid_sample_call(imgs, oyb, oxb, wy, wx)
        _check_grid_sample(f"batched {name} origins=[{b}, 512]", lib,
                           wg.gather_windows_reference(imgs, oyb, oxb, wy,
                                                       wx))
        t = _times(lambda: wg.gather_windows_cuda(imgs, oyb, oxb, wy, wx),
                   lambda: wg.gather_windows_reference(imgs, oyb, oxb, wy,
                                                       wx),
                   "window_gather_kernel", 50, library=lib)
        out["window_gather"][f"B{b}_{name}"] = _print_times(
            f"window_gather batched {name} origins=[{b}, 512] on {b} frames",
            bnd, t)

    # the batched runner's shapes: [64, 512] and [256, 512] strips on one
    # shared frame
    g2 = torch.Generator(device=dev).manual_seed(2)
    ys2 = torch.randint(0, H, (256, 512), generator=g2, device=dev,
                        dtype=torch.int32)
    xs2 = torch.randint(0, W, (256, 512), generator=g2, device=dev,
                        dtype=torch.int32)
    for b in (64, 256):
        imgs = lefts[0].expand(b, H, W)
        oyb, oxb = (ys2[:b] - 3).contiguous(), (xs2[:b] - 3 - 95).contiguous()
        got = wg.gather_windows_cuda(imgs, oyb, oxb, wy, wx)
        want = wg.gather_windows_reference(imgs, oyb, oxb, wy, wx)
        per_stream = all(torch.equal(got[i], wg.gather_windows_cuda(
            lefts[0], oyb[i], oxb[i], wy, wx)) for i in range(b))
        torch.cuda.synchronize()
        print(f"kernel: window_gather batched {name} shared origins=[{b}, "
              f"512] equal_plain={torch.equal(got, want)} "
              f"streams_equal_2d_launches={per_stream}")
        check(torch.equal(got, want) and per_stream,
              f"batched window_gather differs at [{b}, 512] shared")
        del got
        bnd = bound(touched_bytes(H, W, oyb, oxb, wy, wx, shared=True)
                    + 4 * b * 512 * wy * wx + 8 * b * 512, 0)
        lib = grid_sample_call(imgs, oyb, oxb, wy, wx)
        _check_grid_sample(f"batched {name} origins=[{b}, 512] shared", lib,
                           want)
        del want
        t = _times(lambda: wg.gather_windows_cuda(imgs, oyb, oxb, wy, wx),
                   lambda: wg.gather_windows_reference(imgs, oyb, oxb, wy,
                                                       wx),
                   "window_gather_kernel", 8, library=lib)
        out["window_gather"][f"B{b}_shared_{name}"] = _print_times(
            f"window_gather batched {name} origins=[{b}, 512] on one shared "
            f"frame", bnd, t)
        del lib
        torch.cuda.empty_cache()

    # klt_track: [B, 512] tracks, B different frames and one shared frame;
    # at B = 64 and 256 (the batched runner's) on the shared frame
    cfg = klt.KltConfig()
    max_err = 0.0
    for b, mode in ((8, "frames"), (8, "shared"), (16, "frames"),
                    (16, "shared"), (64, "shared"), (256, "shared")):
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
        if b != 16:
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
                   "klt_track_kernel", 8 if b <= 16 else 4)
        out["klt_track"][f"B{b}_{mode}"] = _print_times(what, bnd, t)
        del pyr, tm, ys_, xs_, args
        torch.cuda.empty_cache()
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


def phase_batched(dev, poses, frames, single) -> tuple:
    """The B-stream path: batched bootstrap + batched sequence runner.
    Returns (the launches by path, the refine's inputs of the B = 16
    counted run)."""
    from boofcv_tpu_torch.kernels import window_gather as wg
    from boofcv_tpu_torch.sfm import stereo_vo
    cfg = stereo_vo.StereoVoConfig()
    T = T_BATCHED
    L = torch.stack([torch.from_numpy(l) for l, _ in frames]).to(dev)
    R = torch.stack([torch.from_numpy(r) for _, r in frames]).to(dev)
    boot = stereo_vo.make_batched_bootstrap(cfg, K, BASELINE)
    launches, refine_calls = {}, []

    def drive(tag, b, run, boot_frames, lefts, rights, stream_poses):
        """One counted run (also the warm-up), its checks, then 3 timed."""
        _reset_launches()
        s0 = boot(stereo_vo.init_batched_state(cfg, b, H, W, seed=0),
                  *boot_frames)
        outs = []
        calls = _capture_refine(lambda: outs.append(run(s0, lefts, rights)))
        s_end, ((Rs, ts), ms) = outs.pop()
        torch.cuda.synchronize()
        launches[tag] = _launches(STEREO_VO_KERNELS)
        if b == 16:
            refine_calls[:] = calls
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
              f"{launches[tag]['window_gather']} gn_pose="
              f"{launches[tag]['gn_pose']} (expected {T}, {want_wg} and "
              f"{T})")
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
        check(launches[tag]["gn_pose"] == T,
              f"{tag}: gn_pose launched {launches[tag]['gn_pose']} times "
              f"in {T} batched steps")
        check(launches[tag]["pnp_bank"] == T,
              f"{tag}: pnp_bank launched "
              f"{launches[tag]['pnp_bank']} times in {T} batched "
              f"steps")
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
    return launches, refine_calls


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


def _forward_scene(rng, V, L, pts, yaw, step, noise, t_noise, p_noise):
    """Forward motion with slow yaw about +y; each point is seen in L
    consecutive views from a random first one; the initial guess has its
    translations and points perturbed, the two oldest views are fixed.
    Numpy arrays in ``make_problem``'s order, ``fixed_views`` last."""
    P = pts.shape[0]
    ang = yaw * np.arange(V)
    ca, sa = np.cos(ang), np.sin(ang)
    Rs = np.zeros((V, 3, 3))
    Rs[:, 0, 0], Rs[:, 0, 2] = ca, sa
    Rs[:, 1, 1] = 1.0
    Rs[:, 2, 0], Rs[:, 2, 2] = -sa, ca
    cs = np.stack([step[0] * np.arange(V), np.zeros(V),
                   step[1] * np.arange(V)], 1)
    ts = -np.einsum("vij,vj->vi", Rs, cs)
    first = rng.integers(0, V - L, P)
    views = first[:, None] + np.arange(L)[None, :]          # [P, L]
    pc = np.einsum("plij,pj->pli", Rs[views], pts) + ts[views]
    obs_valid = pc[..., 2] >= 0.5
    z = np.where(np.abs(pc[..., 2]) < 1e-12, 1e-12, pc[..., 2])
    obs_xy = pc[..., :2] / z[..., None] + rng.normal(0, noise, (P, L, 2))
    obs_xy[~obs_valid] = 0.0
    obs_view = np.where(obs_valid, views, 0).astype(np.int32)
    ts_n = ts + rng.normal(0, t_noise, ts.shape)
    pts_n = pts + rng.normal(0, p_noise, pts.shape)
    fixed = np.zeros(V, bool)
    fixed[:2] = True
    return Rs, ts_n, pts_n, obs_xy, obs_view, obs_valid, fixed


def window_ba_scene(V=100, P=2000, L=10, seed=7):
    """The reference benchmark's window scene: 100 keyframes, 2000 points,
    10 consecutive observations a point, noise 5e-4 in normalized
    coordinates."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-6, 6, P), rng.uniform(-3, 3, P),
                    rng.uniform(4, 30, P)], 1)
    return _forward_scene(rng, V, L, pts, 0.002, (0.02, 0.12), 5e-4, 0.01,
                          0.05)


def big_scene(V=1000, P=100_000, L=6, seed=5, noise=3e-4):
    """The reference's at-scale profiling scene: 1000 views, 100,000 points,
    6 consecutive observations a point."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-8, 8, P), rng.uniform(-4, 4, P),
                    rng.uniform(4, 40, P)], 1)
    return _forward_scene(rng, V, L, pts, 0.001, (0.008, 0.02), noise, 0.004,
                          0.02)


def np_lm_schur_baseline(Rs, ts, pts, obs_xy, obs_view, obs_valid, fixed,
                         iters=10):
    """Sparse-Schur LM in numpy + scipy (float64) on the host: the same
    algorithm class as the port's solver (analytic jacobians, per-point 3x3
    elimination, reduced camera system, damped Cholesky, accept/reject),
    written independently of it and without Jacobi scaling, so only the end
    points compare.  Returns (seconds of the solve, final cost)."""
    import scipy.linalg as sla
    V = len(Rs)
    P, L = obs_view.shape
    D = 6
    R, t, X = Rs.copy(), ts.copy(), pts.copy()
    lam = 1e-3

    def hat(w):
        z = np.zeros_like(w[..., 0])
        return np.stack([
            np.stack([z, -w[..., 2], w[..., 1]], -1),
            np.stack([w[..., 2], z, -w[..., 0]], -1),
            np.stack([-w[..., 1], w[..., 0], z], -1)], -2)

    def exp_so3(w):
        th = np.maximum(np.linalg.norm(w, axis=-1, keepdims=True), 1e-12)
        k = hat(w / th)
        s, c = np.sin(th)[..., None], np.cos(th)[..., None]
        return np.eye(3) + s * k + (1 - c) * (k @ k)

    def cost_of(R, t, X):
        Xc = np.einsum("plij,pj->pli", R[obs_view], X) + t[obs_view]
        z = np.where(np.abs(Xc[..., 2]) < 1e-12, 1e-12, Xc[..., 2])
        r = Xc[..., :2] / z[..., None] - obs_xy
        r[~obs_valid] = 0.0
        return 0.5 * np.sum(r * r)

    c0 = cost_of(R, t, X)
    t_start = time.perf_counter()
    flat = obs_view.reshape(-1)
    vi = np.broadcast_to(obs_view[:, :, None], (P, L, L)).reshape(-1)
    vj = np.broadcast_to(obs_view[:, None, :], (P, L, L)).reshape(-1)
    free = np.repeat(~fixed, D).astype(float)
    for _ in range(iters):
        R_o = R[obs_view]
        Xc = np.einsum("plij,pj->pli", R_o, X) + t[obs_view]
        z = np.where(np.abs(Xc[..., 2]) < 1e-12, 1e-12, Xc[..., 2])
        iz = 1.0 / z
        xx, yy = Xc[..., 0], Xc[..., 1]
        zero = np.zeros_like(iz)
        A = np.stack([np.stack([iz, zero, -xx * iz * iz], -1),
                      np.stack([zero, iz, -yy * iz * iz], -1)], -2)
        r = Xc[..., :2] * iz[..., None] - obs_xy
        Jv = np.concatenate([-(A @ hat(Xc)), A], -1)       # [P, L, 2, 6]
        Jp = A @ R_o                                        # [P, L, 2, 3]
        Jv[~obs_valid] = 0.0
        Jp[~obs_valid] = 0.0
        r[~obs_valid] = 0.0
        Hpp = np.einsum("plki,plkj->pij", Jp, Jp) + (lam + 1e-12) * np.eye(3)
        W = np.einsum("plki,plkj->plij", Jp, Jv)
        gp = -np.einsum("plki,plk->pi", Jp, r)
        gv_obs = -np.einsum("plki,plk->pli", Jv, r)
        Hpp_inv = np.linalg.inv(Hpp)
        Hvv = np.zeros((V, D, D))
        np.add.at(Hvv, flat, np.einsum("plki,plkj->plij", Jv,
                                       Jv).reshape(-1, D, D))
        gv_t = np.zeros((V, D))
        np.add.at(gv_t, flat, gv_obs.reshape(-1, D))
        Y = np.einsum("pij,pljk->plik", Hpp_inv, W)
        S = np.zeros((V * V, D, D))
        np.add.at(S, vi * V + vj,
                  np.einsum("plik,pmij->plmkj", W, Y).reshape(-1, D, D))
        S = -S.reshape(V, V, D, D)
        S[np.arange(V), np.arange(V)] += Hvv + lam * np.eye(D)
        hp = np.einsum("pij,pj->pi", Hpp_inv, gp)
        np.subtract.at(gv_t, flat,
                       np.einsum("plij,pi->plj", W, hp).reshape(-1, D))
        Sd = S.transpose(0, 2, 1, 3).reshape(V * D, V * D)
        Sd = Sd * free[:, None] * free[None, :]
        Sd[np.diag_indices(V * D)] += 1.0 - free
        dv = sla.cho_solve(sla.cho_factor(Sd), gv_t.reshape(-1) * free)
        dv = (dv * free).reshape(V, D)
        dp = np.einsum("pij,pj->pi", Hpp_inv,
                       gp - np.einsum("plij,plj->pi", W, dv[obs_view]))
        dR = exp_so3(dv[:, :3])
        Rn = dR @ R
        tn = np.einsum("vij,vj->vi", dR, t) + dv[:, 3:]
        Xn = X + dp
        c1 = cost_of(Rn, tn, Xn)
        if np.isfinite(c1) and c1 < c0:
            R, t, X, c0 = Rn, tn, Xn, c1
            lam = max(lam * 0.3, 1e-12)
        else:
            lam = min(lam * 10.0, 1e8)
    return time.perf_counter() - t_start, c0


def _solve_ms(fn, reps: int = 5, warm_up: bool = True) -> list:
    """ms of each of ``reps`` calls of ``fn`` after one warm-up (unless the
    caller has just made one): CUDA events around the whole call, from its
    first launch to its last kernel's end."""
    if warm_up:
        fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _profile_call(fn, cpu: bool = True) -> tuple:
    """(kernels launched, device busy ms, profiler) of one ``fn()``."""
    kernels, prof = _trace(fn, cpu=cpu)
    return len(kernels), sum(e.device_time for e in kernels) / 1e3, prof


def _rms(ba, prob) -> float:
    """Reprojection RMS over the valid observations."""
    r = ba.residuals(prob).to(torch.float64)
    n = prob.obs_valid.sum()
    return float(torch.sqrt((r * r).sum() / n))


def _check_costs(tag: str, info) -> np.ndarray:
    costs = info["costs"].cpu().numpy()
    c_init, c_final = float(info["initial_cost"]), float(info["final_cost"])
    check(bool(np.isfinite(costs).all()), f"{tag}: a cost is not finite")
    check(c_final <= c_init, f"{tag}: final cost {c_final} > initial {c_init}")
    check(bool((np.diff(np.concatenate([[c_init], costs])) <= 0).all()),
          f"{tag}: the costs increase somewhere: {costs.tolist()}")
    return costs


def phase_ba(dev) -> dict:
    """The LM-Schur solver at full width: the window scene, f32 mixed and
    f64, 10 iterations, against the numpy/scipy baseline on the host."""
    from boofcv_tpu_torch.geo import ba
    scene = window_ba_scene()
    Rs, ts, pts, obs_xy, obs_view, obs_valid, fixed = scene
    probs = {name: ba.make_problem(Rs, ts, pts, obs_xy, obs_view, obs_valid,
                                   fixed_views=fixed, dtype=dtype, device=dev)
             for name, dtype in (("f32", torch.float32),
                                 ("f64", torch.float64))}
    n_obs = int(obs_valid.sum())
    print(f"ba: window scene V={len(Rs)} P={len(pts)} L={obs_view.shape[1]} "
          f"valid observations={n_obs} of {obs_valid.size}, 10 iterations")
    out = {}
    for name, prob in probs.items():
        solve = lambda: ba.optimize(prob, iterations=10)
        groups = len(ba._buckets(prob, len(Rs)).groups)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches()
        (res, info), syncs = _count_sync_warnings(solve)
        torch.cuda.synchronize()
        n_fill = _launches()["schur_fill"]
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        costs = _check_costs(f"ba {name}", info)
        rms = _rms(ba, res)
        again, info2 = solve()
        same = bool(all(torch.equal(getattr(res, k), getattr(again, k))
                        for k in ("R", "t", "intr", "points"))
                    and torch.equal(info["costs"], info2["costs"]))
        ms = _solve_ms(solve)
        wall = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t1))
        n_kernels, busy_ms, prof = _profile_call(solve)
        med = float(np.median(ms))
        print(f"ba: {name}{' mixed' if name == 'f32' else ''} cost "
              f"{float(info['initial_cost']):.6e} -> "
              f"{float(info['final_cost']):.6e} rms={rms:.6e} costs="
              f"{[float(f'{c:.6e}') for c in costs]}")
        print(f"ba: {name} ms per solve (CUDA events around the whole solve, "
              f"5 after a warm-up)={[round(m, 3) for m in ms]} median="
              f"{med:.3f}; host wall with a synchronize, 3 runs="
              f"{[round(m, 3) for m in wall]}; one profiled solve launches "
              f"{n_kernels} kernels, device busy {busy_ms:.3f} ms, idle "
              f"share {1 - busy_ms / med:.4f} of the median solve; host "
              f"syncs inside optimize={sum(syncs.values())} "
              f"{dict(sorted(syncs.items()))}; two solves bit-equal={same}; "
              f"schur_fill launches={n_fill} ({groups} groups x 10 "
              f"iterations); peak device memory MiB={peak:.1f}")
        _print_library_ops(f"ba: {name}", prof, "one profiled solve")
        top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        print(f"ba: {name} host time by op, the six largest (self ms x calls, "
              "one profiled solve): " + " ".join(
                  f"{e.key}={e.self_cpu_time_total / 1e3:.3f}x{e.count}"
                  for e in top[:6]))
        check(torch.isfinite(res.R).all() and torch.isfinite(res.t).all()
              and torch.isfinite(res.points).all(),
              f"ba {name}: non-finite result")
        check(res.points.dtype == prob.points.dtype
              and res.R.shape == prob.R.shape
              and info["costs"].shape == (10,), f"ba {name}: wrong shapes")
        check(sum(syncs.values()) == 0,
              f"ba {name}: optimize made host syncs: {dict(syncs)}")
        check(same, f"ba {name}: two solves of one problem differ in bits")
        check(n_fill == 10 * groups, f"ba {name}: schur_fill launched "
                                     f"{n_fill} times, not 10 x {groups}")
        check(n_kernels > 0, f"ba {name}: nothing ran on the device")
        check(rms <= 7.5e-4, f"ba {name}: rms {rms} > 7.5e-4")
        out[name] = {"ms": med, "final_cost": float(info["final_cost"]),
                     "rms": rms, "kernels": n_kernels}
    cpu_s, cpu_cost = np_lm_schur_baseline(*scene)
    ratio = out["f64"]["final_cost"] / cpu_cost
    print(f"ba: numpy/scipy f64 baseline on the host (a CPU figure): "
          f"{1e3 * cpu_s:.1f} ms per solve, final cost {cpu_cost:.6e}; the "
          f"port's f64 final cost is {ratio:.6f} of it (bar: within 5 %), "
          f"its f32 mixed cost {out['f32']['final_cost'] / cpu_cost:.6f}")
    check(abs(ratio - 1) <= 0.05, f"ba: f64 final cost is {ratio} of the "
                                  "baseline's")
    return out


def _iteration_flops(P, L, V, D) -> float:
    """Floating-point operations of one LM iteration as the solver does it
    (multiply-adds as 2): jacobians, the per-observation blocks, the pair
    products, the [VD, VD] Cholesky, six triangular solves, two refinement
    residuals, two costs."""
    n = V * D
    per_obs = (2 * (27 + 18 + 18 + 40)                    # Xc, Jrot, Jp, proj
               + 2 * 2 * (9 + 3 * D + D * D + 3 + D)     # Hpp W Hvv gp gv
               + 2 * 9 * D + 2 * 3 * D                    # Y, corr
               + 2 * 3 * D + 2 * 30)                      # back-subst, costs
    return (P * L * per_obs + P * L * L * 3 * D * D * 2 + n ** 3 / 3
            + 6 * n * n + 2 * 2 * n * n)


def _fill_bound(order, W) -> dict:
    """Bound of one ``schur_fill`` launch over a group's ``order`` and
    slot array ``W`` [N, 3, D]: per valid pair D x D elements of 3
    multiply-adds and an add, and per view pair with a pair D x D
    subtractions; the valid slots' W and Y rows read once, the valid
    pairs' indices, each run's offsets and runs entry, and the blocks of
    the view pairs with a pair read and written once."""
    off = order.pair_offsets
    runs = off.shape[0] - 1
    pairs, slots = int(off[-1]), int(order.offsets[-1])
    full = int((off.diff() > 0).sum())
    D, s = W.shape[-1], W.element_size()
    return bound(2 * slots * 3 * D * s + 8 * pairs + 12 * runs + 8
                 + 2 * full * D * D * s, pairs * D * D * 7 + full * D * D)


def phase_ba_stages(dev) -> dict:
    """One LM iteration of the f32 mixed window solve, part by part with a
    synchronize around each (host wall ms, medians of 7 iterations after a
    warm-up one), the library calls under the profiler, the iteration's
    bound, and the Schur fill-in five ways: the solver's kernel and four
    others beside it.  The parts are the solver's own stages over the
    [P, L] table taken as a plan of one piece (``_scale_jacobians`` and
    ``_local_system`` run the slot code ``optimize`` runs), and its costs
    over the solve's plan.  Returns the kernel's record."""
    from boofcv_tpu_torch.geo import ba
    Rs, ts, pts, obs_xy, obs_view, obs_valid, fixed = window_ba_scene()
    prob = ba.make_problem(Rs, ts, pts, obs_xy, obs_view, obs_valid,
                           fixed_views=fixed, dtype=torch.float32, device=dev)
    V, (P, L), D = len(Rs), obs_view.shape, 6
    order = ba._view_order(prob.obs_view, V, prob.obs_valid)
    plan = ba._buckets(prob, V)                 # the solve's, for its costs
    lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
    ms, timed = _stage_timer()
    saved = (torch.linalg.cholesky_ex, torch.linalg.solve_triangular)
    for it in range(8):
        if it == 1:
            ms.clear()
        Jv, Jp, r = timed("jacobians", ba._jacobians)(prob)
        Jv_s, Jp_s, s_v, s_p = timed("scaling", ba._scale_jacobians)(
            prob.obs_view, Jv, Jp, V, order=order)
        timed("point_blocks", ba._point_blocks)(Jv_s, Jp_s, r, lam,
                                                torch.float64)
        S, gv_t, Hpp_inv, Wm, gp = timed("local_system", ba._local_system)(
            prob.obs_view, Jv_s, Jp_s, r, lam, V, solve_dtype=torch.float64,
            order=order)
        timed("reduced_solve_no_refinement", ba._solve_reduced)(
            S, gv_t, prob.fixed_views, lam, refine_steps=0)
        try:
            torch.linalg.cholesky_ex = timed("cholesky_ex", saved[0])
            torch.linalg.solve_triangular = timed("solve_triangular",
                                                  saved[1])
            ba._solve_reduced(S, gv_t, prob.fixed_views, lam, refine_steps=2)
        finally:
            torch.linalg.cholesky_ex, torch.linalg.solve_triangular = saved
        dv = timed("reduced_solve", ba._solve_reduced)(
            S, gv_t, prob.fixed_views, lam, refine_steps=2)

        def back_apply():
            dp = ba._back_substitute(prob.obs_view, Hpp_inv, Wm, gp, dv)
            return ba._apply_step(prob, dv / s_v, dp / s_p)
        cand = timed("back_substitute_apply", back_apply)()
        timed("two_costs", lambda: (ba._slot_cost(prob, plan),
                                    ba._slot_cost(cand, plan)))()
    med = {k: float(np.median(v)) for k, v in ms.items()}
    n_tri = len(ms["solve_triangular"]) // len(ms["cholesky_ex"])
    med["solve_triangular"] *= n_tri
    med["schur_assembly"] = med.pop("local_system") - med["point_blocks"]
    med["refinement"] = (med["reduced_solve"]
                         - med.pop("reduced_solve_no_refinement"))
    total = sum(med[k] for k in ("jacobians", "scaling", "point_blocks",
                                 "schur_assembly", "reduced_solve",
                                 "back_substitute_apply", "two_costs"))
    bnd = bound(prob.obs_xy.numel() * 4 + prob.obs_view.numel() * 4
                + prob.obs_valid.numel()
                + 2 * 4 * (prob.R.numel() + prob.t.numel()
                           + prob.points.numel()) + 16,
                _iteration_flops(P, L, V, D))
    print(f"ba_stages: one f32 mixed iteration at V={V} P={P} L={L}, host "
          f"wall ms with a synchronize around each part, medians of 7: "
          + " ".join(f"{k}={v:.3f}" for k, v in med.items())
          + f" (cholesky_ex and solve_triangular x{n_tri} are inside "
          f"reduced_solve; refinement = reduced_solve less the same call "
          f"with no refinement; schur_assembly = _local_system less the "
          f"point blocks) sum_of_parts={total:.3f}")
    print(f"ba_stages: the iteration's bound: bytes={bnd['bytes']} flops="
          f"{bnd['flops']} bound_ms={bnd['bound_ms']:.6f} bound_by="
          f"{bnd['bound_by']}; the parts take {total / bnd['bound_ms']:.0f}"
          f"x that")
    _, _, prof = _profile_call(lambda: ba._solve_reduced(
        S, gv_t, prob.fixed_views, lam, refine_steps=2))
    _print_library_ops("ba_stages:", prof, "one profiled reduced solve")

    # the Schur fill-in's sum over view pairs, five ways: the solver's
    # kernel (it subtracts from S in place; shown negated); the plain
    # version's sorted segmented sum, index_add_ (atomics on the card),
    # index_put_ with accumulate (sorts on every call), all of the one
    # [P, L, L, D, D] operand; and the dense product through a [P, L, V]
    # one-hot, which needs no such operand
    Hpp_inv, Wm, gp, gv_obs, Hvv_obs, Y, corr = ba._point_blocks(
        Jv_s, Jp_s, r, lam, torch.float64)
    view = prob.obs_view.long()
    key = (view[:, :, None] * V + view[:, None, :]).reshape(-1)
    pair = ba._pair_products(Wm, Y).reshape(-1, D, D)
    zeros = lambda: torch.zeros((V * V, D, D), device=dev)
    fill = ba._table_plan(prob.obs_view, V, order).fills[0]
    W3, Y3 = Wm.reshape(-1, 3, D), Y.reshape(-1, 3, D)

    def kernel():
        S = zeros()
        ba._fill_in(S, W3, Y3, order, fill)
        return S.neg_()

    def dense():
        onehot = torch.nn.functional.one_hot(view, V).to(torch.float32)
        Wg = torch.einsum("plv,pla->pva", onehot, Wm.reshape(P, L, 3 * D))
        Yg = torch.einsum("plv,pla->pva", onehot, Y.reshape(P, L, 3 * D))
        Wg = Wg.reshape(P, V, 3, D).permute(1, 3, 0, 2).reshape(V * D, P * 3)
        Yg = Yg.reshape(P, V, 3, D).permute(0, 2, 1, 3).reshape(P * 3, V * D)
        return (Wg @ Yg).reshape(V, D, V, D).permute(0, 2, 1, 3).reshape(
            V * V, D, D)

    ways = (("schur_fill (the solver's kernel)", kernel),
            ("pair_products (the plain version's operand)",
             lambda: ba._pair_products(Wm, Y)),
            ("sorted_segment_sum", lambda: ba._segment_sum(
                pair, order.pair_perm, order.pair_offsets)),
            ("index_add_", lambda: zeros().index_add_(0, key, pair)),
            ("index_put_accumulate", lambda: zeros().index_put_(
                (key,), pair, accumulate=True)),
            ("dense_one_hot (products included)", dense))
    want = ways[2][1]()
    scale = float(want.abs().max())
    dev_ms, rec = {}, {}
    for name, fn in ways:
        got = [fn() for _ in range(5)]
        same = all(torch.equal(got[0], g) for g in got[1:])
        dev_ms[name] = device_ms(fn, 5)
        line = (f"ba_stages: Schur fill-in, {name}: device_ms="
                f"{dev_ms[name]:.4f} (profiler, all its kernels) "
                f"ms_20_back_to_back_calls={cuda_ms(fn, 20):.4f} "
                f"five_calls_bit_equal={same}")
        if got[0].shape == want.shape:
            err = float((got[0] - want).abs().max()) / scale
            line += f" max_rel_diff_to_sorted={err:.3e}"
            check(err <= 1e-4, f"ba_stages: {name} differs from the sorted "
                               f"sum by {err}")
        print(line)
        if name.startswith(("sorted_segment_sum", "schur_fill")):
            check(same, f"ba_stages: {name} changes from call to call")
        if name.startswith("schur_fill"):
            rec = {"shape": f"[{P * L}] slots, {int(order.pair_offsets[-1])}"
                            f" valid pairs, V={V}, D={D}, float32",
                   "max_rel_err": err, "five_calls_bit_equal": same,
                   "bit_equal_to_plain": bool(torch.equal(got[0], want))}
    S = zeros()
    bnd = _fill_bound(order, W3)
    rec.update(device_ms=device_ms(lambda: ba._fill_in(S, W3, Y3, order,
                                                       fill),
                                   5, "schur_fill_kernel"),
               plain_device_ms=dev_ms[ways[1][0]] + dev_ms[ways[2][0]],
               **bnd)
    print(f"ba_stages: schur_fill kernel alone device_ms="
          f"{rec['device_ms']:.4f} bound_ms={bnd['bound_ms']:.6f} "
          f"bound_by={bnd['bound_by']} share="
          f"{bnd['bound_ms'] / rec['device_ms']:.4f}; the plain version "
          f"(products and sorted sum) device_ms={rec['plain_device_ms']:.4f}"
          f"; bit-equal to it={rec['bit_equal_to_plain']}")
    return rec


def phase_ba_vo(dev, poses, frames) -> dict:
    """The VO over the first 16 frames of the scene with the sliding window
    behind it: every state pushed, the window solved from the third frame
    on.  Returns the hand kernels' launches on this path."""
    from boofcv_tpu_torch.sfm import stereo_vo, window_ba
    n = 16
    cfg = stereo_vo.StereoVoConfig()
    vo = stereo_vo.StereoVisualOdometry(cfg, K, BASELINE, H, W, seed=0,
                                        device=dev)
    wba = window_ba.SlidingWindowBA(window=8, device=dev)
    _reset_launches()
    push_ms, opt_ms, tracks, n_obs, push_syncs, opt_syncs = ([] for _ in
                                                             range(6))
    centre = lambda R, t: -np.asarray(R).T @ np.asarray(t)
    for i, (left, right) in enumerate(frames[:n]):
        check(vo.process(left, right), f"ba_vo: the VO lost frame {i}")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, syncs = _count_sync_warnings(lambda: wba.push(
            vo.state, K[0, 0], K[1, 1], K[0, 2], K[1, 2]))
        push_ms.append(1e3 * (time.perf_counter() - t1))
        push_syncs.append(sum(syncs.values()))
        if i < 2:
            continue
        t1 = time.perf_counter()
        result, syncs = _count_sync_warnings(wba.optimize)
        torch.cuda.synchronize()
        opt_ms.append(1e3 * (time.perf_counter() - t1))
        opt_syncs.append(sum(syncs.values()))
        check(result is not None, f"ba_vo: frame {i}: the window was "
                                  "underconstrained")
        refined, info = result
        check(all(np.isfinite(R).all() and np.isfinite(t).all()
                  for R, t in refined), f"ba_vo: frame {i}: non-finite pose")
        check(float(info["final_cost"]) <= float(info["initial_cost"]),
              f"ba_vo: frame {i}: cost {float(info['initial_cost'])} -> "
              f"{float(info['final_cost'])}")
        tracks.append(info["tracks"])
        n_obs.append(info["observations"])
    torch.cuda.synchronize()
    launches = _launches()
    c_gt = centre(*poses[n - 1])
    err_vo = float(np.linalg.norm(vo.camera_to_world()[1] - c_gt))
    err_ba = float(np.linalg.norm(centre(*refined[-1]) - c_gt))
    print(f"ba_vo: {n} frames {W}x{H}, window 8, {wba.iterations} iterations: "
          f"push ms median={np.median(push_ms):.3f} max={max(push_ms):.3f} "
          f"(host syncs a push: {sorted(set(push_syncs))}); optimize ms "
          f"median={np.median(opt_ms[1:]):.3f} first={opt_ms[0]:.3f} max="
          f"{max(opt_ms):.3f} over {len(opt_ms)} calls (host syncs a call: "
          f"{sorted(set(opt_syncs))}); tracks per window min/median/max="
          f"{min(tracks)}/{int(np.median(tracks))}/{max(tracks)} "
          f"observations kept min/median/max={min(n_obs)}/"
          f"{int(np.median(n_obs))}/{max(n_obs)}; last frame's "
          f"camera-centre error: raw VO {err_vo:.6f}, refined window "
          f"{err_ba:.6f} (motion {float(np.linalg.norm(c_gt)):.6f}); launches "
          f"klt_track={launches['klt_track']} window_gather="
          f"{launches['window_gather']} gn_pose={launches['gn_pose']} "
          f"schur_fill={launches['schur_fill']} "
          f"pnp_bank={launches['pnp_bank']}")
    for name in ("klt_track", "gn_pose", "pnp_bank"):
        check(launches[name] == n - 1, f"ba_vo: {name} launched "
                                       f"{launches[name]} times in {n - 1} "
                                       f"steps")
    check(launches["window_gather"] >= 2,
          "ba_vo: window_gather was not launched by the bootstrap")
    check(launches["schur_fill"] >= len(opt_ms),
          "ba_vo: the window's solves did not launch schur_fill")
    return launches


def phase_ba_scale(dev) -> None:
    """V = 1000 views, 100,000 points: where the card has real work."""
    from boofcv_tpu_torch.geo import ba
    t0 = time.perf_counter()
    Rs, ts, pts, obs_xy, obs_view, obs_valid, fixed = big_scene()
    gen_s = time.perf_counter() - t0
    prob = ba.make_problem(Rs, ts, pts, obs_xy, obs_view, obs_valid,
                           fixed_views=fixed, dtype=torch.float32, device=dev)
    iters = 3
    solve = lambda: ba.optimize(prob, iterations=iters)
    groups = len(ba._buckets(prob, len(Rs)).groups)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    res, info = solve()
    torch.cuda.synchronize()
    n_fill = _launches()["schur_fill"]
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    costs = _check_costs("ba_scale", info)
    ms = _solve_ms(solve, reps=3)
    n_kernels, busy_ms, prof = _profile_call(solve)
    med = float(np.median(ms))
    lib = _print_library_ops("ba_scale:", prof, f"one profiled solve of "
                                                f"{iters} iterations")
    chol = lib.get("aten::linalg_cholesky_ex", 0.0)
    print(f"ba_scale: V={len(Rs)} P={len(pts)} L={obs_view.shape[1]} (no "
          f"cut) valid observations={int(obs_valid.sum())} f32 mixed "
          f"{iters} iterations: cost {float(info['initial_cost']):.6e} -> "
          f"{float(info['final_cost']):.6e} costs="
          f"{[float(f'{c:.6e}') for c in costs]} rms={_rms(ba, res):.6e}; ms "
          f"per solve={[round(m, 3) for m in ms]} ms per iteration="
          f"{med / iters:.3f} (the solve's median over {iters}: the view "
          f"order and the first cost included); {n_kernels} kernels, device "
          f"busy {busy_ms:.3f} ms, idle share {1 - busy_ms / med:.4f}; "
          f"cholesky_ex [{6 * len(Rs)}, {6 * len(Rs)}] device ms per "
          f"iteration={chol / iters:.3f}, its share of the device's busy "
          f"time {chol / busy_ms:.4f}; schur_fill launches={n_fill} "
          f"({groups} groups x {iters} iterations); peak device memory "
          f"MiB={peak:.1f} (scene made on the host in {gen_s:.2f}s)")
    check(torch.isfinite(res.points).all() and torch.isfinite(res.R).all(),
          "ba_scale: non-finite result")
    check(n_fill == iters * groups, f"ba_scale: schur_fill launched "
                                    f"{n_fill} times, not {iters} x {groups}")


# ---------------------------------------------------------------------------
# the dense-image breadth path: dense BM and SGM, SURF, association,
# Horn-Schunck, each at the reference breadth benchmark's size
# ---------------------------------------------------------------------------

def scene_pair(seed=0, h=None, w=None, dmax=None, extra_rows=0):
    """The breadth benchmark's stereo pair (numpy only): a band-limited
    texture on a plane whose disparity grows with the row from 18 to 70 at
    96 disparities, so left(y, x) = right(y, x - d(y)) up to the sampling.
    Returns (left, right, disparity, texture); ``extra_rows`` more rows of
    texture than of image let a caller cut a shifted copy."""
    h, w, dmax = h or H, w or W, dmax or DMAX
    rng = np.random.default_rng(seed)
    tex = rng.normal(0, 1, (h + extra_rows, w + dmax + 8)).astype(np.float32)
    k = np.hanning(9)
    k /= k.sum()
    tex = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, tex)
    tex = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, tex)
    tex = (128 + 60 * tex / tex.std()).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = (18 + 52 * yy / h) * (dmax / 96)
    cols = xx + disp
    c0 = np.floor(cols).astype(int)
    a = cols - c0
    rows = yy.astype(int)
    right = (1 - a) * tex[rows, c0] + a * tex[rows, c0 + 1]
    return tex[:h, :w].copy(), right.astype(np.float32), disp, tex


def np_box_sum(vol, r):
    """Box sum over the last two axes by prefix sums."""
    if r == 0:
        return vol
    p = np.pad(vol, [(0, 0)] * (vol.ndim - 2) + [(r + 1, r), (r + 1, r)])
    c = p.cumsum(-2).cumsum(-1)
    s = 2 * r + 1
    return (c[..., s:, s:] - c[..., :-s, s:] - c[..., s:, :-s]
            + c[..., :-s, :-s])


def np_block_match(left, right, dmax, r=3):
    """Vectorized numpy BM on the host: SAD volume by shifts and box sums,
    winner-take-all, left-right check, subpixel parabola (the same spec as
    ``block_match``, written independently; its out-of-range sentinel is
    300 a pixel)."""
    hh, ww = left.shape
    big = 300.0
    cost = np.full((dmax, hh, ww), big, np.float32)
    for d in range(dmax):
        cost[d, :, d:] = np.abs(left[:, d:] - right[:, :ww - d if d else ww])
    agg = np_box_sum(cost, r)
    best = agg.argmin(0)
    bc = np.take_along_axis(agg, best[None], 0)[0]
    costR = np.full_like(cost, big * (2 * r + 1) ** 2)
    for d in range(dmax):
        costR[d, :, :ww - d if d else ww] = agg[d, :, d:]
    bestR = costR.argmin(0)
    xr = np.clip(np.arange(ww)[None, :] - best, 0, ww - 1)
    lr_ok = np.abs(np.take_along_axis(bestR, xr, 1) - best) <= 1
    dm = np.clip(best - 1, 0, dmax - 1)
    dp = np.clip(best + 1, 0, dmax - 1)
    cm = np.take_along_axis(agg, dm[None], 0)[0]
    cp = np.take_along_axis(agg, dp[None], 0)[0]
    denom = np.maximum(cm + cp - 2 * bc, 1e-9)
    sub = best + np.clip(0.5 * (cm - cp) / denom, -0.5, 0.5)
    return np.where(lr_ok, sub, -1.0)


def np_census5(img):
    """5x5 census transform -> uint32."""
    p = np.pad(img, 2, mode="edge")
    h, w = img.shape
    out = np.zeros((h, w), np.uint32)
    bit = 0
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if dy == 0 and dx == 0:
                continue
            nb = p[2 + dy:2 + dy + h, 2 + dx:2 + dx + w]
            out |= (nb < img).astype(np.uint32) << np.uint32(bit)
            bit += 1
    return out


def np_popcount32(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def np_sgm(left, right, dmax, p1=5.0, p2=60.0):
    """Vectorized numpy SGM on the host: 5x5 census cost and four path
    aggregations, each scan sequential along its path and vectorized over
    the other axis and the disparities; integer winner, no validation."""
    hh, ww = left.shape
    cl = np_census5(left)
    cr = np_census5(right)
    cost = np.full((hh, ww, dmax), 24.0, np.float32)
    for d in range(dmax):
        cost[:, d:, d] = np_popcount32(cl[:, d:] ^ cr[:, :ww - d if d else ww])

    def scan(c):
        out = np.empty_like(c)
        out[:, 0] = c[:, 0]
        for x in range(1, c.shape[1]):
            prev = out[:, x - 1]                       # [H, D]
            m = prev.min(-1, keepdims=True)
            shift_m = np.minimum(np.roll(prev, 1, -1), np.roll(prev, -1, -1))
            shift_m[:, 0] = prev[:, 1]
            shift_m[:, -1] = prev[:, -2]
            best = np.minimum(prev, np.minimum(shift_m + p1, m + p2))
            out[:, x] = c[:, x] + best - m
        return out

    agg = scan(cost)
    agg = agg + scan(cost[:, ::-1])[:, ::-1]
    ct = cost.transpose(1, 0, 2)
    agg = agg + scan(ct).transpose(1, 0, 2)
    agg = agg + scan(ct[:, ::-1])[:, ::-1].transpose(1, 0, 2)
    return agg.argmin(-1)


def np_surf_detdesc(img, max_feats=1000):
    """Vectorized numpy SURF on the host (float64): integral image,
    two-octave Fast-Hessian box responses, 3x3x3 nonmax and top-K, 64-D
    descriptors from indexed integral-image lookups over all features at
    once.  Timed as the host's figure; its features are not compared."""
    h, w = img.shape
    ii = np.zeros((h + 1, w + 1), np.float64)
    ii[1:, 1:] = img.cumsum(0).cumsum(1)

    def box(y0, x0, y1, x1):
        y0, y1 = np.clip(y0, 0, h), np.clip(y1, 0, h)
        x0, x1 = np.clip(x0, 0, w), np.clip(x1, 0, w)
        return ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]

    yy, xx = np.mgrid[0:h, 0:w]

    def hessian(size):
        l = size // 3
        b = (size - 1) // 2
        half = l // 2
        dxx = (box(yy - l + 1, xx - b, yy + l, xx + b + 1)
               - 3.0 * box(yy - l + 1, xx - half, yy + l, xx + half + 1))
        dyy = (box(yy - b, xx - l + 1, yy + b + 1, xx + l)
               - 3.0 * box(yy - half, xx - l + 1, yy + half + 1, xx + l))
        dxy = (box(yy - l, xx - l, yy + 1, xx + 1)
               + box(yy + 1, xx + 1, yy + l + 1, xx + l + 1)
               - box(yy - l, xx + 1, yy + 1, xx + l + 1)
               - box(yy + 1, xx - l, yy + l + 1, xx + 1))
        n = 1.0 / (size * size)
        return (dxx * n) * (dyy * n) - 0.81 * (dxy * n) ** 2

    feats = []
    for sizes in ((9, 15, 21, 27), (15, 27, 39, 51)):
        resp = np.stack([hessian(s) for s in sizes])
        mid = resp[1:-1]
        is_max = np.ones_like(mid, bool)
        for ds in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if ds == dy == dx == 0:
                        continue
                    is_max &= mid >= np.roll(resp, (ds, dy, dx),
                                             (0, 1, 2))[1:-1]
        cand = np.where(is_max, mid, -np.inf).reshape(-1)
        k = min(max_feats // 2, cand.size)
        top = np.argpartition(cand, -k)[-k:]
        s_i, rem = np.divmod(top, h * w)
        fy, fx = np.divmod(rem, w)
        feats.append((fy, fx, np.array(sizes)[s_i + 1] / 9.0 * 1.2))
    fy = np.concatenate([f[0] for f in feats])[:max_feats]
    fx = np.concatenate([f[1] for f in feats])[:max_feats]
    fs = np.concatenate([f[2] for f in feats])[:max_feats]

    n = len(fy)
    g = np.arange(-9.5, 10.0, 1.0)                 # 20 samples per axis
    sy = fy[:, None, None] + fs[:, None, None] * g[None, :, None]
    sx = fx[:, None, None] + fs[:, None, None] * g[None, None, :]
    syi = np.clip(sy.astype(int), 2, h - 3)
    sxi = np.clip(sx.astype(int), 2, w - 3)
    r2 = np.maximum((fs * 2).astype(int), 1)[:, None, None]
    hx = (box(syi - r2, sxi, syi + r2, sxi + r2)
          - box(syi - r2, sxi - r2, syi + r2, sxi))
    hy = (box(syi, sxi - r2, syi + r2, sxi + r2)
          - box(syi - r2, sxi - r2, syi, sxi + r2))
    w_g = np.exp(-(g[:, None] ** 2 + g[None, :] ** 2) / (2 * 3.3 ** 2))
    hx = (hx * w_g).reshape(n, 4, 5, 4, 5).transpose(0, 1, 3, 2, 4)
    hy = (hy * w_g).reshape(n, 4, 5, 4, 5).transpose(0, 1, 3, 2, 4)
    desc = np.stack([hx.sum((3, 4)), np.abs(hx).sum((3, 4)),
                     hy.sum((3, 4)), np.abs(hy).sum((3, 4))],
                    -1).reshape(n, 64)
    desc /= np.maximum(np.linalg.norm(desc, axis=1, keepdims=True), 1e-12)
    return fy, fx, desc


def np_associate(da, db):
    """Mutual nearest neighbour on the host: one BLAS product and two
    argmins."""
    s = (-2.0 * da @ db.T + (da * da).sum(1)[:, None]
         + (db * db).sum(1)[None, :])
    fwd = s.argmin(1)
    bwd = s.argmin(0)
    return fwd, bwd[fwd] == np.arange(len(da))


def np_horn_schunck(i1, i2, alpha=20.0, iterations=200):
    """Vectorized numpy single-level Horn-Schunck on the host, float64: the
    derivative estimates ``horn_schunck`` documents (central differences
    with replicated edges, averaged over the two frames) and Jacobi
    iterations over the whole field.  The reference breadth benchmark's
    baseline takes forward differences instead and ends 0.06 px of endpoint
    error away from the function it is held against."""
    i1 = i1.astype(np.float64)
    i2 = i2.astype(np.float64)

    def central(f, axis):
        p = np.pad(f, 1, "edge")
        return (0.5 * (p[2:, 1:-1] - p[:-2, 1:-1]) if axis == 0
                else 0.5 * (p[1:-1, 2:] - p[1:-1, :-2]))

    dx = 0.5 * (central(i1, 1) + central(i2, 1))
    dy = 0.5 * (central(i1, 0) + central(i2, 0))
    dt = i2 - i1
    a2 = alpha * alpha
    u = np.zeros_like(i1)
    v = np.zeros_like(i1)

    def lap_avg(f):
        p = np.pad(f, 1, "edge")
        return ((p[1:-1, :-2] + p[1:-1, 2:] + p[:-2, 1:-1] + p[2:, 1:-1]) / 6.0
                + (p[:-2, :-2] + p[:-2, 2:] + p[2:, :-2] + p[2:, 2:]) / 12.0)

    for _ in range(iterations):
        ub = lap_avg(u)
        vb = lap_avg(v)
        num = dx * ub + dy * vb + dt
        den = a2 + dx * dx + dy * dy
        u = ub - dx * num / den
        v = vb - dy * num / den
    return u, v


def _host_ms(fn) -> tuple:
    """(host wall ms of one call, its result): the numpy baselines take
    seconds, one repetition each."""
    t0 = time.perf_counter()
    out = fn()
    return 1e3 * (time.perf_counter() - t0), out


def _breadth(tag: str, what: str, fn, dev, bnd: dict, traffic: dict,
             allow_syncs: bool = False, long_call: bool = False) -> tuple:
    """Run ``fn`` on the card as a breadth phase measures it and print the
    phase's line: host syncs and peak memory of one call, ms per call (CUDA
    events around the whole call, 5 after a warm-up), kernels, device
    busy ms and idle share of one profiled call, the function's bound
    (inputs read once, outputs written once, its operations) and the least
    time for the bytes this formulation moves.  Returns (fn's result,
    median ms).  A host sync inside ``fn`` fails the run unless
    ``allow_syncs`` (a function whose reference reads the device in a loop
    condition, or factors on the host's word).  ``long_call`` (a call of
    seconds and 10^5 launches): 3 timed calls, the sync count's call is the
    warm-up and the profiler traces the device alone."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out, syncs = _count_sync_warnings(fn)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    reps = 3 if long_call else 5
    ms = _solve_ms(fn, reps, warm_up=not long_call)
    n_kernels, busy_ms, _ = _profile_call(fn, cpu=not long_call)
    med = float(np.median(ms))
    print(f"{tag}: {what}: ms per call (CUDA events around the whole call, "
          f"{reps} after a warm-up)={[round(m, 3) for m in ms]} "
          f"median={med:.3f}; "
          f"one profiled call launches {n_kernels} kernels, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / med:.4f} of the "
          f"median call; host syncs={sum(syncs.values())} "
          f"{dict(sorted(syncs.items()))}; peak device memory MiB={peak:.1f}; "
          f"bound (inputs and outputs once, {bnd['flops']} operations, "
          f"{bnd['bytes']} B)={bnd['bound_ms']:.6f} ms by {bnd['bound_by']}; "
          f"the {traffic['bytes']} B this formulation moves take at least "
          f"{traffic['bound_ms']:.6f} ms")
    check(allow_syncs or sum(syncs.values()) == 0,
          f"{tag}: host syncs: {dict(syncs)}")
    check(n_kernels > 0, f"{tag}: nothing ran on the device")
    return out, med


def _breadth_stages(tag: str, stages) -> None:
    """Where a breadth phase's time goes: each (name, fn) stage alone, host
    wall ms with a synchronize before and after (median of 3 after a
    warm-up), and the kernels and device busy ms of one profiled call."""
    parts = []
    for name, fn in stages:
        fn()
        wall = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t0))
        n_kernels, busy_ms, _ = _profile_call(fn)
        parts.append(f"{name}: wall {np.median(wall):.3f} ms, {n_kernels} "
                     f"kernels, device busy {busy_ms:.3f} ms")
    print(f"{tag}: stages, each alone: " + "; ".join(parts))


def _disparity_bars(tag: str, d: np.ndarray, gt: np.ndarray) -> tuple:
    """(median abs error over the valid pixels, valid share), held to the
    bars: at most 0.5 px, at least 0.6."""
    check(d.shape == gt.shape and bool(np.isfinite(d).all()),
          f"{tag}: a disparity map shaped {d.shape} or not finite")
    ok = d > 0
    err, share = float(np.median(np.abs(d - gt)[ok])), float(ok.mean())
    check(err <= 0.5, f"{tag}: median abs error {err} px > 0.5")
    check(share >= 0.6, f"{tag}: valid share {share} < 0.6")
    return err, share


def phase_breadth_disparity(dev) -> None:
    """``breadth_bm:`` dense SAD block matching and ``breadth_sgm:`` 4-path
    census SGM on the 640x480 pair, 96 disparities."""
    from boofcv_tpu_torch.feature import disparity
    left_np, right_np, gt, _ = scene_pair(0)
    left = torch.from_numpy(left_np).to(dev)
    right = torch.from_numpy(right_np).to(dev)
    h, w = left_np.shape
    vol = DMAX * h * w * 4            # bytes of one [D, H, W] f32 volume
    io = 3 * h * w * 4                # two images in, one map out

    cfg = disparity.DisparityConfig(max_disparity=DMAX, radius_x=3,
                                    radius_y=3, texture_threshold=0.0)
    # SAD 2 an element, the two prefix-sum passes ~8, selection ~6; the
    # volume is written or read about 14 times (errors, pad, two prefix
    # sums and two differences, the two argmins, the re-indexed copy)
    d, _ = _breadth("breadth_bm", f"block_match {w}x{h} D={DMAX} radius 3",
                    lambda: disparity.block_match(left, right, cfg), dev,
                    bound(io, DMAX * h * w * 16.0), bound(14 * vol, 0))
    err, share = _disparity_bars("breadth_bm", d.cpu().numpy(), gt)
    cost = disparity.cost_volume(left, right, cfg)
    _breadth_stages("breadth_bm", (
        ("cost_volume (shifted differences, then the box filter)",
         lambda: disparity.cost_volume(left, right, cfg)),
        ("of it _separable_box",
         lambda: disparity._separable_box(cost, cfg.radius_y, cfg.radius_x)),
        ("_wta_select", lambda: disparity._wta_select(cost, cfg))))
    del cost
    cpu_ms, dn = _host_ms(lambda: np_block_match(left_np, right_np, DMAX))
    errn = float(np.median(np.abs(dn - gt)[dn > 0]))
    print(f"breadth_bm: median abs error {err:.6f} px over the valid pixels "
          f"(share {share:.6f}; bars 0.5 px and 0.6); numpy BM on the host "
          f"(a CPU figure): {cpu_ms:.1f} ms, median abs error {errn:.6f} px "
          f"(bar: within 0.1 px of it)")
    check(abs(err - errn) <= 0.1, f"breadth_bm: median error {err} px against "
                                  f"the numpy BM's {errn}")

    scfg = disparity.SgmConfig(max_disparity=DMAX, paths=4, error="census")
    # census 48 a pixel, Hamming 8 an element, four scans of ~6; the volume
    # moves about 17 times (cost, the stacked copies and padded states of
    # two batched scans, the sums, the selection)
    d, _ = _breadth("breadth_sgm", f"sgm {w}x{h} D={DMAX} 4 paths census",
                    lambda: disparity.sgm(left, right, scfg), dev,
                    bound(io, h * w * 48.0 + DMAX * h * w * 32.0),
                    bound(17 * vol, 0))
    err, share = _disparity_bars("breadth_sgm", d.cpu().numpy(), gt)
    bm_cfg = cfg._replace(radius_x=0, radius_y=0, error="census")
    cost = torch.clamp(disparity.cost_volume(left, right, bm_cfg), max=1e5)
    agg = [disparity._aggregate(cost, scfg.penalty_small, scfg.penalty_large,
                                4) for _ in range(2)]
    same = bool(torch.equal(agg[0], agg[1]))
    whole = bool((agg[0] == torch.round(agg[0])).all())
    _breadth_stages("breadth_sgm", (
        ("cost_volume (census, Hamming)",
         lambda: disparity.cost_volume(left, right, bm_cfg)),
        ("_aggregate (two batched scans)", lambda: disparity._aggregate(
            cost, scfg.penalty_small, scfg.penalty_large, 4)),
        ("_wta_select", lambda: disparity._wta_select(agg[0], bm_cfg))))
    del agg, cost
    cpu_ms, dn = _host_ms(lambda: np_sgm(left_np, right_np, DMAX))
    errn = float(np.median(np.abs(dn - gt)[dn > 0]))
    print(f"breadth_sgm: median abs error {err:.6f} px over the valid pixels "
          f"(share {share:.6f}; bars 0.5 px and 0.6); aggregated volume of "
          f"two calls bit-equal={same}, all whole numbers={whole}; numpy SGM "
          f"on the host (a CPU figure, integer winners): {cpu_ms:.1f} ms, "
          f"median abs error {errn:.6f} px")
    check(same, "breadth_sgm: two aggregations of one cost volume differ")
    check(whole, "breadth_sgm: the census aggregation left the integers")


def phase_breadth_surf(dev) -> None:
    """``breadth_surf:`` integral image, two-octave Fast Hessian (500 a
    octave), Haar orientation and SURF-64 on the 640x480 left image; then
    the same on the image moved by (4, 6) px."""
    from boofcv_tpu_torch.feature import associate, describe, fasthessian
    from boofcv_tpu_torch.ip import integral
    dy, dx = 4, 6
    tex = scene_pair(0, extra_rows=2 * dy)[3]
    h, w = H, W
    img = torch.from_numpy(tex[dy:dy + h, dx:dx + w].copy()).to(dev)
    moved = torch.from_numpy(tex[:h, :w].copy()).to(dev)   # content +(dy, dx)

    def detdesc(image):
        ii = integral.transform(image)
        det = fasthessian.detect_multi_octave(ii, max_features_per_octave=500,
                                              num_octaves=2)
        ang = describe.orientation_average_haar(ii, det.ys, det.xs,
                                                det.scales)
        return det, describe.surf(ii, det.ys, det.xs, det.scales, ang)

    n = 1000
    # eight box-filter sizes of ~60 operations a pixel, nonmax ~30 a pixel
    # and size; 113 + 400 Haar pairs of ~40 a feature.  The eight response
    # images are each assembled from ~32 shifted copies of the integral
    # image
    flops = 8 * h * w * 90.0 + n * (113 + 400) * 40.0
    (det, desc), _ = _breadth(
        "breadth_surf", f"transform + detect_multi_octave(500, 2) + "
        f"orientation_average_haar + surf {w}x{h}", lambda: detdesc(img), dev,
        bound(h * w * 4 + n * (64 + 5) * 4, flops),
        bound(8 * 32 * 3 * h * w * 4, 0))
    ii = integral.transform(img)
    ang = describe.orientation_average_haar(ii, det.ys, det.xs, det.scales)
    _breadth_stages("breadth_surf", (
        ("transform", lambda: integral.transform(img)),
        ("detect_multi_octave", lambda: fasthessian.detect_multi_octave(
            ii, max_features_per_octave=500, num_octaves=2)),
        ("orientation_average_haar",
         lambda: describe.orientation_average_haar(ii, det.ys, det.xs,
                                                   det.scales)),
        ("surf", lambda: describe.surf(ii, det.ys, det.xs, det.scales,
                                       ang))))
    det2, desc2 = detdesc(moved)
    valid = det.valid.cpu().numpy()
    norms = torch.linalg.vector_norm(desc, dim=1).cpu().numpy()[valid]
    check(desc.shape == (n, 64) and bool(torch.isfinite(desc).all()),
          f"breadth_surf: descriptors shaped {tuple(desc.shape)} or not "
          "finite")
    m = associate.associate_mutual(
        associate.score_euclidean_sq(desc, desc2), det.valid, det2.valid)
    j = m.dst.long()
    hit = (m.valid & ((det2.ys[j] - (det.ys + dy)).abs() <= 1.5)
           & ((det2.xs[j] - (det.xs + dx)).abs() <= 1.5))
    # a feature can be found again only where the moved image still shows it
    inside = det.valid & (det.ys + dy < h - 1) & (det.xs + dx < w - 1)
    n_valid, n_inside = int(valid.sum()), int(inside.sum())
    n_hit = int((hit & inside).sum())
    cpu_ms, (fy, _, _) = _host_ms(lambda: np_surf_detdesc(
        img.cpu().numpy(), max_feats=n))
    print(f"breadth_surf: {n_valid} valid features of {n} slots (bar 300), "
          f"descriptor norms within {float(np.abs(norms - 1).max()):.3e} of "
          f"1 (bar 1e-5); the image moved by ({dy}, {dx}) px: {n_hit} of "
          f"{n_inside} features that stay inside it are matched again by "
          f"associate_mutual within 1.5 px of the moved position "
          f"({n_hit / max(n_inside, 1):.4f}, bar 0.8); numpy SURF on the host "
          f"(a CPU figure): {cpu_ms:.1f} ms for {len(fy)} features")
    check(n_valid >= 300, f"breadth_surf: {n_valid} valid features < 300")
    check(float(np.abs(norms - 1).max()) <= 1e-5,
          "breadth_surf: a valid descriptor is not of unit norm")
    check(n_hit >= 0.8 * n_inside, f"breadth_surf: {n_hit} of {n_inside} "
                                   "features matched again (< 80 %)")


def phase_breadth_assoc(dev) -> None:
    """``breadth_assoc:`` mutual nearest neighbour over 10,000 x 10,000
    descriptors of 64 floats, through the full score matrix and tiled."""
    from boofcv_tpu_torch.feature import associate
    rng = np.random.default_rng(0)
    n = N_ASSOC
    base = rng.normal(0, 1, (n, 64)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    other = base + rng.normal(0, 0.05, base.shape).astype(np.float32)
    a = torch.from_numpy(base).to(dev)
    b = torch.from_numpy(other).to(dev)
    io = 2 * n * 64 * 4 + n * 13      # descriptors in; src, dst, score, valid
    flops = 2.0 * n * n * 64 + 8.0 * n * n
    # the score matrix is written, rewritten by the expansion and the clamp,
    # and read by two argmins and a min
    m, _ = _breadth(
        "breadth_assoc", f"score_euclidean_sq + associate_mutual {n}x{n}x64",
        lambda: associate.associate_mutual(
            associate.score_euclidean_sq(a, b)), dev, bound(io, flops),
        bound(io + 8 * n * n * 4, 0))
    scores = associate.score_euclidean_sq(a, b)
    _breadth_stages("breadth_assoc", (
        ("score_euclidean_sq",
         lambda: associate.score_euclidean_sq(a, b)),
        ("of it the product a @ b.T", lambda: a @ b.T),
        ("associate_mutual", lambda: associate.associate_mutual(scores))))
    del scores
    tile = 2048
    mt, _ = _breadth(
        "breadth_assoc", f"associate_mutual_tiled(tile={tile}) {n}x{n}x64",
        lambda: associate.associate_mutual_tiled(a, b, tile=tile), dev,
        bound(io, flops), bound(io + 8 * n * n * 4, 0))
    same = {k: bool(torch.equal(getattr(m, k), getattr(mt, k)))
            for k in m._fields}
    n_mutual = int(m.valid.sum())
    cpu_ms, (fwd, mutual) = _host_ms(lambda: np_associate(base, other))
    agree = float((m.dst.cpu().numpy() == fwd).mean())
    print(f"breadth_assoc: {n_mutual}/{n} mutual; numpy on the host (a CPU "
          f"figure): {cpu_ms:.1f} ms, {int(mutual.sum())}/{n} mutual (bar: "
          f"within 5), forward matches equal on {agree:.6f} of the rows; "
          f"tiled against full, field by field: {same}")
    check(m.dst.shape == (n,) and bool(torch.isfinite(m.score).all()),
          "breadth_assoc: matches of the wrong shape or not finite")
    check(abs(n_mutual - int(mutual.sum())) <= 5,
          f"breadth_assoc: {n_mutual} mutual against numpy's "
          f"{int(mutual.sum())}")
    check(all(same.values()), f"breadth_assoc: tiled differs from full: "
                              f"{same}")


def phase_breadth_flow(dev) -> None:
    """``breadth_flow:`` single-level Horn-Schunck, 200 iterations, on a
    smooth 640x480 texture moved by (1.5, 2.0) px."""
    from scipy import ndimage as ndi
    from boofcv_tpu_torch.feature import flow
    h, w = H, W
    rng = np.random.default_rng(0)
    base = ndi.gaussian_filter(rng.normal(0, 1, (h + 8, w + 8)), 2.5)
    base = (120 + 60 * base / base.std()).astype(np.float32)
    dy, dx = 1.5, 2.0
    i1_np = base[4:4 + h, 4:4 + w].copy()
    i2_np = ndi.shift(base, (dy, dx), order=1)[4:4 + h, 4:4 + w].astype(
        np.float32)
    i1 = torch.from_numpy(i1_np).to(dev)
    i2 = torch.from_numpy(i2_np).to(dev)
    # ~22 operations a pixel and iteration; an iteration pads u and v, reads
    # eight neighbours of each and writes ~20 intermediate fields
    (u, v), _ = _breadth(
        "breadth_flow", f"horn_schunck {w}x{h}, {HS_ITERATIONS} iterations",
        lambda: flow.horn_schunck(i1, i2, alpha=20.0,
                                  iterations=HS_ITERATIONS), dev,
        bound(4 * h * w * 4, HS_ITERATIONS * h * w * 22.0),
        bound(HS_ITERATIONS * 40.0 * h * w * 4, 0))
    check(u.shape == (h, w) and bool(torch.isfinite(u).all()
                                     and torch.isfinite(v).all()),
          "breadth_flow: flow of the wrong shape or not finite")
    _breadth_stages("breadth_flow", (
        ("the derivative estimates and no iteration",
         lambda: flow.horn_schunck(i1, i2, iterations=0)),
        ("10 iterations more", lambda: flow.horn_schunck(
            i1, i2, iterations=10, init_flow=(u, v)))))
    m = HS_INSET
    c = np.s_[m:-m, m:-m]
    epe = lambda uu, vv: float(np.hypot(uu[c] - dx, vv[c] - dy).mean())
    err = epe(u.cpu().numpy(), v.cpu().numpy())
    cpu_ms, (un, vn) = _host_ms(lambda: np_horn_schunck(
        i1_np, i2_np, iterations=HS_ITERATIONS))
    errn = epe(un, vn)
    print(f"breadth_flow: mean endpoint error {err:.6f} px over the "
          f"{m}-px-inset crop at ({dx}, {dy}); numpy Horn-Schunck on the "
          f"host (a CPU figure, float64): {cpu_ms:.1f} ms, {errn:.6f} px "
          f"(bar: within 0.05 px of it)")
    check(abs(err - errn) <= 0.05, f"breadth_flow: endpoint error {err} px "
                                   f"against the numpy solver's {errn}")


def phase_breadth_cpu_vs_card(dev) -> None:
    """Each breadth module family at the test size on the card against the
    same call on the CPU: census codes, the SGM aggregation and Canny's mask
    exactly; BM, SURF, SIFT, the four flows and the sparse SSD costs to the
    CPU tests' tolerances (block flow's interior, where no sentinel is in a
    window)."""
    from boofcv_tpu_torch.feature import (associate, describe, disparity,
                                          fasthessian, flow)
    from boofcv_tpu_torch.ip import blur, census, integral
    left_np, right_np, _, _ = scene_pair(1, 64, 96, 16)
    left_np, right_np = np.round(left_np), np.round(right_np)
    on = lambda d: (torch.from_numpy(left_np).to(d),
                    torch.from_numpy(right_np).to(d))
    both = lambda fn: (fn(*on("cpu")), fn(*on(dev)))
    out = {}

    c, g = both(lambda l, r: census.dense5x5(l))
    out["census5x5 equal"] = bool(torch.equal(c, g.cpu()))
    c, g = both(lambda l, r: blur.gaussian(l, sigma=1.5))
    out["gaussian blur max |d|"] = float((c - g.cpu()).abs().max())
    ccfg = disparity.DisparityConfig(max_disparity=16, radius_x=0, radius_y=0,
                                     error="census")
    c, g = both(lambda l, r: disparity._aggregate(
        torch.clamp(disparity.cost_volume(l, r, ccfg), max=1e5), 5.0, 60.0,
        8))
    out["sgm 8-path aggregation equal"] = bool(torch.equal(c, g.cpu()))
    c, g = both(lambda l, r: disparity.sgm(l, r, disparity.SgmConfig(
        max_disparity=16)))
    out["sgm map equal"] = bool(torch.equal(c, g.cpu()))
    c, g = both(lambda l, r: disparity.block_match(
        l, r, disparity.DisparityConfig(max_disparity=16)))
    g = g.cpu()
    ok = (c >= 0) & (g >= 0)
    out["bm valid masks agree"] = float(((c >= 0) == (g >= 0)).float().mean())
    out["bm within 0.05 px"] = float(((c - g).abs()[ok] <= 0.05).float()
                                     .mean())

    def surf(l, r):
        ii = integral.transform(l)
        det = fasthessian.detect_multi_octave(ii, 40, 2)
        ang = describe.orientation_average_haar(ii, det.ys, det.xs,
                                                det.scales)
        return det, describe.surf(ii, det.ys, det.xs, det.scales, ang)
    (cd, cs), (gd, gs) = both(surf)
    key = lambda det: torch.stack([det.ys, det.xs, det.scales], 1)[
        det.valid].cpu()
    ck, gk = key(cd), key(gd)
    out["surf features cpu, card"] = (len(ck), len(gk))
    near = torch.cdist(gk, ck).argmin(1)
    out["surf keypoints max |d|"] = float((gk - ck[near]).abs().max())
    out["surf descriptors max |d|"] = float(
        (gs[gd.valid].cpu() - cs[cd.valid][near]).abs().max())
    m = associate.associate_mutual(associate.score_euclidean_sq(cs, cs))
    mg = associate.associate_mutual(associate.score_euclidean_sq(
        cs.to(dev), cs.to(dev)))
    out["associate dst equal"] = bool(torch.equal(m.dst, mg.dst.cpu()))
    (cu, cv), (gu, gv) = both(lambda l, r: flow.horn_schunck(
        l, torch.roll(l, (1, 2), (0, 1)), iterations=20))
    out["horn_schunck max |d| px"] = max(float((cu - gu.cpu()).abs().max()),
                                         float((cv - gv.cpu()).abs().max()))

    # the rest of the breadth surface
    from boofcv_tpu_torch.feature import canny, sift
    c, g = both(lambda l, r: canny.canny(l, 2.0, 8.0))
    out["canny mask equal"] = bool(torch.equal(c, g.cpu()))
    (ck, cd), (gk, gd) = both(lambda l, r: sift.detect_describe(
        l, max_features=60, num_octaves=2))
    key = lambda k: torch.stack([k.ys, k.xs], 1)[k.valid].cpu().double()
    a, b = key(ck), key(gk)
    out["sift keypoints cpu, card"] = (len(a), len(b))
    near = torch.cdist(b, a).argmin(1)
    out["sift keypoints max |d|"] = float((b - a[near]).abs().max())
    same = ((gd[gk.valid].cpu() - cd[ck.valid][near]).abs().amax(1)
            <= 1e-4)
    out["sift descriptors within 1e-4"] = float(same.float().mean())
    moved = lambda l: torch.roll(l, (1, 2), (0, 1))
    flows = {"brox_warping": lambda l, r: flow.brox_warping(
                 l, moved(l), scales=(1, 2), outer_iterations=2,
                 inner_iterations=10),
             "dense_klt": lambda l, r: flow.dense_klt(l, moved(l),
                                                      scales=(1, 2)),
             "block_flow": lambda l, r: flow.block_flow(l, moved(l))}
    inner = np.s_[7:-7, 7:-7]
    for name, fn in flows.items():
        c, g = both(fn)
        d = torch.maximum((c[0] - g[0].cpu()).abs(), (c[1] - g[1].cpu()).abs())
        out[f"{name} share within 1e-4 px"] = float(
            (d[inner] <= 1e-4).float().mean())
    ys = torch.from_numpy(np.random.default_rng(2).integers(0, 64, 100))
    xs = torch.from_numpy(np.random.default_rng(3).integers(0, 96, 100))
    scfg = disparity.DisparityConfig(max_disparity=16, error="ssd")
    c, g = both(lambda l, r: disparity._sparse_costs_ssd(
        l, r, ys.to(l.device), xs.to(l.device), scfg))
    far = c >= 1e17
    out["sparse ssd costs max relative |d|"] = float(
        ((c - g.cpu()).abs() / c.clamp(min=1.0))[~far].max())
    print("breadth_cpu_vs_card: " + " ".join(f"{k}={v}" for k, v in
                                            out.items()))
    check(out["census5x5 equal"] and out["sgm 8-path aggregation equal"]
          and out["sgm map equal"] and out["associate dst equal"],
          "breadth_cpu_vs_card: an integer-valued result differs")
    check(out["gaussian blur max |d|"] <= 1e-3, "breadth_cpu_vs_card: blur")
    check(out["bm valid masks agree"] >= 0.99
          and out["bm within 0.05 px"] >= 0.99, "breadth_cpu_vs_card: BM")
    check(len(ck) == len(gk) and out["surf keypoints max |d|"] <= 1e-3
          and out["surf descriptors max |d|"] <= 1e-4,
          "breadth_cpu_vs_card: SURF")
    check(out["horn_schunck max |d| px"] <= 1e-4,
          "breadth_cpu_vs_card: Horn-Schunck")
    check(out["canny mask equal"], "breadth_cpu_vs_card: Canny")
    check(out["sift keypoints cpu, card"][0] == out[
        "sift keypoints cpu, card"][1] and out["sift keypoints max |d|"]
          <= 1e-3 and out["sift descriptors within 1e-4"] >= 0.9,
          "breadth_cpu_vs_card: SIFT")
    check(all(out[f"{k} share within 1e-4 px"] >= 0.999 for k in flows),
          "breadth_cpu_vs_card: the dense flows")
    check(out["sparse ssd costs max relative |d|"] <= 1e-5,
          "breadth_cpu_vs_card: sparse SSD")


# ---------------------------------------------------------------------------
# the rest of the breadth surface: Canny, SIFT, the other dense flows,
# Zhang99, robust F/E/H, each at the reference breadth benchmark's size
# ---------------------------------------------------------------------------

CANNY_LOW, CANNY_HIGH = 2.0, 8.0
SIFT_FEATURES, SIFT_OCTAVES = 200, 4
N_ROBUST, ROBUST_OUTLIERS, ROBUST_HYPOTHESES = 1000, 0.3, 512
# endpoint-error bars of the three flows at 640x480 (px over the 40-px
# inset): each function's result on the CPU on ``flow_scene(120, 160)``
# (brox 0.168261, dense KLT 0.217964, block flow 0.602648; at 240x320
# 0.052032, 0.227012, 0.567523), rounded up by about a quarter
FLOW_BARS = {"brox_warping": 0.25, "dense_klt": 0.3, "block_flow": 0.75}


def canny_scene(h=None, w=None):
    """The breadth benchmark's Canny image: smoothed Gaussian noise, sigma
    3, scaled to 120 +- 60 (``bench_breadth.bench_canny``, seed 0)."""
    from scipy import ndimage as ndi
    h, w = h or H, w or W
    base = ndi.gaussian_filter(np.random.default_rng(0).normal(0, 1, (h, w)),
                               3.0)
    return (120 + 60 * base / base.std()).astype(np.float32)


def np_canny(img, low, high, radius=2):
    """numpy Canny on the host, float64: the breadth benchmark's
    ``_np_canny`` held to the function it is compared with, which it
    misses twice: its Sobel carries a factor 0.25 (so its thresholds act 4x
    higher) and its blur replicates edges where ``canny``'s Gaussian is
    renormalized over the image.  Here: Gaussian of sigma (2r+1)/6
    renormalized at the borders, Sobel with edge replication, 4-sector
    non-maximum suppression, hysteresis as connected components holding a
    strong pixel."""
    from scipy import ndimage as ndi
    sigma = (2 * radius + 1) / 6.0
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    b = img.astype(np.float64)
    for axis in (1, 0):
        num = ndi.correlate1d(b, k, axis=axis, mode="constant")
        den = ndi.correlate1d(np.ones_like(b), k, axis=axis, mode="constant")
        b = num / den
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float64)
    dx = ndi.correlate(b, kx, mode="nearest")
    dy = ndi.correlate(b, kx.T, mode="nearest")
    inten = np.hypot(dx, dy)
    theta = np.arctan2(dy, dx)
    theta = np.where(theta < 0, theta + np.pi, theta)
    sector = (np.floor((theta + np.pi / 8) / (np.pi / 4)).astype(int)) % 4

    def shift(a, dyy, dxx):
        p = np.pad(a, 1)
        return p[1 + dyy:1 + dyy + a.shape[0], 1 + dxx:1 + dxx + a.shape[1]]

    pairs = [((0, -1), (0, 1)), ((-1, -1), (1, 1)),
             ((-1, 0), (1, 0)), ((-1, 1), (1, -1))]
    keep = np.zeros(img.shape, bool)
    for s, (a, c) in enumerate(pairs):
        keep |= (sector == s) & (inten > shift(inten, *a)) & (
            inten >= shift(inten, *c))
    nms = np.where(keep, inten, 0.0)
    lab, nlab = ndi.label(nms >= low, structure=np.ones((3, 3), bool))
    good = np.zeros(nlab + 1, bool)
    good[np.unique(lab[nms >= high])] = True
    good[0] = False
    return good[lab]


def phase_breadth_canny(dev) -> None:
    """``breadth_canny:`` Canny (blur, Sobel, NMS, hysteresis) on the
    640x480 image, the hysteresis trips and syncs, and the host chain
    finisher."""
    from boofcv_tpu_torch.feature import canny
    img_np = canny_scene()
    img = torch.from_numpy(img_np).to(dev)
    h, w = img_np.shape
    nms = canny._nms(img, -1.0, 2)
    (mask, trips), syncs = _count_sync_warnings(
        lambda: canny._hysteresis(nms, CANNY_LOW, CANNY_HIGH))
    sweeps = canny.HYSTERESIS_SWEEPS * trips + 1
    # blur 20, Sobel 12, norm and direction 25, NMS 12 an element; a sweep
    # is a 3x3 max and a product (10)
    flops = h * w * (20 + 12 + 25 + 12 + 10.0 * sweeps)
    out, _ = _breadth(
        "breadth_canny", f"canny {w}x{h} low {CANNY_LOW} high {CANNY_HIGH}",
        lambda: canny.canny(img, CANNY_LOW, CANNY_HIGH), dev,
        bound(h * w * 5, flops),
        bound(h * w * 4 * (30 + 3 * sweeps), 0), allow_syncs=True)
    check(torch.equal(out, mask), "breadth_canny: canny() differs from its "
                                  "own stages")
    _breadth_stages("breadth_canny", (
        ("blur, Sobel, direction, NMS", lambda: canny._nms(img, -1.0, 2)),
        ("hysteresis", lambda: canny._hysteresis(nms, CANNY_LOW,
                                                 CANNY_HIGH))))
    mask_np = mask.cpu().numpy() > 0
    host_ms, chains = _host_ms(lambda: canny.edge_contours(mask_np))
    cpu_ms, ref = _host_ms(lambda: np_canny(img_np, CANNY_LOW, CANNY_HIGH))
    agree = float((mask_np == ref).mean())
    print(f"breadth_canny: hysteresis {trips} trips of "
          f"{canny.HYSTERESIS_SWEEPS} sweeps, {sum(syncs.values())} host "
          f"syncs {dict(sorted(syncs.items()))}; {int(mask_np.sum())} edge px; "
          f"edge_contours on the host {host_ms:.1f} ms, {len(chains)} chains; "
          f"numpy Canny on the host (a CPU figure, float64) {cpu_ms:.1f} ms, "
          f"{int(ref.sum())} edge px, pixels agreeing {agree:.6f} (bar "
          f"0.999)")
    check(sum(syncs.values()) == trips + 1,
          f"breadth_canny: {sum(syncs.values())} syncs for {trips} trips")
    # the benchmark's thresholds keep every NMS pixel (all are above 8 on
    # the unscaled Sobel); thresholds on the intensity's own scale make the
    # fixpoint loop work
    (_, trips_wide), syncs_wide = _count_sync_warnings(
        lambda: canny._hysteresis(nms, 10 * CANNY_LOW, 10 * CANNY_HIGH))
    print(f"breadth_canny: at low {10 * CANNY_LOW} high {10 * CANNY_HIGH}: "
          f"{trips_wide} trips, {sum(syncs_wide.values())} host syncs")
    check(sum(len(c) for c in chains) == int(mask_np.sum()),
          "breadth_canny: the chains do not cover the mask")
    check(agree >= 0.999, f"breadth_canny: {agree} of the pixels agree with "
                          "the numpy Canny")


def phase_breadth_sift(dev) -> None:
    """``breadth_sift:`` SIFT detect + describe (200 an octave, 4 octaves)
    on the 640x480 left image of the stereo scene and on it moved by (4, 6)
    px."""
    from boofcv_tpu_torch.core.kernel import gaussian_radius_for_sigma
    from boofcv_tpu_torch.feature import associate, sift
    dy, dx = 4, 6
    tex = scene_pair(0, extra_rows=2 * dy)[3]
    h, w = H, W
    img = torch.from_numpy(tex[dy:dy + h, dx:dx + w].copy()).to(dev)
    moved = torch.from_numpy(tex[:h, :w].copy()).to(dev)  # content +(dy, dx)
    n = SIFT_FEATURES * SIFT_OCTAVES
    run = lambda image: sift.detect_describe(
        image, max_features=SIFT_FEATURES, num_octaves=SIFT_OCTAVES)
    # 6 Gaussian levels of ~2x9 taps (2 operations each) and the DoG
    # extrema (~60) an element over the 4/3 of the image all octaves hold;
    # 289 + 256 samples of ~40 operations a keypoint
    flops = 4 / 3 * h * w * (6 * 36 + 60.0) + n * (289 + 256) * 40.0
    (kp, desc), _ = _breadth(
        "breadth_sift", f"detect_describe {w}x{h} max_features "
        f"{SIFT_FEATURES} num_octaves {SIFT_OCTAVES}", lambda: run(img), dev,
        bound(h * w * 4 + n * (5 * 4 + 128 * 4), flops),
        bound(4 / 3 * h * w * 4 * 6 * 40, 0))
    base = img
    stack, sigmas = sift.gaussian_scale_stack(base)
    incs = [sigmas[0]] + [float(np.sqrt(max(b * b - a * a, 1e-6)))
                          for a, b in zip(sigmas[:-1], sigmas[1:])]
    stack_taps = [2 * gaussian_radius_for_sigma(s) + 1 for s in incs]
    kp0 = sift._detect_from_stack(stack, sigmas, SIFT_FEATURES, 1.0, 10.0, 8)
    ang0 = sift.orientation_histogram(stack[0], kp0.ys, kp0.xs, kp0.sigmas)
    _breadth_stages("breadth_sift", (
        ("gaussian_scale_stack octave 0", lambda: sift.gaussian_scale_stack(
            base)),
        ("_detect_from_stack octave 0", lambda: sift._detect_from_stack(
            stack, sigmas, SIFT_FEATURES, 1.0, 10.0, 8)),
        ("orientation_histogram octave 0", lambda: sift.orientation_histogram(
            stack[0], kp0.ys, kp0.xs, kp0.sigmas)),
        ("describe octave 0", lambda: sift.describe(
            stack[0], kp0.ys, kp0.xs, kp0.sigmas, ang0))))
    kp2, desc2 = run(moved)
    valid = kp.valid.cpu().numpy()
    norms = torch.linalg.vector_norm(desc, dim=1).cpu().numpy()[valid]
    check(desc.shape == (n, 128) and bool(torch.isfinite(desc).all()),
          f"breadth_sift: descriptors shaped {tuple(desc.shape)} or not "
          "finite")
    pos = lambda k: torch.stack([k.ys, k.xs], 1).double()
    p1, p2 = pos(kp), pos(kp2)
    target = p1 + torch.tensor([dy, dx], dtype=torch.float64, device=dev)
    d = torch.cdist(target, p2[kp2.valid])
    again = (d.amin(1) <= 1.5) if d.shape[1] else torch.zeros_like(kp.valid)
    inside = (kp.valid & (target[:, 0] < h - 1 - 8)
              & (target[:, 1] < w - 1 - 8))
    n_inside = int(inside.sum())
    n_again = int((again & inside).sum())
    m = associate.associate_mutual(associate.score_euclidean_sq(desc, desc2),
                                   kp.valid, kp2.valid)
    j = m.dst.long()
    matched = m.valid & ((p2[j] - target).abs().amax(1) <= 1.5) & inside
    print(f"breadth_sift: {int(valid.sum())} valid keypoints of {n} slots; "
          f"descriptor norms within {float(np.abs(norms - 1).max()):.3e} of 1 "
          f"after the 0.2 clip (bar 1e-5); the image moved by ({dy}, {dx}) "
          f"px: {n_again} of {n_inside} keypoints that stay inside are "
          f"detected again within 1.5 px ({n_again / max(n_inside, 1):.4f}, "
          f"bar 0.6), {int(matched.sum())} of them also matched by "
          f"associate_mutual; the Gaussian stack of an octave blurs with "
          f"{stack_taps} taps (two launches a tap a pass in "
          f"ip/convolve._conv2d_valid)")
    check(int(valid.sum()) >= 100, "breadth_sift: fewer than 100 keypoints")
    check(float(np.abs(norms - 1).max()) <= 1e-5,
          "breadth_sift: a valid descriptor is not of unit norm")
    check(n_again >= 0.6 * n_inside, f"breadth_sift: {n_again} of "
                                     f"{n_inside} keypoints found again")


def flow_scene(h=None, w=None, dy=1.5, dx=2.0):
    """The breadth benchmark's flow pair: smoothed noise (sigma 2.5, 120 +-
    60, seed 0) and the same moved by (dy, dx) px (linear interpolation)."""
    from scipy import ndimage as ndi
    h, w = h or H, w or W
    base = ndi.gaussian_filter(
        np.random.default_rng(0).normal(0, 1, (h + 8, w + 8)), 2.5)
    base = (120 + 60 * base / base.std()).astype(np.float32)
    i1 = base[4:4 + h, 4:4 + w].copy()
    i2 = ndi.shift(base, (dy, dx), order=1)[4:4 + h, 4:4 + w].astype(
        np.float32)
    return i1, i2


def phase_breadth_flow2(dev) -> None:
    """``breadth_flow2:`` Brox warping, dense KLT and block flow on the
    640x480 flow scene moved by (1.5, 2.0) px, each with its endpoint error
    over the 40-px inset."""
    from boofcv_tpu_torch.feature import flow
    h, w = H, W
    dy, dx = 1.5, 2.0
    i1_np, i2_np = flow_scene(h, w, dy, dx)
    i1 = torch.from_numpy(i1_np).to(dev)
    i2 = torch.from_numpy(i2_np).to(dev)
    c = np.s_[HS_INSET:-HS_INSET, HS_INSET:-HS_INSET]
    px = 4 / 3 * h * w                       # pixels over the pyramid
    runs = (
        ("brox_warping", "brox_warping scales (1, 2, 4, 8), 5 outer x 50 "
         "inner", lambda: flow.brox_warping(i1, i2), 250 * 150.0 * px, True),
        ("dense_klt", "dense_klt radius 3 scales (1, 2, 4), 10 iterations",
         lambda: flow.dense_klt(i1, i2), 10 * 60.0 * px, False),
        ("block_flow", "block_flow search 4 region 3",
         lambda: flow.block_flow(i1, i2), 81 * 14.0 * h * w, False))
    for name, what, fn, flops, long_call in runs:
        out, _ = _breadth("breadth_flow2", f"{what} {w}x{h}", fn, dev,
                          bound(h * w * 4 * 5, flops),
                          bound(flops / 2 * 4, 0), long_call=long_call)
        u, v = (t.cpu().numpy() for t in out[:2])
        check(u.shape == (h, w) and bool(np.isfinite(u).all()
                                         and np.isfinite(v).all()),
              f"breadth_flow2: {name} of the wrong shape or not finite")
        epe = float(np.hypot(u[c] - dx, v[c] - dy).mean())
        print(f"breadth_flow2: {name} mean endpoint error {epe:.6f} px over "
              f"the {HS_INSET}-px inset at ({dx}, {dy}) (bar "
              f"{FLOW_BARS[name]}, from its CPU result at 120x160)")
        check(epe <= FLOW_BARS[name], f"breadth_flow2: {name} endpoint error "
                                      f"{epe} > {FLOW_BARS[name]}")


def zhang_scene(n_views=12, nx=8, ny=6, noise=0.3, seed=0):
    """The breadth benchmark's calibration scene (``_zhang_scene``): an 8x6
    grid of 3 cm squares seen by 12 views of a Brown camera (fx 520, fy
    515, k1 -0.25, k2 0.08), 0.3 px noise."""
    rng = np.random.default_rng(seed)
    world = np.stack(np.meshgrid(np.arange(nx) * 0.03,
                                 np.arange(ny) * 0.03), -1).reshape(-1, 2)
    Kc = np.array([[520.0, 0, 320.0], [0, 515.0, 240.0], [0, 0, 1.0]])
    k1, k2 = -0.25, 0.08
    obs = []
    for _ in range(n_views):
        wv = rng.uniform(-0.5, 0.5, 3)
        wv[2] = rng.uniform(-0.3, 0.3)
        th = np.linalg.norm(wv)
        kx = np.array([[0, -wv[2], wv[1]], [wv[2], 0, -wv[0]],
                       [-wv[1], wv[0], 0]]) / max(th, 1e-12)
        R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
        t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.08, 0.08),
                      rng.uniform(0.5, 0.9)])
        Xc = np.c_[world, np.zeros(len(world))] @ R.T + t
        xn = Xc[:, :2] / Xc[:, 2:]
        r2 = (xn ** 2).sum(1)
        xd = xn * (1 + k1 * r2 + k2 * r2 * r2)[:, None]
        px = xd @ Kc[:2, :2].T + Kc[:2, 2]
        obs.append(px + rng.normal(0, noise, px.shape))
    return world, np.stack(obs), Kc


def np_zhang99(world, obs, iterations=20):
    """The breadth benchmark's numpy Zhang99 (``_np_zhang99``): per-view DLT
    homographies, linear K, extrinsics, then damped GN with
    forward-difference Jacobians.  Returns (params, rmse).  One line
    differs: the skew column of J is zeroed before the solve.  The
    benchmark's copy solves with skew free and then zeroes its step, a step
    the normal equations did not choose; it stalls 0.3 % in fx from the
    minimum (rmse 0.401802 px at 20, 40 and 80 iterations against 0.401778
    here and in ``calibrate_mono_planar``)."""
    V, N, _ = obs.shape

    def homography(src, dst):
        A = []
        for (x, y), (u, v) in zip(src, dst):
            A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
            A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
        _, _, vt = np.linalg.svd(np.asarray(A))
        Hm = vt[-1].reshape(3, 3)
        return Hm / Hm[2, 2]

    Hs = np.stack([homography(world, obs[v]) for v in range(V)])

    def vij(Hv, i, j):
        return np.array([
            Hv[0, i] * Hv[0, j],
            Hv[0, i] * Hv[1, j] + Hv[1, i] * Hv[0, j],
            Hv[1, i] * Hv[1, j],
            Hv[2, i] * Hv[0, j] + Hv[0, i] * Hv[2, j],
            Hv[2, i] * Hv[1, j] + Hv[1, i] * Hv[2, j],
            Hv[2, i] * Hv[2, j]])

    Vm = []
    for v in range(V):
        Vm.append(vij(Hs[v], 0, 1))
        Vm.append(vij(Hs[v], 0, 0) - vij(Hs[v], 1, 1))
    _, _, vt = np.linalg.svd(np.asarray(Vm))
    b11, b12, b22, b13, b23, b33 = vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    Kl = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    Kinv = np.linalg.inv(Kl)
    params = [fx, fy, 0.0, cx, cy, 0.0, 0.0]
    for v in range(V):
        h1, h2, h3 = (Kinv @ Hs[v]).T
        s = 1.0 / np.linalg.norm(h1)
        r1, r2 = s * h1, s * h2
        r3 = np.cross(r1, r2)
        R = np.stack([r1, r2, r3], 1)
        u, _, vtv = np.linalg.svd(R)
        R = u @ vtv
        t = s * h3
        ang = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
        if ang < 1e-9:
            wv = np.zeros(3)
        else:
            wv = ang / (2 * np.sin(ang)) * np.array(
                [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        params.extend(list(wv) + list(t))
    p = np.asarray(params)
    w3 = np.c_[world, np.zeros(len(world))]

    def residual(p):
        fx, fy, sk, cx, cy, k1, k2 = p[:7]
        out = np.empty((V, N, 2))
        for v in range(V):
            wv = p[7 + 6 * v:10 + 6 * v]
            t = p[10 + 6 * v:13 + 6 * v]
            th = np.linalg.norm(wv)
            if th < 1e-12:
                R = np.eye(3)
            else:
                kx = np.array([[0, -wv[2], wv[1]], [wv[2], 0, -wv[0]],
                               [-wv[1], wv[0], 0]]) / th
                R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
            Xc = w3 @ R.T + t
            xn = Xc[:, :2] / Xc[:, 2:]
            r2 = (xn ** 2).sum(1)
            d = 1 + k1 * r2 + k2 * r2 * r2
            xd = xn * d[:, None]
            out[v, :, 0] = fx * xd[:, 0] + sk * xd[:, 1] + cx
            out[v, :, 1] = fy * xd[:, 1] + cy
        return (out - obs).ravel()

    lam = 1e-3
    r = residual(p)
    c0 = r @ r
    n_par = len(p)
    for _ in range(iterations):
        J = np.empty((len(r), n_par))
        for i in range(n_par):
            dp = np.zeros(n_par)
            dp[i] = 1e-6 * max(1.0, abs(p[i]))
            J[:, i] = (residual(p + dp) - r) / dp[i]
        J[:, 2] = 0.0                       # zero skew
        Hm = J.T @ J
        g = J.T @ r
        try:
            step = np.linalg.solve(Hm + lam * np.eye(n_par), -g)
        except np.linalg.LinAlgError:
            lam *= 10
            continue
        step[2] = 0.0                       # zero skew
        p_new = p + step
        r_new = residual(p_new)
        c1 = r_new @ r_new
        if np.isfinite(c1) and c1 < c0:
            p, r, c0 = p_new, r_new, c1
            lam = max(lam * 0.3, 1e-10)
        else:
            lam = min(lam * 10, 1e6)
    return p, np.sqrt(c0 / (V * N))


def phase_breadth_zhang99(dev) -> None:
    """``breadth_zhang99:`` ``calibrate_mono_planar(iterations=20)`` on the
    12-view scene against the numpy Zhang99 on the host."""
    from boofcv_tpu_torch.calib import zhang99
    world, obs, K_gt = zhang_scene()
    V, N = obs.shape[:2]
    # per iteration: projection and Jacobians (~300 operations a corner),
    # the normal blocks (13 x 13 products a corner), the Schur reduction
    flops = 20 * V * N * (300 + 2 * 13 * 13.0)
    res, _ = _breadth(
        "breadth_zhang99", f"calibrate_mono_planar {V} views x {N} corners, "
        f"20 iterations (the closed form on the host)",
        lambda: zhang99.calibrate_mono_planar(world, obs, iterations=20,
                                              device=dev), dev,
        bound(obs.nbytes + world.nbytes + (9 + 2 + 12 * V) * 8, flops),
        bound(20 * V * N * 13 * 2 * 8 * 8, 0), allow_syncs=True)
    cpu_ms, (p, rmse) = _host_ms(lambda: np_zhang99(world, obs, 20))
    got = np.array([res.K[0, 0], res.K[1, 1], res.K[0, 2], res.K[1, 2]])
    want = np.array([p[0], p[1], p[3], p[4]])
    rel = np.abs(got / want - 1)
    print(f"breadth_zhang99: fx fy cx cy {got.round(4).tolist()} against the "
          f"numpy Zhang99's {want.round(4).tolist()} (relative "
          f"{rel.max():.3e}, bar 1e-3); truth {[520.0, 515.0, 320.0, 240.0]}; "
          f"radial {[round(k, 5) for k in res.radial]}; reprojection RMSE "
          f"{res.reprojection_rmse:.6f} px (numpy {rmse:.6f}); numpy on the "
          f"host (a CPU figure) {cpu_ms:.1f} ms")
    check(bool(np.isfinite(got).all()) and rel.max() <= 1e-3,
          f"breadth_zhang99: K {got} against numpy's {want}")


def robust_scene(n, outliers, planar, seed=0):
    """n correspondences between two views of a camera (f 500, 640x480)
    moved 0.6 sideways, 0.3 px noise, ``outliers`` of them replaced by
    points drawn anywhere in the image.  Returns pixels (p1, p2), the
    normalized coordinates and the true-inlier mask.  An outlier lands
    within 1 px of its epipolar line (and is an inlier of the true F) with
    probability about 0.5 %: 300 of them hold 1-2 such on average (seed 0:
    3, seed 1: 0-1 on the CPU), beside the 1 % bar's 3."""
    rng = np.random.default_rng(seed)
    Kc = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    depth = 6.0 + (np.zeros(n) if planar else rng.uniform(0, 6, n))
    X = np.c_[rng.uniform(-2.5, 2.5, n), rng.uniform(-1.8, 1.8, n), depth]
    wv = np.array([0.02, -0.05, 0.01])
    th = np.linalg.norm(wv)
    kx = np.array([[0, -wv[2], wv[1]], [wv[2], 0, -wv[0]],
                   [-wv[1], wv[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
    X2 = X @ R.T + np.array([0.6, 0.05, 0.1])
    n1 = X[:, :2] / X[:, 2:]
    n2 = X2[:, :2] / X2[:, 2:]
    pix = lambda q: q @ Kc[:2, :2].T + Kc[:2, 2]
    p1 = pix(n1) + rng.normal(0, 0.3, (n, 2))
    p2 = pix(n2) + rng.normal(0, 0.3, (n, 2))
    bad = rng.permutation(n) < int(outliers * n)
    p2[bad] = rng.uniform([0, 0], [640, 480], (int(bad.sum()), 2))
    unpix = lambda q: (q - Kc[:2, 2]) / Kc[0, 0]
    return p1, p2, unpix(p1), unpix(p2), ~bad


def phase_geo_robust(dev) -> None:
    """``geo_robust:`` RANSAC for F (7-point, LO refits), E (Nister 5-point)
    and H (4-point DLT) over 1,000 correspondences with 30 % outliers and
    512 hypotheses each."""
    from boofcv_tpu_torch.geo import robust
    n, K_h = N_ROBUST, ROBUST_HYPOTHESES
    g = torch.Generator(device=dev)
    cases = (
        ("ransac_fundamental", False, 7, 3,
         lambda p1, p2, q1, q2: robust.ransac_fundamental(
             g.manual_seed(1), p1, p2, num_hypotheses=K_h)),
        ("ransac_essential nister5", False, 5, 10,
         lambda p1, p2, q1, q2: robust.ransac_essential(
             g.manual_seed(2), q1, q2, num_hypotheses=K_h,
             inlier_threshold=(1.0 / 500.0) ** 2)),
        ("ransac_homography", True, 4, 1,
         lambda p1, p2, q1, q2: robust.ransac_homography(
             g.manual_seed(3), p1, p2, num_hypotheses=K_h)))
    for name, planar, size, sols, fn in cases:
        p1, p2, q1, q2, good = robust_scene(n, ROBUST_OUTLIERS, planar,
                                            seed=1)
        args = [torch.from_numpy(a).to(dev) for a in (p1, p2, q1, q2)]
        # a minimal solve of ~2,000 operations (Nister ~60,000 with its 120
        # Durand-Kerner iterations) and 40 a residual of every solution
        solve = 60000.0 if sols == 10 else 2000.0
        res, _ = _breadth(
            "geo_robust", f"{name} {n} points {int(ROBUST_OUTLIERS * 100)} % "
            f"outliers {K_h} hypotheses", lambda: fn(*args), dev,
            bound(n * 4 * 8 + n, K_h * (solve + sols * n * 40.0)),
            bound(K_h * sols * n * 8 * 4, 0), allow_syncs=True)
        kept = res.inliers.cpu().numpy()
        inl = float(kept[good].mean())
        out = float(kept[~good].mean())
        print(f"geo_robust: {name}: {int(kept.sum())} inliers; true inliers "
              f"kept {inl:.4f} (bar 0.95), outliers accepted {out:.4f} (bar "
              f"0.01)")
        check(inl >= 0.95 and out <= 0.01, f"geo_robust: {name} kept "
                                           f"{inl} of the inliers, {out} "
                                           "of the outliers")
    # Nister's degree-10 polynomial roots, as one RANSAC call solves them
    from boofcv_tpu_torch.geo import smalllinalg
    coeffs = torch.randn((K_h, 11), generator=g.manual_seed(4), device=dev,
                         dtype=torch.float64)
    _breadth_stages("geo_robust", (
        (f"poly_roots [{K_h}, 11], 120 Durand-Kerner iterations",
         lambda: smalllinalg.poly_roots(coeffs)),))


def phase_sparse_ssd(dev) -> dict:
    """The sparse matcher with ``error="ssd"`` at the main path's shape (512
    points on the 640x480 pair, 96 disparities, radius 3): the window-gather
    kernel's launches on that path (its windows are the SAD's, held bit-equal
    to the plain gather in phase 3), and the costs against the same costs
    on the CPU (the plain gather).  Returns the launches."""
    from boofcv_tpu_torch.feature import disparity
    from boofcv_tpu_torch.kernels import window_gather as wg
    left_np, right_np, gt, _ = scene_pair(0)
    rng = np.random.default_rng(3)
    ys = rng.integers(0, H, 512).astype(np.int32)
    xs = rng.integers(DMAX, W, 512).astype(np.int32)
    cfg = disparity.DisparityConfig(max_disparity=DMAX, radius_x=3,
                                    radius_y=3, error="ssd",
                                    texture_threshold=0.0)
    args = [torch.from_numpy(a) for a in (left_np, right_np, ys, xs)]
    on_card = [a.to(dev) for a in args]
    torch.cuda.synchronize()
    wg.reset_launch_count()
    d, v = disparity.sparse_block_match(*on_card, cfg)
    torch.cuda.synchronize()
    launches = {"window_gather": wg.launch_count()}
    costs_card = disparity._sparse_costs_ssd(*on_card, cfg).cpu()
    costs_cpu = disparity._sparse_costs_ssd(*args, cfg)
    near = costs_cpu < 1e17
    rel = float(((costs_card - costs_cpu).abs() / costs_cpu.clamp(min=1.0))
                [near].max())
    err = float(np.median(np.abs(d.cpu().numpy() - gt[ys, xs])[
        v.cpu().numpy()]))
    print(f"sparse_ssd: sparse_block_match(error='ssd') {len(ys)} points "
          f"D={DMAX} radius 3: window_gather launched "
          f"{launches['window_gather']} times; costs on the card against the "
          f"CPU's (plain gather) within {rel:.3e} relative (bar 1e-5); "
          f"{int(v.sum())} valid, median error {err:.4f} px against the "
          f"plane (bar 0.5)")
    check(launches["window_gather"] == 2,
          f"sparse_ssd: {launches['window_gather']} gathers, not 2")
    check(rel <= 1e-5 and err <= 0.5, "sparse_ssd: costs or disparities off")
    return launches


# ---- the other odometry families and 2-D motion ---------------------------

FAMILY_FRAMES = 17   # the first frame, 2 warm-up, 12 timed, 1 counted, 1 traced
FAMILY_TRACKS = 300  # mono-plane, overhead and stitcher tracks


def plane_depths(poses, k, h, w, origin=(0.0, 0.0, 8.0),
                 plane_x=(1.0, 0.0, 0.0), plane_y=(0.0, 1.0, -0.15)):
    """[h, w] float32 depth of each world->camera pose's view of the
    textured plane of ``_scene`` (its left images are the gray frames): the
    ray-plane intersection's z in the camera frame, 0 where the ray misses."""
    o = np.asarray(origin)
    n = np.cross(plane_x, plane_y)
    n = n / np.linalg.norm(n)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(k).T
    out = []
    for R, t in poses:
        c0 = -R.T @ t
        d_w = rays @ R
        denom = d_w @ n
        s = ((o - c0) @ n) / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        Xc = (c0 + s[..., None] * d_w) @ R.T + t
        out.append(np.where(s > 0, Xc[..., 2], 0.0).astype(np.float32))
    return out


def mono_plane_scene(k, h, w, n_frames, seed=0):
    """A camera translating parallel to a textured plane 4 m ahead (normal
    +z in the camera frame; ``tests/test_mono_plane_vo.py``'s scene at
    this width): (poses, frames)."""
    from boofcv_tpu_torch.io import simulate
    tex = simulate.noise_texture(np.random.default_rng(seed), size=1024)
    poses = [(np.eye(3), -np.array([0.06 * i, 0.02 * i, 0.0]))
             for i in range(n_frames)]
    frames = [simulate.render_plane(
        tex, k, R, t, h, w, plane_origin=(0.0, 0.0, 4.0),
        plane_x=(1.0, 0.0, 0.0), plane_y=(0.0, 1.0, 0.0),
        texture_scale=120.0) for R, t in poses]
    return poses, frames


OVERHEAD_HEIGHT, OVERHEAD_PITCH, OVERHEAD_STEP = 1.5, 0.6, 0.08


def overhead_scene(k, h, w, n_frames, seed=5):
    """A camera 1.5 m above a textured ground plane, pitched down 0.6 rad,
    moving forward 0.08 m a frame (``tests/test_vo_variants.py``'s overhead
    scene at this width): (R_pc, t_pc, frames)."""
    from boofcv_tpu_torch.io import simulate
    tex = simulate.noise_texture(np.random.default_rng(seed), size=1024)
    c_, s_ = np.cos(OVERHEAD_PITCH), np.sin(OVERHEAD_PITCH)
    Rp = np.array([[1.0, 0, 0], [0, c_, -s_], [0, s_, c_]])
    frames = [simulate.render_plane(
        tex, k, Rp, -Rp @ np.array([0.0, 0.0, OVERHEAD_STEP * i]), h, w,
        plane_origin=(0.0, OVERHEAD_HEIGHT, 0.0), plane_x=(1.0, 0.0, 0.0),
        plane_y=(0.0, 0.0, 1.0), texture_scale=60.0)
        for i in range(n_frames)]
    return Rp, Rp @ np.array([0.0, OVERHEAD_HEIGHT, 0.0]), frames


def sliding_frames(h, w, n_frames, dy, dx, seed, margin=20):
    """(texture, frames): [h, w] windows of a 1024x1024 noise texture, the
    window moving by (dy, dx) px a frame (the content by -(dy, dx))."""
    from boofcv_tpu_torch.io import simulate
    big = simulate.noise_texture(np.random.default_rng(seed), size=1024)
    return big, [big[margin + dy * i:margin + dy * i + h,
                     margin + dx * i:margin + dx * i + w].copy()
                 for i in range(n_frames)]


KLT_FAMILY_ERR = {}   # family path -> its klt_track check's position gap
KLT_FAMILY_CALLS = {}  # family path -> one frame's track_pyramid inputs
GN_FAMILY_ERR = {}    # family path -> its gn_pose check's largest R/t gap


def _capture_klt(fn) -> list:
    """Run ``fn()`` with ``klt.track_pyramid`` wrapped to keep the inputs of
    each call: [(pyramid, templates, ys, xs, scales, cfg), ...]."""
    from boofcv_tpu_torch.feature import klt
    calls, inner = [], klt.track_pyramid

    def recording(pyramid, templates, ys, xs, scales, cfg):
        calls.append((pyramid, templates, ys, xs, scales, cfg))
        return inner(pyramid, templates, ys, xs, scales, cfg)
    klt.track_pyramid = recording
    try:
        fn()
    finally:
        klt.track_pyramid = inner
    return calls


def _klt_family_check(path: str, calls) -> float:
    """Each ``track_pyramid`` call of one family frame, at the family's own
    shapes (levels, tracks, image, radius, iteration cap), through the
    kernel and the plain version on the card, held to
    :func:`phase_klt_kernel`'s limits: fault codes equal on 99 % of the
    tracks, the tracks both keep within 2e-3 px.  Returns the largest
    gap."""
    from boofcv_tpu_torch.feature import klt
    check(len(calls) > 0, f"{path}: no track_pyramid call to check")
    worst = 0.0
    for j, (pyr, tm, ys, xs, scales, cfg) in enumerate(calls):
        n = ys.numel()
        gy, gx, gf = klt.track_pyramid(pyr, tm, ys, xs, scales, cfg)
        wy_, wx_, wf = klt.track_pyramid_reference(pyr, tm, ys, xs, scales,
                                                   cfg)
        same = int((gf == wf).sum())
        both = (gf == klt.TRACK_OK) & (wf == klt.TRACK_OK)
        gap = float(torch.maximum((gy - wy_).abs(), (gx - wx_).abs())[both]
                    .max()) if bool(both.any()) else 0.0
        print(f"kernel: klt_track {path} call {j}: n={n} levels="
              f"{len(scales)} image={tuple(pyr[0].shape[-2:])} radius="
              f"{cfg.template_radius} max_iterations={cfg.max_iterations} "
              f"faults_equal={same}/{n} both_ok={int(both.sum())} "
              f"max_abs_err={gap:.3e} (limits 99 %, 2e-3 px)")
        check(bool(torch.isfinite(gy).all() and torch.isfinite(gx).all()),
              f"klt_track {path} call {j}: non-finite position")
        check(same >= 0.99 * n, f"klt_track {path} call {j}: fault codes "
              f"equal on {same} of {n} tracks (< 99 %)")
        check(bool(both.any()), f"klt_track {path} call {j}: no track OK")
        check(gap <= 2e-3, f"klt_track {path} call {j}: positions differ "
              f"by {gap} px")
        worst = max(worst, gap)
    return worst


def _family(tag: str, what: str, dev, process, accuracy, kernels=(),
            n_frames: int = FAMILY_FRAMES) -> dict:
    """Drive one family's frames through ``process(i)`` on the card and print
    its line.  Frames 0 .. n-3 are the counted run: the first, 2 warm-up
    and the timed ones (frames/s from the median host wall ms of the timed
    frames, a synchronize after each), with the hand kernels' launches
    counted from 0 and the peak memory; then ``accuracy()`` -> (text, ok);
    frame n-2 with sync warnings on (host syncs by call site), its
    ``track_pyramid`` inputs kept for :func:`_klt_family_check` where the
    path runs ``klt_track`` and its refine's inputs for :func:`_gn_check`
    where it runs ``gn_pose``; frame n-1 under the profiler (kernels, device
    busy ms, and the idle share of the median frame).  Fails if the bar is
    missed, a kernel in ``kernels`` did not launch or a kernel check
    fails; returns those kernels' launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    wall = []
    for i in range(n_frames - 2):
        t0 = time.perf_counter()
        process(i)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
    launches = _launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    text, ok = accuracy()
    calls, refines = [], []
    _, syncs = _count_sync_warnings(lambda: refines.extend(_capture_refine(
        lambda: calls.extend(_capture_klt(lambda: process(n_frames - 2))))))
    torch.cuda.synchronize()
    events, _ = _trace(lambda: process(n_frames - 1))
    timed = wall[3:]
    med = float(np.median(timed))
    busy = sum(e.device_time for e in events) / 1e3
    print(f"{tag}: {what}: frames/s={1e3 / med:.3f} (median of "
          f"{len(timed)} frames after the first and 2 warm-up; ms median="
          f"{med:.3f} p90={np.percentile(timed, 90):.3f} first={wall[0]:.3f})"
          f"; launches in {n_frames - 2} frames: klt_track="
          f"{launches['klt_track']} window_gather={launches['window_gather']}"
          f" gn_pose={launches['gn_pose']} pnp_bank={launches['pnp_bank']}"
          f"; one profiled frame: {len(events)} kernels, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / med:.4f} of the median "
          f"frame; host syncs a frame={sum(syncs.values())} "
          f"{dict(sorted(syncs.items()))}; peak device memory MiB="
          f"{peak:.1f}; accuracy: {text}")
    check(ok, f"{tag}: accuracy bar missed: {text}")
    for name in kernels:
        check(launches[name] > 0, f"{tag}: {name} did not launch")
    if "klt_track" in kernels:
        path = f"{tag} {what.split()[0]}"
        KLT_FAMILY_ERR[path] = _klt_family_check(path, calls)
        KLT_FAMILY_CALLS[path] = calls
    if "gn_pose" in kernels:
        path = f"{tag} {what.split()[0]}"
        GN_FAMILY_ERR[path], n, _ = _gn_check(path, refines)
        print(f"kernel: gn_pose {path}: {n} refine calls of frame "
              f"{n_frames - 2} against the plain route, step_tol 1e-6 and 0:"
              f" max_abs_err={GN_FAMILY_ERR[path]:.3e} (limit 1e-5)")
    return {name: launches[name] for name in kernels}


def _pose_bars(poses, centres, rots, oks, frac: float) -> tuple:
    """(text, ok): every pose accepted, ATE below ``frac`` x the motion,
    final rotation error below 2 degrees.  ``centres`` / ``rots``:
    camera->world of the frames from the first on (the estimate's world is
    the first camera, as the ground truth's)."""
    gt = np.stack([-R.T @ t for R, t in poses[:len(centres)]])
    ate = float(np.mean(np.linalg.norm(np.stack(centres) - gt, axis=1)))
    total = float(np.linalg.norm(gt[-1]))
    rot = _rot_err_deg(rots[-1], poses[len(rots) - 1][0])
    n_ok = sum(oks[1:])
    return (f"pose_ok={n_ok}/{len(oks) - 1} ate={ate:.6f} total_motion="
            f"{total:.6f} ate_frac={ate / total:.6f} (bar {frac}) "
            f"final_rot_err_deg={rot:.6f} (bar 2)",
            n_ok == len(oks) - 1 and ate < frac * total and rot < 2.0)


def _vo_family(tag, what, dev, vo, inputs, poses, frac, kernels):
    """A VO front end's family run: ``vo.process(*inputs[i])`` and its pose
    each frame, held to :func:`_pose_bars`."""
    oks, centres, rots = [], [], []

    def process(i):
        oks.append(vo.process(*inputs[i]))
        R, c = vo.camera_to_world()
        centres.append(c)
        rots.append(R)

    def accuracy():
        return _pose_bars(poses, centres, rots, oks, frac)
    return _family(tag, what, dev, process, accuracy, kernels)


def phase_vo_families(dev, poses, frames) -> dict:
    """``vo_depth:``, ``vo_dual:``, ``vo_quad:`` and ``vo_direct:`` on the
    first frames of the 640x480 reference scene (its left images, and the
    plane's exact depth for the RGB-D families) with the reference
    configs' defaults.  Returns the launches by path."""
    from boofcv_tpu_torch.sfm import (depth_vo, direct_vo, dual_track_vo,
                                      quad_vo, stereo_vo)
    n = FAMILY_FRAMES
    on = lambda a: torch.from_numpy(a).to(dev)
    pairs = [(on(l), on(r)) for l, r in frames[:n]]
    rgbd = [(l, on(d)) for (l, _), d in zip(pairs, plane_depths(
        poses[:n], K, H, W))]
    launches = {}
    cfg = stereo_vo.StereoVoConfig()
    launches["vo_depth"] = _vo_family(
        "vo_depth", f"DepthVisualOdometry {W}x{H}, {cfg.num_tracks} tracks, "
        f"pyramid {cfg.pyramid_scales}", dev,
        depth_vo.DepthVisualOdometry(cfg, K, H, W, device=dev), rgbd, poses,
        0.15, ("klt_track", "gn_pose", "pnp_bank"))
    dcfg = dual_track_vo.DualTrackVoConfig()
    launches["vo_dual"] = _vo_family(
        "vo_dual", f"DualTrackVisualOdometry {W}x{H}, {dcfg.num_tracks} "
        f"tracks, pyramid {dcfg.pyramid_scales}, D={dcfg.max_disparity}", dev,
        dual_track_vo.DualTrackVisualOdometry(dcfg, K, BASELINE, device=dev),
        pairs, poses, 0.15, ("klt_track", "window_gather", "gn_pose",
                             "pnp_bank"))
    qcfg = quad_vo.QuadVoConfig()
    launches["vo_quad"] = _vo_family(
        "vo_quad", f"QuadVisualOdometry {W}x{H}, {qcfg.num_features} SURF "
        f"features an image", dev,
        quad_vo.QuadVisualOdometry(qcfg, K, BASELINE, device=dev), pairs,
        poses, 0.25, ("gn_pose", "pnp_bank"))
    _vo_family("vo_direct", f"DirectDepthVisualOdometry {W}x{H}, scales "
               "(1, 2, 4), 10 Gauss-Newton iterations a level (no hand "
               "kernel)", dev, direct_vo.DirectDepthVisualOdometry(
                   K, device=dev), rgbd, poses, 0.15, ())
    return launches


def phase_motion2d(dev) -> dict:
    """``vo_mono_plane:``, ``vo_overhead:`` (overhead 320x320) and
    ``stitch2d:`` at 640x480 with 300 tracks.  Returns the launches by
    path."""
    from boofcv_tpu_torch.sfm import mono_plane_vo, overhead_vo, stitch2d
    n = FAMILY_FRAMES
    launches = {}

    poses, imgs = mono_plane_scene(K, H, W, n)
    imgs = [torch.from_numpy(f).to(dev) for f in imgs]
    vo = mono_plane_vo.MonoPlaneVisualOdometry(
        K, (0.0, 0.0, 1.0), 4.0, num_tracks=FAMILY_TRACKS, device=dev)
    oks, centres = [], []

    def process(i):
        oks.append(vo.process(imgs[i]))
        centres.append(vo.camera_to_world()[1])

    def accuracy():
        gt = [-R.T @ t for R, t in poses[:len(centres)]]
        err = float(np.linalg.norm(centres[-1] - gt[-1]))
        total = float(np.linalg.norm(gt[-1]))
        return (f"ok={sum(oks)}/{len(oks)} final centre error {err:.6f} of "
                f"{total:.6f} m (bar 0.11 x: the JAX reference drifts "
                "0.100 x on this scene, tests/reference_mono_plane_drift.py)",
                all(oks) and err < 0.11 * total)
    launches["vo_mono_plane"] = _family(
        "vo_mono_plane", f"MonoPlaneVisualOdometry {W}x{H}, "
        f"{FAMILY_TRACKS} tracks, pyramid (1, 2, 4)", dev, process, accuracy,
        ("klt_track",))

    Rp, tp, imgs = overhead_scene(K, H, W, n)
    imgs = [torch.from_numpy(f).to(dev) for f in imgs]
    ovo = overhead_vo.MonoOverheadVisualOdometry(
        K, Rp, tp, H, W, num_tracks=FAMILY_TRACKS, device=dev)
    oks = []

    def process(i):
        oks.append(ovo.process(imgs[i]))

    def accuracy():
        x, z, yaw = ovo.plane_motion()
        true_z = OVERHEAD_STEP * (len(oks) - 1)
        return (f"ok={sum(oks)}/{len(oks)} plane motion x={x:.6f} z={z:.6f} "
                f"(true {true_z:.6f}) yaw={yaw:.6f} (bars |z - true| < 25 %, "
                "|x| < 0.1, |yaw| < 0.05)",
                all(oks) and abs(z - true_z) < 0.25 * true_z and abs(x) < 0.1
                and abs(yaw) < 0.05)
    launches["vo_overhead"] = _family(
        "vo_overhead", f"MonoOverheadVisualOdometry {W}x{H} -> overhead "
        f"320x320 (0.03 m cells), {FAMILY_TRACKS} tracks, pyramid (1, 2)",
        dev, process, accuracy, ("klt_track",))

    big, imgs = sliding_frames(H, W, n, 0, 12, seed=0)
    imgs = [torch.from_numpy(f).to(dev) for f in imgs]
    mh, mw = H + 40, W + 12 * n + 40
    st = stitch2d.Stitcher(mh, mw, offset=(20.0, 20.0),
                           num_tracks=FAMILY_TRACKS, device=dev)
    oks, hs = [], []

    def process(i):
        oks.append(st.process(imgs[i]))
        hs.append(st.H_mosaic_from_frame.copy())

    def accuracy():
        Hm = hs[-1]
        tx = 20.0 + 12 * (len(hs) - 1)
        mosaic = st.image()
        cover = np.s_[40:H, 40:W + 12 * (len(hs) - 1)]
        err = float(np.median(np.abs(mosaic[cover] - big[cover])))
        return (f"ok={sum(oks)}/{len(oks)} H_mosaic_from_frame translation "
                f"({Hm[0, 2]:.4f}, {Hm[1, 2]:.4f}) for ({tx}, 20.0), diagonal "
                f"({Hm[0, 0]:.5f}, {Hm[1, 1]:.5f}) (bars 1 px, 0.02), mosaic "
                f"median error {err:.4f} (bar 4)",
                all(oks) and abs(Hm[0, 2] - tx) < 1.0
                and abs(Hm[1, 2] - 20.0) < 1.0 and abs(Hm[0, 0] - 1) < 0.02
                and abs(Hm[1, 1] - 1) < 0.02 and err < 4.0)
    launches["stitch2d"] = _family(
        "stitch2d", f"Stitcher {W}x{H} frames into a {mw}x{mh} mosaic, "
        f"{FAMILY_TRACKS} tracks, pyramid (1, 2, 4), 20 KLT iterations",
        dev, process, accuracy, ("klt_track",))
    return launches


def phase_point_trackers(dev) -> dict:
    """``point_tracker:`` the four trackers with their default capacities on
    640x480 windows of a texture moving by (1, 2) px a frame, spawning on
    every fourth frame; the two-pass tracker's second pass is hinted with
    the true motion.  Bar: over the tracks alive in the last two counted
    frames, the median error of their motion at most 0.1 px (KLT) or 0.5
    px (DDA), on at least 50 tracks.  Returns the launches by path."""
    from boofcv_tpu_torch.feature import point_tracker as pt
    dy, dx = 1, 2
    _, imgs = sliding_frames(H, W, FAMILY_FRAMES, dy, dx, seed=7)
    imgs = [torch.from_numpy(f).to(dev) for f in imgs]
    launches = {}
    for name, bar in (("PointTrackerKlt", 0.1), ("PointTrackerCombined", 0.1),
                      ("PointTrackerTwoPassKlt", 0.1),
                      ("PointTrackerDda", 0.5)):
        tracker = getattr(pt, name)(device=dev)
        seen = []

        def process(i, tracker=tracker, seen=seen, name=name):
            tracker.process(imgs[i])
            if name == "PointTrackerTwoPassKlt":
                tracker.second_pass(tracker.ys - dy, tracker.xs - dx)
                tracker.finish()
            if i % 4 == 0:
                tracker.spawn()
            seen.append({t.uid: (t.x, t.y) for t in tracker.active_tracks()})

        def accuracy(seen=seen, bar=bar, tracker=tracker):
            a, b = seen[-2], seen[-1]
            shared = [u for u in b if u in a]
            err = [np.hypot(b[u][0] - a[u][0] + dx, b[u][1] - a[u][1] + dy)
                   for u in shared]
            med = float(np.median(err)) if err else float("inf")
            return (f"{len(b)} of {tracker.n} slots alive, {len(shared)} "
                    f"followed over the last frame, median motion error "
                    f"{med:.4f} px (bars {bar} px, 50 tracks)",
                    len(shared) >= 50 and med <= bar)
        kernels = () if name == "PointTrackerDda" else ("klt_track",)
        got = _family("point_tracker", f"{name} {W}x{H}, {tracker.n} slots",
                      dev, process, accuracy, kernels)
        if got:
            launches[f"point_tracker {name}"] = got
    return launches


# ---- multi-view geometry and SfM -----------------------------------------

MV_VIEWS, MV_POINTS = 10, 1500    # sfm_incremental
S2_VIEWS, S2_POINTS = 20, 1000    # sfm_uncalibrated
S2_FOCAL = 480.0
TV_TRIPLES, TV_OUTLIERS = 1000, 0.2   # three_view
PG_POSES, PG_LOOPS = 1000, 100    # pose_graph
EQUI_SHAPE = (1024, 2048)         # spherical
N_CLOUD, CLOUD_K = 16384, 8       # cloud


def _rodrigues(w) -> np.ndarray:
    from boofcv_tpu_torch.geo import se3
    return se3.exp_so3(torch.from_numpy(np.asarray(w, np.float64))).numpy()


def _features(desc, idx, xs, ys, rng, desc_noise):
    from boofcv_tpu_torch.sfm.reconstruction import ImageFeatures
    return ImageFeatures(ys=ys, xs=xs, scales=np.ones(len(idx)),
                         desc=desc[idx] + rng.normal(0, desc_noise,
                                                     (len(idx), 64)),
                         valid=np.ones(len(idx), bool))


def incremental_scene(n_views=MV_VIEWS, n_points=MV_POINTS, k=K, h=H, w=W,
                      noise=0.3, seed=0):
    """``tests/test_reconstruction.py``'s ``synthetic_views``: known points,
    one unit descriptor each (observed with 0.01 noise), cameras creeping
    sideways with small rotations, ``noise`` px on every observation."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n_points),
                    rng.uniform(-1.5, 1.5, n_points),
                    rng.uniform(5, 9, n_points)], 1)
    poses = []
    for v in range(n_views):
        R = _rodrigues(rng.normal(0, 0.02, 3))
        poses.append((R, -R @ np.array([0.5 * v, 0.05 * v, 0.1 * v])))
    desc = rng.normal(0, 1, (n_points, 64))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    feats = []
    for R, t in poses:
        Xc = pts @ R.T + t
        proj = (Xc / Xc[:, 2:]) @ k.T
        u, v_ = proj[:, 0], proj[:, 1]
        idx = np.nonzero((Xc[:, 2] > 0) & (u >= 5) & (u < w - 5)
                         & (v_ >= 5) & (v_ < h - 5))[0]
        feats.append(_features(desc, idx,
                               u[idx] + rng.normal(0, noise, idx.size),
                               v_[idx] + rng.normal(0, noise, idx.size),
                               rng, 0.01))
    return poses, feats


def orbit_scene(n_views=S2_VIEWS, n_points=S2_POINTS, h=H, w=W, f=S2_FOCAL,
                seed=3):
    """``tests/test_structure2.py``'s ``orbit_scene``: an arc of cameras
    around a point cloud with jittered look-at targets, 0.15 px noise."""
    return orbit_views(n_views, n_points, h, w, f, seed)[:2]


def orbit_views(n_views=S2_VIEWS, n_points=S2_POINTS, h=H, w=W, f=S2_FOCAL,
                seed=3):
    """``orbit_scene`` and, a view, the ids of the points its features
    see, in their order."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, n_points),
                    rng.uniform(-2, 2, n_points),
                    rng.uniform(-3, 3, n_points)], 1)
    desc = rng.normal(0, 1, (n_points, 64))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    Kf = np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1.0]])
    poses, feats, ids = [], [], []
    for v in range(n_views):
        ang = 0.9 * v / n_views * np.pi
        c = np.array([10 * np.sin(ang), 0.5 * np.sin(3 * ang),
                      -10 * np.cos(ang)])
        tgt = rng.uniform(-1.5, 1.5, 3)
        z = (tgt - c) / np.linalg.norm(tgt - c)
        x = np.cross([0, 1, 0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        t = -R @ c
        poses.append((R, t))
        pc = pts @ R.T + t
        pr = (pc / pc[:, 2:]) @ Kf.T
        idx = np.nonzero(((pr[:, :2] > 6) & (pr[:, :2] < [w - 6, h - 6])
                          ).all(1) & (pc[:, 2] > 0.5))[0]
        idx = idx[rng.permutation(len(idx))]
        ids.append(idx)
        feats.append(_features(desc, idx,
                               pr[idx, 0] + rng.normal(0, 0.15, len(idx)),
                               pr[idx, 1] + rng.normal(0, 0.15, len(idx)),
                               rng, 0.02))
    return poses, feats, ids


def three_view_scene(n=TV_TRIPLES, outliers=TV_OUTLIERS, f=400.0, h=H, w=W,
                     seed=1):
    """``tests/test_three_view.py``'s ``make_scene`` with its outlier test's
    corruption: the first ``outliers`` of the view-3 points moved 20-60 px.
    Returns (triples, true-inlier mask)."""
    rng = np.random.default_rng(seed)
    Kf = np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1.0]])
    X = np.concatenate([rng.uniform(-2, 2, (n, 2)),
                        rng.uniform(5, 9, (n, 1))], 1)
    views = []
    for v in range(3):
        R = _rodrigues(rng.normal(0, 0.04, 3))
        px = (X @ R.T + np.array([0.5 * v, 0.05 * v, 0.02 * v])) @ Kf.T
        views.append(px[:, :2] / px[:, 2:])
    bad = int(outliers * n)
    views[2][:bad] += rng.uniform(20, 60, (bad, 2))
    good = np.arange(n) >= bad
    return views, good


def pose_graph_scene(n=PG_POSES, loops=PG_LOOPS, seed=1):
    """``tests/test_reconstruction.py``'s pose-graph scene at size: a path
    that circles (radius 10 m, one lap in ~126 poses, bobbing 0.5 m) with
    exact odometry between neighbours and ``loops`` exact closures between
    poses one to three laps apart; every pose but the first perturbed by
    0.02 rad and 0.1 m."""
    rng = np.random.default_rng(seed)
    Rs, ts = [], []
    for i in range(n):
        R = _rodrigues([0.0, 0.05 * i, 0.0])
        c = np.array([10 * np.sin(0.05 * i), 0.5 * np.sin(0.3 * i),
                      10 * np.cos(0.05 * i)])
        Rs.append(R)
        ts.append(-R @ c)
    pairs = [(i, i + 1) for i in range(n - 1)]
    lap = int(round(2 * np.pi / 0.05))
    starts = rng.choice(max(n - 3 * lap, loops), loops, replace=False)
    pairs += [(int(i), int(min(i + lap * rng.integers(1, 4), n - 1)))
              for i in starts]
    edges = []
    for i, j in pairs:
        Rij = Rs[j] @ Rs[i].T
        edges.append((i, j, Rij, ts[j] - Rij @ ts[i]))
    Rp = np.stack([Rs[0]] + [_rodrigues(rng.normal(0, 0.02, 3)) @ R
                             for R in Rs[1:]])
    tp = np.stack([ts[0]] + [t + rng.normal(0, 0.1, 3) for t in ts[1:]])
    return Rp, tp, edges


def _world_texture(d):
    """Grey level of the 360 scene in direction d [..., 3] (unit): smooth
    bands in longitude and latitude, 8 to 248."""
    lon = np.arctan2(d[..., 0], d[..., 2])
    lat = np.arcsin(np.clip(d[..., 1], -1, 1))
    return (128 + 70 * np.sin(12 * lon) * np.cos(10 * lat)
            + 50 * np.sin(7 * d[..., 0] + 5 * d[..., 1] - 3 * d[..., 2]))


def spherical_scene(h=H, w=W, f=480.0):
    """Two 640x480 pinhole views (camera-to-world yaw 0 and 0.9 rad) of the
    360 texture, each pixel the texture at its ray."""
    from boofcv_tpu_torch.geo import cameras
    cam = cameras.CameraPinhole(fx=f, fy=f, cx=(w - 1) / 2, cy=(h - 1) / 2,
                                width=w, height=h)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    d = np.stack([(xx - cam.cx) / f, (yy - cam.cy) / f, np.ones_like(xx)],
                 -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    Rs = [_rodrigues([0.0, a, 0.0]) for a in (0.0, 0.9)]
    views = [_world_texture(d @ R.T).astype(np.float32) for R in Rs]
    return cam, Rs, views


def cloud_scene(n=N_CLOUD, seed=0):
    """16,384 points uniform in a 10 m cube, 1 % of them outliers spread
    over a 110 m one, and as many query points in the cube."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 10, (n, 3))
    pts[:n // 100] = rng.uniform(-50, 60, (n // 100, 3))
    return pts, rng.uniform(0, 10, (n, 3))


def np_knn(queries, points, k, exclude_self=False, chunk=1024):
    """Plain float64 numpy brute force: (indices [Q, k], distances [Q, k])
    of each query's k nearest points, nearest first."""
    idx = np.empty((len(queries), k), np.int64)
    dist = np.empty((len(queries), k))
    p2 = np.sum(points * points, 1)
    for lo in range(0, len(queries), chunk):
        q = queries[lo:lo + chunk]
        d2 = np.sum(q * q, 1)[:, None] - 2.0 * q @ points.T + p2[None]
        if exclude_self:
            d2[np.arange(len(q)), lo + np.arange(len(q))] = np.inf
        part = np.argpartition(d2, k, axis=1)[:, :k]
        dp = np.take_along_axis(d2, part, 1)
        order = np.argsort(dp, axis=1)
        idx[lo:lo + chunk] = np.take_along_axis(part, order, 1)
        dist[lo:lo + chunk] = np.sqrt(np.maximum(
            np.take_along_axis(dp, order, 1), 0.0))
    return idx, dist


def _centre_error(poses_gt, poses_est) -> tuple:
    """(largest camera-centre error after a similarity (Umeyama) alignment,
    the trajectory's span)."""
    gt = np.stack([-R.T @ t for R, t in poses_gt])
    est = np.stack([-R.T @ t for R, t in poses_est])
    mu_g, mu_e = gt.mean(0), est.mean(0)
    gg, ee = gt - mu_g, est - mu_e
    U, S, Vt = np.linalg.svd(ee.T @ gg)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R_al = (U @ D @ Vt).T
    s = np.trace(np.diag(S) @ D) / (ee ** 2).sum()
    res = gt - (s * (est @ R_al.T) + (mu_g - s * R_al @ mu_e))
    span = np.linalg.norm(gt[:, None] - gt[None], axis=-1).max()
    return float(np.linalg.norm(res, axis=1).max()), float(span)


class _StageClock:
    """Wraps module functions so that each call adds its host wall time,
    up to a synchronize after it, to its stage; ``with`` restores them."""

    def __init__(self, targets):
        self.targets = targets          # (module, function name, stage)
        self.ms = collections.defaultdict(float)
        self.calls = collections.Counter()

    def __enter__(self):
        self.saved = []
        for mod, name, stage in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def timed(*a, _fn=fn, _stage=stage, **kw):
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                self.ms[_stage] += 1e3 * (time.perf_counter() - t0)
                self.calls[_stage] += 1
                return out
            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _multiview(tag: str, what: str, fn, dev, reps: int,
               long_call: bool = False, stages=()) -> tuple:
    """Run ``fn`` on the card as a multi-view phase measures it and print
    its line: host syncs by call site and peak memory of the first call
    (the warm-up), ms per call (CUDA events around the whole call, ``reps``
    after the warm-up, each stage of ``stages`` timed inside them with a
    synchronize after it), kernels, device busy ms and idle share of one
    profiled call (``long_call``: the device alone).  Returns (the first
    call's result, median ms)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out, syncs = _count_sync_warnings(fn)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    with _StageClock(stages) as clock:
        ms = _solve_ms(fn, reps, warm_up=False)
    n_kernels, busy_ms, _ = _profile_call(fn, cpu=not long_call)
    med = float(np.median(ms))
    parts = "; ".join(f"{k} {v / reps:.3f} ms in {clock.calls[k] // reps} "
                      f"calls" for k, v in clock.ms.items())
    print(f"{tag}: {what}: ms per call (CUDA events around the whole call, "
          f"{reps} after a warm-up)={[round(m, 3) for m in ms]} "
          f"median={med:.3f}; one profiled call launches {n_kernels} "
          f"kernels, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / med:.4f} of the median call; host syncs="
          f"{sum(syncs.values())} {dict(sorted(syncs.items()))}; peak "
          f"device memory MiB={peak:.1f}"
          + (f"; stages a call (host wall, synchronize after each): {parts}"
             if parts else ""))
    check(n_kernels > 0, f"{tag}: nothing ran on the device")
    return out, med


def phase_sfm_incremental(dev) -> None:
    """``sfm_incremental:`` ``build_pairwise_graph`` (Nister RANSAC, 256
    hypotheses, the pairs 16 to a chunk) + ``reconstruct_incremental`` (PnP
    RANSAC a view, 15 BA iterations) over 10 views of 1,500 points, K of a
    640x480 camera (fx 480), 0.3 px noise."""
    from boofcv_tpu_torch.geo import ba, robust
    from boofcv_tpu_torch.sfm import reconstruction
    poses, feats = incremental_scene(MV_VIEWS, MV_POINTS)
    views = list(range(MV_VIEWS))

    def run():
        graph = reconstruction.build_pairwise_graph(
            views, K, detect=lambda i: feats[i], device=dev)
        return graph, reconstruction.reconstruct_incremental(graph, K,
                                                             device=dev)
    (graph, scene), _ = _multiview(
        "sfm_incremental", f"{MV_VIEWS} views x {MV_POINTS} points, "
        "256 hypotheses, 15 BA iterations", run, dev, reps=3,
        long_call=True, stages=(
            (robust, "ransac_essential", "ransac_essential"),
            (robust, "ransac_pnp", "ransac_pnp"),
            (reconstruction, "match_features", "match_features"),
            (reconstruction, "_tri2", "triangulate"),
            (ba, "optimize", "BA")))
    err, span = _centre_error(poses, [scene["poses"].get(v, (np.eye(3),
                                                             np.zeros(3)))
                                      for v in views])
    n_pts = len(scene["points"])
    print(f"sfm_incremental: accuracy: {len(graph.edges)} edges, "
          f"{len(scene['views'])}/{MV_VIEWS} views registered; camera-centre "
          f"error after similarity alignment {err:.6f} of span {span:.6f} = "
          f"{err / span:.6f} (bar 0.01); {n_pts} points = "
          f"{n_pts / MV_POINTS:.4f} of {MV_POINTS} (bar 0.6); final BA cost "
          f"{float(scene['ba_info']['final_cost']):.6e}")
    check(scene["views"] == views and err < 0.01 * span
          and n_pts > 0.6 * MV_POINTS,
          "sfm_incremental: a view unregistered, centres or points off")


def phase_sfm_uncalibrated(dev) -> None:
    """``sfm_uncalibrated:`` ``reconstruct_uncalibrated`` on the orbit
    scene: 20 views x 1,000 points, 640x480, f = 480, every pair a
    candidate, F + H RANSAC in chunks of 64 pairs."""
    from boofcv_tpu_torch.geo import ba
    from boofcv_tpu_torch.sfm import reconstruction, structure2
    poses, feats = orbit_scene(S2_VIEWS, S2_POINTS)
    imgs = [np.zeros((H, W), np.float32)] * S2_VIEWS

    def run():
        it = iter(feats)
        return structure2.reconstruct_uncalibrated(
            imgs, detect=lambda im: next(it), device=dev)
    scene, _ = _multiview(
        "sfm_uncalibrated", f"{S2_VIEWS} views x {S2_POINTS} points, "
        f"{S2_VIEWS * (S2_VIEWS - 1) // 2} pairs in chunks of 64", run, dev,
        reps=3, long_call=True, stages=(
            (structure2, "generate_pairwise_graph", "pairwise graph"),
            (structure2, "_batched_fh_ransac", "F+H RANSAC chunk"),
            (structure2, "focal_from_fundamentals", "focal sweep"),
            (structure2, "_metric_graph_from_edges", "metric graph"),
            (reconstruction, "reconstruct_incremental", "incremental"),
            (ba, "optimize", "BA")))
    views = list(range(S2_VIEWS))
    f_est = scene["K"][0, 0]
    ferr = abs(f_est - S2_FOCAL) / S2_FOCAL
    err, span = _centre_error(poses, [scene["poses"].get(v, (np.eye(3),
                                                             np.zeros(3)))
                                      for v in views])
    print(f"sfm_uncalibrated: accuracy: {len(scene['graph'].edges)} edges, "
          f"{len(scene['poses'])}/{S2_VIEWS} views registered; focal "
          f"{f_est:.4f} (true {S2_FOCAL}, error {ferr:.6f}, bar 0.05); "
          f"camera-centre error {err:.6f} of span {span:.6f} = "
          f"{err / span:.6f} (bar 0.01); {len(scene['points'])} points")
    check(sorted(scene["poses"]) == views and ferr < 0.05
          and err < 0.01 * span,
          "sfm_uncalibrated: a view unregistered, focal or centres off")


def phase_three_view(dev) -> None:
    """``three_view:`` ``estimate_metric_scene`` on 1,000 triples with 20 %
    outliers, 640x480, f 400, 256 hypotheses."""
    from boofcv_tpu_torch.geo import ba, selfcalib
    from boofcv_tpu_torch.sfm import three_view
    views, good = three_view_scene(TV_TRIPLES, TV_OUTLIERS)
    res, _ = _multiview(
        "three_view", f"{TV_TRIPLES} triples, {int(TV_OUTLIERS * 100)} % "
        "outliers, 256 hypotheses", lambda: three_view.estimate_metric_scene(
            *views, (H, W), device=dev), dev, reps=3, long_call=True,
        stages=((three_view, "ransac_trifocal", "ransac_trifocal"),
                (selfcalib, "self_calibrate_dual_quadratic",
                 "dual quadratic"),
                (selfcalib, "guess_and_check_focus", "focus sweep"),
                (ba, "optimize", "BA")))
    f_est = 0.5 * (res.K[0, 0] + res.K[1, 1])
    ferr = abs(f_est - 400.0) / 400.0
    kept = float(res.inliers[good].mean())
    out = float(res.inliers[~good].mean())
    print(f"three_view: accuracy: focal {f_est:.4f} (true 400, error "
          f"{ferr:.6f}, bar 0.1); true inliers kept {kept:.4f} (bar 0.95), "
          f"outliers accepted {out:.4f}; reprojection RMSE "
          f"{res.reproj_rmse:.3e} (normalized)")
    check(ferr < 0.1 and kept >= 0.95, "three_view: focal or inliers off")


def phase_pose_graph(dev) -> None:
    """``pose_graph:`` ``optimize`` on 1,000 poses (an odometry chain and
    100 loop closures), 20 iterations, float64: one [6000, 6000] dense
    Cholesky solve an iteration."""
    from boofcv_tpu_torch.sfm import pose_graph
    Rp, tp, edges = pose_graph_scene(PG_POSES, PG_LOOPS)
    graph = pose_graph.make_graph(Rp, tp, edges, device=dev)
    r0 = pose_graph.residuals(graph)
    c_init = float(torch.sum(graph.weight[:, None] * r0 * r0))
    (g1, costs), _ = _multiview(
        "pose_graph", f"{PG_POSES} poses, {len(edges)} edges ("
        f"{PG_POSES - 1} odometry, {len(edges) - PG_POSES + 1} loop "
        "closures), 20 iterations, float64",
        lambda: pose_graph.optimize(graph, iterations=20), dev, reps=5)
    g2, costs2 = pose_graph.optimize(graph, iterations=20)
    same = (torch.equal(g1.R, g2.R) and torch.equal(g1.t, g2.t)
            and torch.equal(costs, costs2))
    c = costs.cpu().numpy()
    rises = int((np.diff(np.concatenate([[c_init], c])) > 0).sum())
    print(f"pose_graph: accuracy: cost {c_init:.6e} -> {c[-1]:.6e} "
          f"({c[-1] / c_init:.3e} of the initial, bar 1e-3); costs rise "
          f"{rises} times (bar 0); two solves bit-equal={same}")
    check(bool(np.isfinite(c).all()) and c[-1] < 1e-3 * c_init
          and rises == 0 and same, "pose_graph: cost, monotony or "
                                   "repeatability off")


def phase_spherical(dev) -> None:
    """``spherical:`` ``multi_camera_to_equi`` of two 640x480 pinhole views
    into a 1024x2048 canvas, then ``equi_to_pinhole`` of the first view
    back out."""
    from boofcv_tpu_torch.geo import spherical
    cam, Rs, views = spherical_scene()
    imgs = [torch.from_numpy(v).to(dev) for v in views]

    def run():
        canvas = spherical.multi_camera_to_equi(imgs, [cam, cam], Rs,
                                                EQUI_SHAPE)
        return canvas, spherical.equi_to_pinhole(canvas, cam, Rs[0], (H, W))
    (canvas, back), _ = _multiview(
        "spherical", f"2 views {W}x{H} -> {EQUI_SHAPE[1]}x{EQUI_SHAPE[0]} "
        f"-> {W}x{H}", run, dev, reps=5)
    # covered: pixels whose every canvas tap holds a blended sample
    cov = (canvas > 0).to(torch.float32)
    covered = spherical.equi_to_pinhole(cov, cam, Rs[0], (H, W)) > 0.999
    err = (back - imgs[0]).abs()[covered].cpu().numpy()
    share = float((err <= 1.0).mean())
    print(f"spherical: accuracy: canvas coverage "
          f"{float(cov.mean()):.4f}; {int(covered.sum())} of {H * W} pixels "
          f"covered; round trip within 1 grey level on {share:.6f} of them "
          f"(bar 0.95), median error {float(np.median(err)):.4f}, max "
          f"{float(err.max()):.4f}")
    check(share >= 0.95 and int(covered.sum()) > 0.5 * H * W,
          "spherical: round trip off")


def phase_cloud(dev) -> None:
    """``cloud:`` ``filter_radius_outliers`` (k = 8) and
    ``nearest_neighbors`` (k = 8) on 16,384 points (the [N, N] float32
    distance matrix is 1 GiB), against a float64 numpy brute force; and
    ``downsample_voxel`` on the host."""
    from boofcv_tpu_torch.geo import cloud
    pts, queries = cloud_scene(N_CLOUD)
    p_dev = torch.from_numpy(pts).to(dev)
    q_dev = torch.from_numpy(queries).to(dev)

    def run():
        keep = cloud.filter_radius_outliers(p_dev, CLOUD_K, 1.0)
        return keep, cloud.nearest_neighbors(q_dev, p_dev, CLOUD_K)
    (keep, (idx, dist)), _ = _multiview(
        "cloud", f"filter_radius_outliers + nearest_neighbors, {N_CLOUD} "
        f"points, k={CLOUD_K}", run, dev, reps=5)
    t0 = time.perf_counter()
    nn_i, nn_d = np_knn(queries, pts, CLOUD_K)
    self_i, self_d = np_knn(pts, pts, CLOUD_K, exclude_self=True)
    np_ms = 1e3 * (time.perf_counter() - t0)
    idx = idx.cpu().numpy()
    same = np.mean([set(a) == set(b) for a, b in zip(idx, nn_i)])
    dgap = float(np.abs(np.sort(dist.cpu().numpy(), 1) - nn_d).max())
    keep_np = self_d.mean(axis=1) <= 1.0
    agree = float((keep.cpu().numpy() == keep_np).mean())
    vox_ms, vox = _host_ms(lambda: cloud.downsample_voxel(pts, 0.5))
    print(f"cloud: accuracy: nearest_neighbors index sets equal the float64 "
          f"numpy brute force on {same:.6f} of {N_CLOUD} queries (bar 0.999),"
          f" distances within {dgap:.3e}; filter_radius_outliers keeps "
          f"{int(keep.sum())}, its mask equals numpy's on {agree:.6f} of the "
          f"points (bar 0.999); numpy brute force on the host (a CPU figure) "
          f"{np_ms:.1f} ms; downsample_voxel(0.5) on the host {vox_ms:.3f} "
          f"ms, {len(vox)} voxels")
    check(same >= 0.999 and agree >= 0.999, "cloud: neighbours off")


# ---- recognition: binary images, fiducials, QR codes, calibration targets --

REC_H, REC_W = 720, 1280          # binary:, fiducial:, qr:
REC_K = np.array([[1000.0, 0.0, REC_W / 2], [0.0, 1000.0, REC_H / 2],
                  [0.0, 0.0, 1.0]])
FID_SIDE = 0.12                   # marker side (m) of the fiducial scene
# the polygon fit returns contour pixels as corners: ~0.7 px inside a true
# corner, and a few px along an edge where the corner's pixels are blunted
FID_MAX_CORNER_PX = 3.5
QR_VERSIONS = (2, 10, 25)         # qr: level M, 4 px modules
CAL_VIEWS = 12                    # calib_targets: views a target, 640x480
CAL_K = np.array([[600.0, 0.0, W / 2], [0.0, 600.0, H / 2], [0.0, 0.0, 1.0]])
# each calibration target's extent (u0, v0, u1, v1) in plane units
# per target: a share of each view's true points found within a distance
# (px), and Zhang99's focal (relative) and RMSE (px) bars: the JAX tests'
# (tests/test_chessboard_auto.py, tests/test_calib_targets.py), except the
# square grid's, whose corners are pixels of the traced contour (median 1.0
# px off the true corner, up to 2.6: its JAX test allows 2.5 px and an RMSE
# of 1.0 on a milder scene)
CAL_BARS = {"chessboard": (1.0, 0.95, 0.02, 0.5),
            "square_grid": (2.5, 0.9, 0.03, 1.25),
            "circle_grid": (1.5, 0.95, 0.02, 0.5),
            "hex_grid": (1.5, 0.95, 0.02, 0.5)}
CAL_EXTENTS = {"chessboard": (0.0, 0.0, 10.0, 8.0),
               "square_grid": (0.0, 0.0, 10.0, 7.0),
               "circle_grid": (0.0, 0.0, 8.0, 6.0),
               "hex_grid": (0.0, 0.0, 6.5, 4.9)}


def _render_plane(frame, Hm, shade, extent, ss: int = 4) -> None:
    """Draw a planar pattern into ``frame`` in place.  ``Hm`` maps plane
    points (u, v, 1) to pixel-centre image coordinates; ``shade(u, v)`` is
    the pattern's value, NaN off the pattern (the frame shows through).
    Each pixel of the pattern's bounding box averages ss x ss samples at
    its own sub-pixel centres."""
    h, w = frame.shape
    u0, v0, u1, v1 = extent
    c = np.array([[u0, v0, 1], [u1, v0, 1], [u1, v1, 1], [u0, v1, 1.0]]) \
        @ Hm.T
    c = c[:, :2] / c[:, 2:]
    x0, y0 = np.maximum(np.floor(c.min(0)).astype(int) - 1, 0)
    x1, y1 = np.minimum(np.ceil(c.max(0)).astype(int) + 2, [w, h])
    off = (np.arange(ss) + 0.5) / ss - 0.5
    ys = (np.arange(y0, y1)[:, None] + off).reshape(-1)
    xs = (np.arange(x0, x1)[:, None] + off).reshape(-1)
    X, Y = np.meshgrid(xs, ys)
    q = np.stack([X, Y, np.ones_like(X)], -1) @ np.linalg.inv(Hm).T
    val = shade(q[..., 0] / q[..., 2], q[..., 1] / q[..., 2])
    base = np.repeat(np.repeat(frame[y0:y1, x0:x1], ss, 0), ss, 1)
    val = np.where(np.isnan(val), base, val)
    frame[y0:y1, x0:x1] = val.reshape(y1 - y0, ss, x1 - x0, ss).mean((1, 3))


def _apply_h(Hm, uv) -> np.ndarray:
    p = np.c_[np.asarray(uv, np.float64), np.ones(len(uv))] @ Hm.T
    return p[:, :2] / p[:, 2:]


def _plane_view(k, R, t, centre) -> np.ndarray:
    """Homography plane (u, v) -> pixels of a plane posed by (R, t) with
    its point ``centre`` at t."""
    return k @ np.c_[R[:, 0], R[:, 1], t - R[:, :2] @ np.asarray(centre)]


def _rot_z(a) -> np.ndarray:
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1.0]])


def binary_scene(h=None, w=None, seed=0) -> np.ndarray:
    """A ``h x w`` frame of dark shapes on a lit ramp, noise sigma 4: a
    10 x 8 chessboard (its dark squares one 8-connected blob: the labeling's
    longest path) and 24 shapes beside it (rings, squares with two holes,
    discs, bars)."""
    h = REC_H if h is None else h
    w = REC_W if w is None else w
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 170.0 + 40.0 * xx / w
    sq = max(h // 18, 4)
    by, bx = (yy - h // 10) // sq, (xx - w // 16) // sq
    board = (by >= 0) & (by < 8) & (bx >= 0) & (bx < 10) & ((by + bx) % 2 == 0)
    img[board] = 35.0
    cell = h / 6                     # 6 x 4 shapes right of the board
    for i in range(24):
        cy = (i // 4 + 0.5) * cell + rng.uniform(-0.1, 0.1) * cell
        cx = 0.62 * w + (i % 4 + 0.5) * cell + rng.uniform(-0.1, 0.1) * cell
        r = rng.uniform(0.2, 0.4) * cell
        d = np.hypot(yy - cy, xx - cx)
        kind = i % 4
        if kind == 0:                                   # ring
            img[(d < r) & (d > 0.5 * r)] = 40.0
        elif kind == 1:                                 # disc
            img[d < r] = 40.0
        elif kind == 2:                                 # square, two holes
            m = (np.abs(yy - cy) < r) & (np.abs(xx - cx) < r)
            hole = (np.abs(yy - cy) < 0.3 * r) & (np.abs(np.abs(xx - cx)
                                                          - 0.5 * r)
                                                  < 0.25 * r)
            img[m & ~hole] = 40.0
        else:                                           # bar
            img[(np.abs(yy - cy) < 0.2 * r) & (np.abs(xx - cx) < r)] = 40.0
    return (img + rng.normal(0, 4, img.shape)).astype(np.float32)


def _smooth_pattern(rng, n=32) -> np.ndarray:
    """A picture for an image fiducial: smoothed noise, 17-237."""
    p = rng.normal(0, 1, (n, n))
    for _ in range(3):
        p = (np.roll(p, 1, 0) + p + np.roll(p, -1, 0)) / 3
        p = (np.roll(p, 1, 1) + p + np.roll(p, -1, 1)) / 3
    return (127 + 110 * p / np.abs(p).max()).astype(np.float32)


def fiducial_scene(seed=0) -> tuple:
    """The 1280x720 fiducial frame: 8 binary markers (ids spread to
    ``max_marker_id()``) and 2 image markers, side ``FID_SIDE`` m at 0.85-1.05
    m, each turned a quarter turn more than the last (and up to 12 degrees
    more), tilted up to 26 degrees about x and y (a perspective warp),
    noise sigma 4.  Returns (frame, [(kind, id, plane->image homography
    of the unit square, R, t)], patterns)."""
    from boofcv_tpu_torch.recognition import fiducial_square as fid
    rng = np.random.default_rng(seed)
    frame = np.full((REC_H, REC_W), 200.0)
    ids = [0, 1, 777, 1234, 2500, 3333, 4001, fid.max_marker_id()]
    patterns = [_smooth_pattern(rng) for _ in range(2)]
    markers = []
    for i in range(10):
        cx, cy = 160 + 240 * (i % 5), 190 + 340 * (i // 5)
        z = rng.uniform(0.85, 1.05)
        tilt = rng.uniform(-0.45, 0.45, 2)
        R = _rodrigues([tilt[0], tilt[1], 0.0]) @ _rot_z(
            np.pi / 2 * (i % 4) + np.radians(rng.uniform(-12, 12)))
        t = np.array([(cx - REC_K[0, 2]) * z / REC_K[0, 0],
                      (cy - REC_K[1, 2]) * z / REC_K[1, 1], z])
        # unit square (u, v) -> the marker plane at (u - 1/2, v - 1/2) side
        Hm = _plane_view(REC_K, R * np.array([FID_SIDE, FID_SIDE, 1.0]), t,
                         (0.5, 0.5))
        if i < 8:
            cells = fid.encode_marker(ids[i], 1)[2:-2, 2:-2]
            n = len(cells)

            def shade(u, v, cells=cells, n=n):
                inside = (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
                iu = np.clip(np.floor(u * n), 0, n - 1).astype(int)
                iv = np.clip(np.floor(v * n), 0, n - 1).astype(int)
                return np.where(inside, cells[iv, iu], np.nan)
            markers.append(("binary", ids[i], Hm, R, t))
        else:
            p = patterns[i - 8]

            def shade(u, v, p=p):
                inside = (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
                inner = (u >= 0.25) & (u < 0.75) & (v >= 0.25) & (v < 0.75)
                n = len(p)
                iu = np.clip(np.floor((u - 0.25) * 2 * n), 0, n - 1)
                iv = np.clip(np.floor((v - 0.25) * 2 * n), 0, n - 1)
                val = np.where(inner, p[iv.astype(int), iu.astype(int)], 0.0)
                return np.where(inside, val, np.nan)
            markers.append(("image", i - 8, Hm, R, t))
        _render_plane(frame, Hm, shade, (0.0, 0.0, 1.0, 1.0))
    frame += rng.normal(0, 4, frame.shape)
    return frame.astype(np.float32), markers, patterns


def qr_scene(version: int, seed=0) -> tuple:
    """One code of ``version`` at level M, 4 px modules, in a 1280x720
    frame under a homography (turned, slightly projective), noise sigma 6.
    Returns (frame, text)."""
    from boofcv_tpu_torch.recognition.qr import code as qr
    rng = np.random.default_rng(seed + version)
    cap = qr.data_capacity_bytes(version, "M")
    text = (f"QR version {version} level M on the card / " * 60)[
        :int(0.8 * cap)]
    mat = qr.encode(text, version=version, level="M")
    n = mat.shape[0]
    a = np.radians(rng.uniform(-15, 15))
    p = rng.uniform(-3e-5, 3e-5, 2)
    # module coords centred on the code -> pixels: 4 px a module, turned
    # by a, a small projective row, centred in the frame
    Hm = np.array([[1, 0, REC_W / 2], [0, 1, REC_H / 2], [0, 0, 1.0]]) \
        @ np.diag([4.0, 4.0, 1.0]) @ _rot_z(a) \
        @ np.array([[1, 0, 0], [0, 1, 0], [p[0], p[1], 1.0]]) \
        @ np.array([[1, 0, -n / 2], [0, 1, -n / 2], [0, 0, 1.0]])
    frame = np.full((REC_H, REC_W), 235.0)

    def shade(u, v):
        inside = (u >= 0) & (u < n) & (v >= 0) & (v < n)
        iu = np.clip(np.floor(u), 0, n - 1).astype(int)
        iv = np.clip(np.floor(v), 0, n - 1).astype(int)
        return np.where(inside, np.where(mat[iv, iu], 20.0, 235.0), np.nan)
    _render_plane(frame, Hm, shade, (0.0, 0.0, float(n), float(n)))
    frame += rng.normal(0, 6, frame.shape)
    return frame.astype(np.float32), text


def _calib_points(target: str) -> np.ndarray:
    """[N, 2] plane points a target's detector reports, in plane units."""
    if target == "chessboard":
        return np.array([(c, r) for r in range(1, 8) for c in range(1, 10)],
                        np.float64)
    if target == "square_grid":
        return np.array([(c * 1.5 + b, r * 1.5 + a) for r in range(5)
                         for a in range(2) for c in range(7)
                         for b in range(2)], np.float64)
    if target == "circle_grid":
        return np.array([(c + 0.5, r + 0.5) for r in range(6)
                         for c in range(8)], np.float64)
    return np.array([(0.25 + 0.5 * c, 0.25 + 0.55 * r) for r in range(9)
                     for c in range(13) if (r + c) % 2 == 0], np.float64)


def _calib_shade(target: str):
    pts = _calib_points(target)

    def chess(u, v):
        inside = (u >= 0) & (u < 10) & (v >= 0) & (v < 8)
        par = (np.floor(u) + np.floor(v)) % 2 == 0
        return np.where(inside, np.where(par, 30.0, 220.0), np.nan)

    def squares(u, v):
        fu, fv = np.mod(u, 1.5), np.mod(v, 1.5)
        on = (fu < 1) & (fv < 1) & (u >= 0) & (u < 10.5) & (v >= 0) \
            & (v < 7.5)
        return np.where(on, 20.0, np.nan)

    def circles(radius):
        def f(u, v):
            out = np.full(u.shape, np.nan)
            for cu, cv in pts:
                near = (np.abs(u - cu) < radius) & (np.abs(v - cv) < radius)
                if near.any():
                    out[near & ((u - cu) ** 2 + (v - cv) ** 2
                                < radius ** 2)] = 20.0
            return out
        return f
    return {"chessboard": chess, "square_grid": squares,
            "circle_grid": circles(0.3), "hex_grid": circles(0.16)}[target]


def calib_scene(target: str, occlude: bool = False) -> tuple:
    """``CAL_VIEWS`` 640x480 views of ``target`` by the camera ``CAL_K``: the
    target's centre 14-18 plane units ahead, tilted up to 35 degrees,
    rolled up to 10; background 128 for the chessboard, 235 for the dark
    targets.  ``occlude``: view 1 loses about a tenth of its points under a
    grey disc.  Returns (views, [V, N, 2] true points, plane points)."""
    extent = CAL_EXTENTS[target]
    centre = ((extent[0] + extent[2]) / 2, (extent[1] + extent[3]) / 2)
    tilts = [(0.0, 0.0), (0.35, 0.05), (-0.35, 0.0), (0.05, 0.45),
             (0.0, -0.45), (0.3, 0.3), (-0.3, 0.3), (0.3, -0.3),
             (-0.3, -0.3), (0.55, 0.1), (0.1, -0.6), (-0.45, -0.2)]
    plane = _calib_points(target)
    scale = 10.0 / (extent[2] - extent[0])    # every target ~10 units wide
    views, truth = [], []
    for v, (ax, ay) in enumerate(tilts[:CAL_VIEWS]):
        R = _rodrigues([ax, ay, 0.0]) @ _rot_z(np.radians(10 * np.sin(v)))
        t = np.array([0.6 * np.cos(v), 0.5 * np.sin(2 * v),
                      (14.0 + 4.0 * (v % 3) / 2) / scale])
        Hm = _plane_view(CAL_K, R, t, centre)
        img = np.full((H, W), 128.0 if target == "chessboard" else 235.0)
        _render_plane(img, Hm, _calib_shade(target), extent, ss=3)
        pts = _apply_h(Hm, plane)
        if occlude and v == 1:      # a disc 1.3 squares wide, near the middle
            c = pts[len(pts) // 2 - 2]
            r = 1.3 * np.linalg.norm(pts[len(pts) // 2 - 1] - c)
            yy, xx = np.mgrid[0:H, 0:W]
            img[np.hypot(yy - c[1], xx - c[0]) < r] = 128.0
        views.append(img.astype(np.float32))
        truth.append(pts)
    return views, np.stack(truth), plane


def phase_binary(dev) -> None:
    """``binary:`` a 1280x720 frame (``binary_scene``): Otsu, threshold,
    point-noise removal and ``label_blobs`` on the card; its labels against
    the native CCL (compact numbering and the raw minimum-pixel numbering),
    its sweeps and syncs; the native ``contours_with_holes`` against the
    Python tracer."""
    from boofcv_tpu_torch import native
    from boofcv_tpu_torch.ip import binary, threshold
    img = torch.from_numpy(binary_scene()).to(dev)

    def run():
        t = threshold.compute_otsu(img)
        bw = binary.remove_point_noise(threshold.threshold(img, t))
        return t, bw, binary.label_blobs(bw)
    (t, bw, lab), _ = _multiview(
        "binary", f"compute_otsu + threshold + remove_point_noise + "
        f"label_blobs, {REC_W}x{REC_H}, a sync every {binary.CHECK_EVERY} "
        "sweeps", run, dev, reps=5)
    sweeps = collections.Counter()
    pass_fn = binary._min_label_pass

    def counting(*a):
        step = pass_fn(*a)

        def counted(x):
            sweeps[binary.CHECK_EVERY] += 1
            return step(x)
        return counted
    every = binary.CHECK_EVERY
    binary._min_label_pass = counting
    try:
        binary.label_blobs(bw)
        binary.CHECK_EVERY = 1
        lab1, syncs1 = _count_sync_warnings(lambda: binary.label_blobs(bw))
    finally:
        binary._min_label_pass = pass_fn
        binary.CHECK_EVERY = every
    bw_h = bw.cpu().numpy()
    lab_h = lab.cpu().numpy()
    t0 = time.perf_counter()
    ccl, n = native.ccl(bw_h)
    ccl_ms = 1e3 * (time.perf_counter() - t0)
    compact = binary.relabel_compact(lab_h)
    # the raw numbering: a blob's label is its first raster pixel's index + 1
    first = np.unique(ccl.ravel(), return_index=True)[1]
    raw = np.concatenate([[0], first[1:] + 1])[ccl]
    same = (np.array_equal(compact, ccl) and np.array_equal(lab_h, raw)
            and torch.equal(lab1, lab))
    t0 = time.perf_counter()
    cont = binary.contours_with_holes(bw_h)
    nat_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ref = binary.contours_with_holes_reference(bw_h)
    py_ms = 1e3 * (time.perf_counter() - t0)

    def key(blobs):
        return [(b["label"], b["external"].tobytes(),
                 tuple(c.tobytes() for c in b["internal"])) for b in blobs]
    same_cont = key(cont) == key(ref)
    n_holes = sum(len(b["internal"]) for b in cont)
    print(f"binary: accuracy: Otsu {float(t):.6f}, {int(bw.sum())} dark "
          f"pixels, {n} blobs; label_blobs on the card = native CCL "
          f"(compact ids, raw minimum-pixel ids, one check a sweep)={same}; "
          f"sweeps to the fixpoint {sweeps[1]} (the reference's loop: "
          f"{sweeps[1] - 1} trips, {sum(syncs1.values())} syncs), "
          f"{sweeps[every]} sweeps with a check every {every}; native CCL "
          f"on the host {ccl_ms:.3f} ms; native contours_with_holes "
          f"{nat_ms:.3f} ms = the Python tracer ({py_ms:.1f} ms, a CPU "
          f"figure)={same_cont}: {len(cont)} external, {n_holes} internal "
          f"contours")
    check(same and same_cont and n >= 25 and n_holes >= 18,
          "binary: labels or contours differ")


def phase_fiducial(dev) -> None:
    """``fiducial:`` ``detect`` and ``detect_image`` on the 1280x720 frame
    of ``fiducial_scene``; ``estimate_pose`` of every binary marker."""
    from boofcv_tpu_torch.recognition import fiducial_square as fid
    frame, markers, patterns = fiducial_scene()
    img = torch.from_numpy(frame).to(dev)
    dets, _ = _multiview("fiducial", f"detect, {REC_W}x{REC_H}, 8 binary + "
                         "2 image markers", lambda: fid.detect(img), dev,
                         reps=5)
    dets_img, _ = _multiview("fiducial", "detect_image, 2 patterns",
                             lambda: fid.detect_image(img, patterns), dev,
                             reps=5)
    same_cpu = (_same_detection(dets, fid.detect(frame, device="cpu"))
                and _same_detection(dets_img, fid.detect_image(
                    frame, patterns, device="cpu")))
    unit = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    errs, found, reproj, rot_err = [], set(), [], []
    flip = np.diag([-1.0, -1.0, 1.0])        # a half turn about the normal
    for kind, mid, Hm, R, t in markers:
        pool = dets if kind == "binary" else dets_img
        truth = _apply_h(Hm, unit)
        hit = [d for d in pool if d["id"] == mid and np.linalg.norm(
            d["corners"].mean(0) - truth.mean(0)) < 10]
        if not hit:
            continue
        found.add((kind, mid))
        c = hit[0]["corners"]
        if kind == "binary":
            # ordered from the marker's top left, except that a marker read
            # at an odd quarter turn starts at its bottom right (the
            # reference's roll, ROADMAP queue 3)
            odd = hit[0]["rotation"] % 2 == 1
            errs += list(np.linalg.norm(np.roll(c, 2 * odd, 0) - truth,
                                        axis=1))
            Re, te = fid.estimate_pose(c, FID_SIDE, REC_K, device=dev)
            s = FID_SIDE / 2
            world = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0],
                              [-s, s, 0.0]])
            pc = world @ Re.T + te
            proj = (pc / pc[:, 2:]) @ REC_K.T
            reproj += list(np.linalg.norm(proj[:, :2] - c, axis=1))
            Re = Re @ flip if odd else Re
            rot_err.append(np.degrees(np.arccos(np.clip(
                (np.trace(Re.T @ R) - 1) / 2, -1, 1))))
        else:                        # as a set (the rotation is the pattern's)
            d = np.linalg.norm(c[:, None] - truth[None], axis=-1)
            errs += list(d.min(1))
    extra = len(dets) + len(dets_img) - len(found)
    _reset_launches()
    _multiview("fiducial", "estimate_pose of one marker (DLT + 15 GN "
               "iterations)", lambda: fid.estimate_pose(
                   dets[0]["corners"], FID_SIDE, REC_K, device=dev), dev,
               reps=5)
    n_gn = _launches()["gn_pose"]
    rots = sorted({d["rotation"] for d in dets})
    med_err = float(np.median(errs)) if errs else np.inf
    max_err = float(np.max(errs)) if errs else np.inf
    rms = float(np.sqrt(np.mean(np.square(reproj)))) if reproj else np.inf
    print(f"fiducial: accuracy: {len(found)}/10 markers found (ids "
          f"{sorted(m for k, m in found if k == 'binary')}, patterns "
          f"{sorted(m for k, m in found if k == 'image')}), {extra} other "
          f"detections; rotations seen {rots}; corner error against the "
          f"true corners of the 10 markers median {med_err:.4f} px (bar 1), "
          f"max {max_err:.4f} px (bar {FID_MAX_CORNER_PX}: each corner is a "
          f"pixel of the traced contour); estimate_pose reprojection RMS "
          f"{rms:.4f} px (bar 1), max "
          f"{max(reproj, default=np.inf):.4f} px; rotation against the true "
          f"pose max {max(rot_err, default=np.inf):.3f} deg; detections on "
          f"the card = on the CPU (1e-4 px)={same_cpu}; gn_pose launches "
          f"in the timed estimate_pose calls {n_gn}")
    check(n_gn >= 1, "fiducial: estimate_pose's refine did not launch "
                     "gn_pose")
    check(len(found) == 10 and same_cpu and med_err < 1.0
          and max_err < FID_MAX_CORNER_PX and rms < 1.0,
          "fiducial: a marker missed, or corners or pose off")


def phase_qr(dev) -> None:
    """``qr:`` ``detect_and_decode`` of one code of each of
    ``QR_VERSIONS`` in its own 1280x720 frame (``qr_scene``)."""
    from boofcv_tpu_torch.recognition.qr import detector
    ok = []
    for version in QR_VERSIONS:
        frame, text = qr_scene(version)
        img = torch.from_numpy(frame).to(dev)
        (data, info), _ = _multiview(
            "qr", f"detect_and_decode, version {version} level M, "
            f"{len(text)} bytes, {REC_W}x{REC_H}",
            lambda: detector.detect_and_decode(img), dev, reps=5)
        good = data is not None and data.decode() == text
        same_cpu = _same_detection((data, info), detector.detect_and_decode(
            frame, device="cpu"))
        ok.append(good and same_cpu)
        print(f"qr: accuracy: version {version}: decoded exactly={good}, "
              f"version read {info.get('version')}, errors corrected "
              f"{info.get('errors_corrected')}, {info.get('error', '')}; "
              f"result on the card = on the CPU={same_cpu}")
    check(all(ok), "qr: a code not decoded exactly, or card and CPU differ")


def _match_truth(found, truth, radius=2.0) -> tuple:
    """(obs [N, 2], mask [N]): each truth point's nearest found point when
    within ``radius`` px."""
    obs = np.zeros_like(truth)
    mask = np.zeros(len(truth), bool)
    if found is not None and len(found):
        d = np.linalg.norm(truth[:, None] - found[None], axis=-1)
        j = d.argmin(1)
        mask = d[np.arange(len(truth)), j] < radius
        obs[mask] = found[j[mask]]
    return obs, mask


def phase_calib_targets(dev) -> None:
    """``calib_targets:`` 12 640x480 views each of a 9x7 chessboard (auto,
    with view 1 partly occluded, and known size), a 5x7 square grid, a 6x8
    circle grid and a 9x13 hexagonal circle grid, each detector on every
    view, then ``calibrate_mono_planar`` from each target's points.

    Bars, per target (``CAL_BARS``): the share of a view's true points
    found within 0.5 px is printed; the bar holds the share within the
    distance the target's JAX test allows (chessboard 1 px, square grid 2.5,
    circles 1.5) to 0.95 (square grid 0.9; 0.85 on the occluded view), and
    Zhang99 to a focal and an RMSE bar.  View 3's detection on the card
    equals the CPU's within 1e-4 px.  On the chessboard the shares count the
    corners the x-corner detection returned (the nonmax drops a corner
    whose two top pixels differ by less than its tie ramp: ROADMAP queue
    3), and the known-size detector, which needs every corner, must detect
    exactly the views where none was dropped; every other view must be
    detected."""
    from boofcv_tpu_torch.calib import zhang99
    from boofcv_tpu_torch.recognition import calib_targets, chessboard
    runs = [("chessboard_auto", "chessboard", True,
             lambda im: chessboard.detect_chessboard_auto(im)),
            ("chessboard", "chessboard", False,
             lambda im: chessboard.detect_chessboard(im, 7, 9)),
            ("square_grid", "square_grid", False,
             lambda im: calib_targets.detect_square_grid(im, 5, 7)),
            ("circle_grid", "circle_grid", False,
             lambda im: calib_targets.detect_circle_regular_grid(im, 6, 8)),
            ("hex_grid", "hex_grid", False,
             lambda im: calib_targets.detect_circle_hexagonal_grid(im, 9,
                                                                   13))]
    bad = []
    for name, target, occlude, detect in runs:
        px, share_bar, f_bar, rmse_bar = CAL_BARS[target]
        views, truth, plane = calib_scene(target, occlude)
        imgs = [torch.from_numpy(v).to(dev) for v in views]
        out3, _ = _multiview("calib_targets", f"{name}: one {W}x{H} view",
                             lambda: detect(imgs[3]), dev, reps=3)
        same_cpu = _same_detection(out3, detect(torch.from_numpy(views[3])))
        present = np.ones(truth.shape[:2], bool)
        if target == "chessboard":
            present = np.stack([_corners_detected(im, tr)
                                for im, tr in zip(imgs, truth)])
        obs = np.zeros_like(truth)
        mask = np.zeros(truth.shape[:2], bool)
        near, close, missed = [], [], []
        for v, im in enumerate(imgs):
            out = detect(im)
            if out is None:
                missed.append(v)
                continue
            pts = out[0][out[1]] if isinstance(out, tuple) else out
            obs[v], mask[v] = _match_truth(pts, truth[v], max(2.0, px))
            err = np.linalg.norm(obs[v] - truth[v], axis=1)
            close.append(float(np.mean((mask[v] & (err < 0.5))[present[v]])))
            near.append(float(np.mean((mask[v] & (err < px))[present[v]])))
        if name == "chessboard":
            must = [v for v in range(len(imgs)) if present[v].all()]
            ok_views = sorted(set(range(len(imgs))) - set(missed)) == must
        else:
            ok_views = not missed
        err = np.linalg.norm(obs - truth, axis=-1)[mask]
        used = [v for v in range(len(imgs)) if v not in missed]
        fx_e = fy_e = rmse = np.inf
        if len(used) >= 3:
            res = zhang99.calibrate_mono_planar(
                plane, obs[used], obs_mask=mask[used], device=dev)
            fx_e = abs(res.K[0, 0] - CAL_K[0, 0]) / CAL_K[0, 0]
            fy_e = abs(res.K[1, 1] - CAL_K[1, 1]) / CAL_K[1, 1]
            rmse = res.reprojection_rmse
        share_bars = [0.85 if occlude and v == 1 else share_bar
                      for v in used]
        ok = (ok_views and same_cpu
              and all(s >= b for s, b in zip(near, share_bars))
              and fx_e < f_bar and fy_e < f_bar and rmse < rmse_bar)
        among = (f"true corners among the x-corner detections by view "
                 f"{present.sum(1).tolist()} of {truth.shape[1]}; share of "
                 "them" if target == "chessboard" else
                 f"share of the {truth.shape[1]} true points")
        print(f"calib_targets: accuracy: {name}: {len(used)}/{len(imgs)} "
              f"views detected (missed {missed}); {among} found within 0.5 "
              f"px, by "
              f"detected view {[round(c, 4) for c in close]}; within {px} px"
              f" {[round(c, 4) for c in near]} (bar {share_bar}"
              f"{', 0.85 on the occluded view 1' if occlude else ''}); error "
              f"of the matched points median "
              f"{np.median(err) if err.size else np.inf:.4f} max "
              f"{err.max() if err.size else np.inf:.4f} px; Zhang99 from "
              f"{len(used)} views: fx error {fx_e:.6f}, fy {fy_e:.6f} (bars "
              f"{f_bar}), RMSE {rmse:.4f} px (bar {rmse_bar}); view 3 on "
              f"the card = on the CPU (1e-4 px)={same_cpu}")
        if not ok:
            bad.append(name)
    check(not bad, f"calib_targets: {bad} off")


# ---- the rest of ip/ and feature/: colour, FFT, wavelets, enhancement, ----
# ---- MLS, planar; background, segmentation, lines, template, dense, -------
# ---- the object trackers --------------------------------------------------

SLICE_FRAMES = 30                 # background: and trackers: frames
SLIC_SEGMENTS = 400
N_MARKERS = 64                    # watershed seeds, an 8 x 8 grid
TEMPLATE_SIDE = 32


def _host_np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gap(a, b) -> float:
    """Largest absolute difference of two (nested) tensor results."""
    if isinstance(a, (tuple, list)):
        return max(_gap(x, y) for x, y in zip(a, b))
    return float(np.max(np.abs(_host_np(a).astype(np.float64)
                               - _host_np(b).astype(np.float64))))


def smooth_rgb(h, w, seed=0) -> np.ndarray:
    """An [h, w, 3] colour image as a camera sees one: a luma texture
    (grey 40-200) with chroma that varies slowly (+-30, blurred sigma 20),
    so that 4:2:0 subsampling keeps it."""
    from scipy.ndimage import gaussian_filter
    from boofcv_tpu_torch.io import simulate
    rng = np.random.default_rng(seed)
    side = max(h, w)
    luma = simulate.noise_texture(rng, size=side)[:h, :w] / 245.0 * 160 + 40
    chroma = np.stack([gaussian_filter(rng.uniform(-1, 1, (h, w)), 20.0)
                       for _ in range(3)], axis=-1)
    chroma *= 30.0 / np.abs(chroma).max()
    return (luma[..., None] + chroma).astype(np.float32)


def denoise_scene(h=None, w=None, seed=5, sigma=20.0) -> tuple:
    """(clean, noisy) float32: smooth shading with blocks, noise sigma 20."""
    h, w = h or H, w or W
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    clean = (120 + 60 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
             + 40 * ((xx // 32 + yy // 32) % 2)).astype(np.float32)
    noise = np.random.default_rng(seed).normal(0, sigma, clean.shape)
    return clean, (clean + noise).astype(np.float32)


def _psnr(img, clean) -> float:
    return float(10 * np.log10(255.0 ** 2 / np.mean((img - clean) ** 2)))


def phase_ip_rest(dev) -> None:
    """``ip_rest:`` colour round trips at 1280x720; ``filter_frequency`` at
    480x640 against ``numpy.fft``; the three wavelet denoisers, 3 levels,
    on a noisy 640x480 image (the JAX test's bar: MSE below 0.6 of the
    noisy input's); ``equalize_histogram`` (its syncs) and
    ``equalize_local``; ``mls.deform`` with 20 control points; a planar
    3-band blur and Sobel, bit-equal to calls a band.  Each against the
    same call on the CPU."""
    from boofcv_tpu_torch.ip import (blur, color, derivative, enhance, fft,
                                     mls, planar, wavelet)
    rgb = smooth_rgb(REC_H, REC_W, seed=21)

    def trips(t):
        return (color.hsv_to_rgb(color.rgb_to_hsv(t)),
                color.yuv_to_rgb(color.rgb_to_yuv(t)),
                color.lab_to_rgb(color.rgb_to_lab(t / 255.0)) * 255.0,
                color.yuv420_to_rgb(*color.rgb_to_yuv420(t)))
    t = torch.from_numpy(rgb).to(dev)
    outs, _ = _multiview("ip_rest", f"colour round trips HSV, YUV, Lab, YUV "
                         f"4:2:0 of {REC_W}x{REC_H}", lambda: trips(t), dev,
                         reps=5)
    cpu = trips(torch.from_numpy(rgb))
    errs = [float(np.abs(_host_np(o) - rgb).max()) for o in outs[:3]]
    e420 = float(np.abs(_host_np(outs[3]) - rgb).mean())
    gap = _gap(outs, cpu)
    print(f"ip_rest: accuracy: colour round trips max error HSV "
          f"{errs[0]:.3e} (bar 1e-3), YUV {errs[1]:.3e} (bar 0.1: "
          f"ColorYuv's two coefficient sets invert to 2e-4), Lab "
          f"{errs[2]:.3e} (bar 1e-2) grey levels, YUV 4:2:0 mean error "
          f"{e420:.4f} (bar 0.5, the JAX test's); card against the CPU max "
          f"{gap:.3e} (bar 1e-3)")
    check(errs[0] < 1e-3 and errs[1] < 0.1 and errs[2] < 1e-2
          and e420 < 0.5 and gap < 1e-3, "ip_rest: colour round trips off")

    img = smooth_rgb(H, W, seed=22)[..., 0]
    tr = fft.gaussian_lowpass_transfer(H, W, 0.2, device=dev)
    ti = torch.from_numpy(img).to(dev)
    out, _ = _multiview("ip_rest", f"filter_frequency {W}x{H} (float32 "
                        "spectrum, float64 transfer)",
                        lambda: fft.filter_frequency(ti, tr), dev, reps=5)
    want = np.real(np.fft.ifft2(np.fft.fft2(img.astype(np.float64))
                                * _host_np(tr)))
    cpu = fft.filter_frequency(torch.from_numpy(img), tr.cpu())
    err, gap = _gap(out, want), _gap(out, cpu)
    print(f"ip_rest: accuracy: filter_frequency against numpy.fft (float64) "
          f"max {err:.3e} grey levels (bar 1e-3), card against the CPU "
          f"{gap:.3e} (bar 1e-3)")
    check(err < 1e-3 and gap < 1e-3, "ip_rest: filter_frequency off")

    clean, noisy = denoise_scene()
    tn = torch.from_numpy(noisy).to(dev)
    for rule in ("denoise_visu", "denoise_bayes", "denoise_sure"):
        fn = getattr(wavelet, rule)
        den, _ = _multiview("ip_rest", f"{rule} haar, 3 levels, {W}x{H}",
                            lambda fn=fn: fn(tn, levels=3), dev, reps=5)
        cpu = fn(torch.from_numpy(noisy), levels=3).numpy()
        d = _host_np(den)
        mse_in = float(np.mean((noisy - clean) ** 2))
        mse = float(np.mean((d - clean) ** 2))
        gain = _psnr(d, clean) - _psnr(noisy, clean)
        cgain = _psnr(cpu, clean) - _psnr(noisy, clean)
        print(f"ip_rest: accuracy: {rule}: PSNR {_psnr(noisy, clean):.3f} "
              f"-> {_psnr(d, clean):.3f} dB (gain {gain:.4f} dB; MSE "
              f"{mse_in:.2f} -> {mse:.2f}, bar below 0.6 of it, the JAX "
              f"test's); CPU gain {cgain:.4f} dB (bar: within 0.01 dB), "
              f"card against the CPU max {_gap(d, cpu):.3e}")
        check(mse < 0.6 * mse_in and abs(gain - cgain) < 0.01,
              f"ip_rest: {rule} off")

    low = np.round(img * 0.3 + 80).astype(np.float32)
    tl = torch.from_numpy(low).to(dev)
    eq, _ = _multiview("ip_rest", f"equalize_histogram {W}x{H} (integer "
                       "scatter_add_ histogram)",
                       lambda: enhance.equalize_histogram(tl), dev, reps=5)
    _, syncs = _count_sync_warnings(lambda: enhance.equalize_histogram(tl))
    loc, _ = _multiview("ip_rest", f"equalize_local radius 2 {W}x{H} (25 "
                        "shifted compares)",
                        lambda: enhance.equalize_local(tl, 2), dev, reps=5)
    same = (np.array_equal(_host_np(eq), enhance.equalize_histogram(
        torch.from_numpy(low)).numpy())
            and np.array_equal(_host_np(loc), enhance.equalize_local(
                torch.from_numpy(low), 2).numpy()))
    print(f"ip_rest: accuracy: equalize_histogram range [{low.min():.0f}, "
          f"{low.max():.0f}] -> [{float(eq.min()):.0f}, "
          f"{float(eq.max()):.0f}], host syncs {sum(syncs.values())} (a "
          f"bincount takes 2); equalize_histogram and equalize_local on the "
          f"card = on the CPU: {same}")
    check(same and sum(syncs.values()) == 0 and float(eq.max()) > 250,
          "ip_rest: equalization off")

    rng = np.random.default_rng(23)
    src = np.stack([rng.uniform(40, W - 40, 20), rng.uniform(40, H - 40, 20)],
                   1).astype(np.float32)
    # whole-pixel targets: the backward map at each must be its source
    dst = np.round(src + rng.normal(0, 6, src.shape)).astype(np.float32)
    warped, _ = _multiview("ip_rest", f"mls.deform affine, 20 control "
                           f"points, {W}x{H}",
                           lambda: mls.deform(ti, src, dst), dev, reps=5)
    my, mx = mls.mls_affine(src, dst, H, W, device=dev)
    at = dst.astype(int)
    land = float(np.max(np.hypot(_host_np(mx)[at[:, 1], at[:, 0]] - src[:, 0],
                                 _host_np(my)[at[:, 1], at[:, 0]]
                                 - src[:, 1])))
    cpu = mls.deform(torch.from_numpy(img), src, dst, device="cpu").numpy()
    diff = np.abs(_host_np(warped) - cpu)
    print(f"ip_rest: accuracy: mls.deform: the maps carry each control point "
          f"within {land:.3e} px of its source (bar 0.05); card against the "
          f"CPU within 0.05 grey levels on {np.mean(diff <= 0.05):.6f} of "
          f"the pixels (bar 0.999), max {diff.max():.3e}")
    check(land < 0.05 and np.mean(diff <= 0.05) >= 0.999,
          "ip_rest: mls.deform off")

    rgb = torch.from_numpy(smooth_rgb(H, W, seed=24)).to(dev)
    blurred, _ = _multiview("ip_rest", f"planar.per_band(blur.gaussian, "
                            f"sigma 2), 3 bands {W}x{H} (a call a band)",
                            lambda: planar.per_band(blur.gaussian, rgb,
                                                    sigma=2.0), dev, reps=5)
    (dx, dy), _ = _multiview("ip_rest", f"planar.per_band(derivative.sobel),"
                             f" 3 bands {W}x{H} (one call, the bands a batch)",
                             lambda: planar.per_band(derivative.sobel, rgb),
                             dev, reps=5)
    bit = all(torch.equal(blurred[..., c], blur.gaussian(rgb[..., c],
                                                         sigma=2.0))
              and torch.equal(dx[..., c], derivative.sobel(rgb[..., c])[0])
              and torch.equal(dy[..., c], derivative.sobel(rgb[..., c])[1])
              for c in range(3))
    print(f"ip_rest: accuracy: planar blur and Sobel bit-equal to the calls "
          f"a band on the card: {bit}")
    check(bit, "ip_rest: planar differs from the calls a band")


def background_scene(n=SLICE_FRAMES, learn=20, seed=31, h=None, w=None):
    """Static camera: (frames, truth masks), a smooth texture with sensor
    noise sigma 2; after ``learn`` clean frames a 48 px square 100 grey
    levels brighter crosses, 50 px a frame."""
    from boofcv_tpu_torch.io import simulate
    h, w = h or H, w or W
    rng = np.random.default_rng(seed)
    bg = simulate.noise_texture(rng, size=max(h, w))[:h, :w]
    frames, masks = [], []
    for i in range(n):
        f = bg + rng.normal(0, 2, bg.shape).astype(np.float32)
        m = np.zeros((h, w), bool)
        if i >= learn:
            x0 = 40 + 50 * (i - learn)
            m[h // 2 - 24:h // 2 + 24, x0:x0 + 48] = True
            f[m] += 100.0
        frames.append(f.astype(np.float32))
        masks.append(m)
    return frames, masks


def _world(xs, ys):
    """The panning scene's world: smooth shading, exact at any point."""
    return (128 + 45 * np.sin(xs / 7.0) * np.cos(ys / 11.0)
            + 30 * np.sin((xs + 2 * ys) / 17.0)
            + 20 * np.cos((3 * xs - ys) / 29.0)).astype(np.float32)


def moving_background_scene(n=SLICE_FRAMES, learn=20, pan=3.5, h=None,
                            w=None):
    """Panning camera: (frames, home->current homographies, truth masks,
    home shape): frame t shows the world at x + pan t; after ``learn``
    frames a 40 px square of 250 crosses the view."""
    h, w = h or H, w or W
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    frames, hs, masks = [], [], []
    for i in range(n):
        f = _world(xs + pan * i, ys)
        m = np.zeros((h, w), bool)
        if i >= learn:
            x0 = 60 + 45 * (i - learn)
            m[h // 3:h // 3 + 40, x0:x0 + 40] = True
            f[m] = 250.0
        frames.append(f)
        hs.append(np.array([[1.0, 0.0, -pan * i], [0.0, 1.0, 0.0],
                            [0.0, 0.0, 1.0]]))
        masks.append(m)
    return frames, hs, masks, (h, int(w + pan * n) + 2)


def _mask_bars(seg, truth) -> tuple:
    """(share of the truth detected, false-positive share of the other
    known pixels, IoU) of a 0/1/2 segmentation."""
    det = seg == 1
    known = seg != 2
    cover = float(det[truth].mean())
    fp = float(det[~truth & known].mean())
    return cover, fp, float((det & truth).sum() / max((det | truth).sum(),
                                                       1))


def phase_background(dev) -> None:
    """``background:`` 30 frames of 640x480: the basic, Gaussian and GMM
    models of a static camera, and their moving-camera variants under a
    known homography a frame; each segments every frame with the square
    before it learns it.  Bars, the JAX tests': the square detected on
    95 % of its pixels (GMM and the moving models 90 %), false positives
    under 5 % (moving: 10 %, 20 % for Gaussian and GMM); the card's masks
    equal the CPU's; ms per update and per segment."""
    from boofcv_tpu_torch.feature import background as bg
    frames, masks = background_scene()
    mframes, hs, mmasks, home = moving_background_scene()
    static = {"basic": (bg.basic_init, bg.basic_update, bg.basic_segment,
                        0.95, 0.05),
              "gaussian": (bg.gaussian_init, bg.gaussian_update,
                           bg.gaussian_segment, 0.95, 0.05),
              "gmm": (bg.gmm_init, bg.gmm_update, bg.gmm_segment, 0.9,
                      0.05)}
    moving = {"moving_basic": (bg.moving_init, bg.moving_basic_update,
                               bg.moving_basic_segment, 0.9, 0.1),
              "moving_gaussian": (bg.moving_gaussian_init,
                                  bg.moving_gaussian_update,
                                  bg.moving_gaussian_segment, 0.9, 0.2),
              "moving_gmm": (bg.moving_gmm_init, bg.moving_gmm_update,
                             bg.moving_gmm_segment, 0.9, 0.2)}
    bad = []

    def run(name, spec, device, imgs, hms, truth):
        init, update, segment, _, _ = spec
        imgs = [torch.from_numpy(f).to(device) for f in imgs]
        hm = [None] * len(imgs) if hms is None else [
            torch.from_numpy(x).to(device) for x in hms]
        extra = (lambda i: ()) if hms is None else (lambda i: (hm[i],))
        model = (init(imgs[0]) if hms is None else init(home, device=device))
        segs = []
        for i in range(len(imgs)):
            if truth[i].any():
                segs.append(_host_np(segment(model, imgs[i], *extra(i))))
            model = update(model, imgs[i], *extra(i))
        return model, segs, imgs, hm

    for name, spec in list(static.items()) + list(moving.items()):
        hms = None if name in static else hs
        src, truth = (frames, masks) if name in static else (mframes, mmasks)
        model, segs, imgs, hm = run(name, spec, dev, src, hms, truth)
        _, cpu_segs, _, _ = run(name, spec, "cpu", src, hms, truth)
        extra = () if hms is None else (hm[-1],)
        _multiview("background", f"{name} update {W}x{H}",
                   lambda: spec[1](model, imgs[-1], *extra), dev, reps=5)
        _multiview("background", f"{name} segment {W}x{H}",
                   lambda: spec[2](model, imgs[-1], *extra), dev, reps=5)
        bars = [_mask_bars(s, m) for s, m in zip(segs, [m for m in truth
                                                        if m.any()])]
        cover = min(b[0] for b in bars)
        fp = max(b[1] for b in bars)
        iou = float(np.mean([b[2] for b in bars]))
        same = float(np.mean([np.mean(a == b) for a, b in zip(segs,
                                                              cpu_segs)]))
        ok = cover >= spec[3] and fp < spec[4] and same >= 0.9999
        print(f"background: accuracy: {name}: over the {len(segs)} frames "
              f"with the square, detected share min {cover:.4f} (bar "
              f"{spec[3]}), false positives max {fp:.4f} (bar {spec[4]}), "
              f"mean IoU {iou:.4f}; masks on the card = on the CPU on "
              f"{same:.6f} of the pixels (bar 0.9999)")
        if not ok:
            bad.append(name)
    check(not bad, f"background: {bad} off")


def segmentation_scene(h=None, w=None, seed=41) -> tuple:
    """(colour image [h, w, 3] float32 integer-valued, truth regions):
    flat colour rectangles of a jittered 6 x 8 grid and 6 disks over them,
    noise sigma 2, rounded."""
    h, w = h or H, w or W
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ys = np.sort(np.concatenate([[0], rng.choice(np.arange(30, h - 30), 5,
                                                  replace=False), [h]]))
    xs = np.sort(np.concatenate([[0], rng.choice(np.arange(30, w - 30), 7,
                                                  replace=False), [w]]))
    region = (np.searchsorted(ys, yy, side="right") - 1) * 8 + (
        np.searchsorted(xs, xx, side="right") - 1)
    for k in range(6):
        cy, cx, r = rng.uniform(60, h - 60), rng.uniform(60, w - 60), \
            rng.uniform(25, 55)
        region[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 100 + k
    _, region = np.unique(region, return_inverse=True)
    region = region.reshape(h, w)
    colours = rng.uniform(20, 235, (region.max() + 1, 3))
    img = colours[region] + rng.normal(0, 2.0, (h, w, 3))
    return np.clip(np.round(img), 0, 255).astype(np.float32), region


def _boundary(labels) -> np.ndarray:
    b = np.zeros(labels.shape, bool)
    b[:, 1:] |= labels[:, 1:] != labels[:, :-1]
    b[1:, :] |= labels[1:, :] != labels[:-1, :]
    return b


def _recall(truth, labels, tol=2) -> float:
    """Share of the true boundary pixels within ``tol`` px of a boundary of
    ``labels`` (boundary recall)."""
    from scipy.ndimage import binary_dilation
    near = binary_dilation(_boundary(labels), iterations=tol)
    tb = _boundary(truth)
    return float(near[tb].mean())


def phase_segmentation(dev) -> None:
    """``segmentation:`` the 640x480 colour scene of ``segmentation_scene``:
    ``slic`` with 400 segments (boundary recall against the truth, labels
    on the card against the CPU's); ``segment_mean_shift`` of its grey
    version (the native merge's host time); ``watershed`` from 64 markers
    on the gradient (trips, reads of its flag, syncs; equal to the CPU's);
    ``segment_fh04`` (the native merge equals ``_fh04_merge_numpy`` on a
    160x120 window of the same weights; the regions of 500 px or more
    against the truth's, and their purity)."""
    from boofcv_tpu_torch import native
    from boofcv_tpu_torch.feature import segmentation as seg
    from boofcv_tpu_torch.ip import derivative
    img, truth = segmentation_scene()
    ti = torch.from_numpy(img).to(dev)
    lab, _ = _multiview("segmentation", f"slic {SLIC_SEGMENTS} segments, 10 "
                        f"iterations, {W}x{H} colour", lambda: seg.slic(
                            ti, SLIC_SEGMENTS), dev, reps=3)
    lab = _host_np(lab)
    cpu = seg.slic(torch.from_numpy(img), SLIC_SEGMENTS).numpy()
    recall = _recall(truth, lab)
    agree = float(np.mean(lab == cpu))
    print(f"segmentation: accuracy: slic: {len(np.unique(lab))} segments, "
          f"boundary recall {recall:.4f} within 2 px (bar 0.9); labels on "
          f"the card = on the CPU on {agree:.6f} of the pixels (bar 0.99: "
          f"the centre sums' order is cuBLAS's)")
    check(recall >= 0.9 and agree >= 0.99, "segmentation: slic off")

    gray = img.mean(axis=2).astype(np.float32)
    tg = torch.from_numpy(gray).to(dev)
    (ms_lab, filt), _ = _multiview(
        "segmentation", f"segment_mean_shift radius 3, 5 iterations, "
        f"{W}x{H} grey (filter on the card, native merge on the host)",
        lambda: seg.segment_mean_shift(tg), dev, reps=3)
    flat = _host_np(filt)
    t0 = time.perf_counter()
    right, down = seg._similar(flat, 8.0)
    roots = native.mean_shift_merge(right, down)
    merge_ms = 1e3 * (time.perf_counter() - t0)
    cpu_lab, cpu_filt = seg.segment_mean_shift(torch.from_numpy(gray))
    fgap = _gap(filt, cpu_filt)
    same_merge = np.array_equal(seg._labels_from_roots(roots), ms_lab)
    agree = float(np.mean(ms_lab == cpu_lab))
    print(f"segmentation: accuracy: segment_mean_shift: {ms_lab.max() + 1} "
          f"regions; the native merge on the host {merge_ms:.3f} ms (masks "
          f"and union-find, 307,200 pixels); filtered card against the CPU "
          f"max {fgap:.3e} (bar 1e-2), labels equal on {agree:.6f} of the "
          f"pixels (bar 0.99), the merge repeated = the call's: "
          f"{same_merge}")
    check(fgap < 1e-2 and agree >= 0.99 and same_merge,
          "segmentation: segment_mean_shift off")

    dx, dy = derivative.sobel(tg)
    height = torch.hypot(dx, dy)
    markers = np.zeros((H, W), np.int32)
    for k, (y, x) in enumerate(np.stack(np.meshgrid(
            np.linspace(30, H - 30, 8).astype(int),
            np.linspace(40, W - 40, 8).astype(int), indexing="ij"),
            -1).reshape(-1, 2)):
        markers[y, x] = k + 1
    tm = torch.from_numpy(markers).to(dev)
    ws, _ = _multiview("segmentation", f"watershed {N_MARKERS} markers "
                       f"{W}x{H}, the flag read every "
                       f"{seg.WATERSHED_CHECK_EVERY} trips of 8 relaxations",
                       lambda: seg.watershed(height, tm), dev, reps=3)
    (_, trips, run, reads), syncs = _count_sync_warnings(
        lambda: seg._watershed(height, tm))
    cpu = seg.watershed(height.cpu(), torch.from_numpy(markers))
    same = torch.equal(ws.cpu(), cpu)
    print(f"segmentation: accuracy: watershed: the reference's loop makes "
          f"{trips} trips ({trips} syncs); the port ran {run} trips with "
          f"{reads} reads of the flag, host syncs {sum(syncs.values())} "
          f"{dict(sorted(syncs.items()))}; every pixel labelled: "
          f"{bool((ws > 0).all())}; card = CPU: {same}")
    check(same and bool((ws > 0).all()), "segmentation: watershed off")

    (fh, n), _ = _multiview("segmentation", f"segment_fh04 k 300, min size "
                            f"200, {W}x{H} colour (weights on the card, "
                            "native merge on the host)",
                            lambda: seg.segment_fh04(ti, k=300.0,
                                                     min_size=200), dev,
                            reps=3)
    ws4 = [_host_np(w_)[:120, :160].copy()
           for w_ in seg.fh04_edge_weights(ti)]
    t0 = time.perf_counter()
    nat, nn = native.fh04_merge(*ws4, k=300.0, min_size=50)
    nat_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ref, rn = seg._fh04_merge_numpy(*ws4, 300.0, 50)
    np_ms = 1e3 * (time.perf_counter() - t0)
    cpu, cn = seg.segment_fh04(torch.from_numpy(img), k=300.0, min_size=200)
    same = np.array_equal(nat, ref) and nn == rn
    # thin strips along the blurred edges come back as regions of their
    # own: count the regions of 500 px and more on both sides
    big = int((np.bincount(fh.ravel()) >= 500).sum())
    big_true = int((np.bincount(truth.ravel()) >= 500).sum())
    purity = sum(np.bincount(truth[fh == r]).max() for r in range(n)) \
        / fh.size
    print(f"segmentation: accuracy: segment_fh04: {n} regions, {big} of "
          f"500 px or more against {big_true} true ones (bar within 20 %), "
          f"purity {purity:.4f} (bar 0.95); on the card's weights "
          f"of a 160x120 window the native merge ({nat_ms:.3f} ms) = "
          f"_fh04_merge_numpy ({np_ms:.1f} ms, host): {same} ({nn} "
          f"regions); labels on the card = on the CPU on "
          f"{np.mean(fh == cpu):.6f} of the pixels (bar 0.99)")
    check(same and abs(big - big_true) <= 0.2 * big_true
          and purity >= 0.95 and np.mean(fh == cpu) >= 0.99,
          "segmentation: segment_fh04 off")


def _rasterize(h, w, rho, theta) -> np.ndarray:
    """1-px line of normal angle theta at signed distance rho from the
    image centre (the Hough convention)."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = np.mgrid[0:h, 0:w]
    return np.abs((xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
                  - rho) < 0.5


LINES_TRUE = ((-150.0, 0.2), (40.0, 0.9), (120.0, 1.6), (-60.0, 2.3),
              (200.0, 2.9), (-10.0, 0.05))      # (rho px, theta rad)
POLYGON = ((140.0, 120.0), (420.0, 100.0), (560.0, 260.0), (470.0, 420.0),
           (160.0, 400.0))                      # convex, (x, y), clockwise


def polygon_scene(h=None, w=None, seed=51, ss=4) -> tuple:
    """(image, edges [((x0, y0), (x1, y1))]): a bright convex pentagon on a
    dark ground, its edges antialiased (``ss`` x ``ss`` samples a pixel),
    noise sigma 2."""
    h, w = h or H, w or W
    sy, sx = h / 480.0, w / 640.0
    pts = [(x * sx, y * sy) for x, y in POLYGON]
    off = (np.arange(ss) + 0.5) / ss - 0.5
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    edges = list(zip(pts, pts[1:] + pts[:1]))
    cover = np.zeros((h, w))
    for oy in off:
        for ox in off:
            inside = np.ones((h, w), bool)
            for (x0, y0), (x1, y1) in edges:
                inside &= ((x1 - x0) * (yy + oy - y0)
                           - (y1 - y0) * (xx + ox - x0)) >= 0
            cover += inside
    img = 50.0 + 150.0 * cover / ss ** 2 + np.random.default_rng(
        seed).normal(0, 2.0, (h, w))
    return img.astype(np.float32), edges


def _polar(edge, h, w) -> tuple:
    """(rho, theta in [0, pi)) of the line through an edge, about the image
    centre."""
    (x0, y0), (x1, y1) = edge
    theta = np.arctan2(-(x1 - x0), y1 - y0) % np.pi
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    return (x0 - cx) * np.cos(theta) + (y0 - cy) * np.sin(theta), theta


def _lines_found(res, truth, rho_tol=1.5, theta_tol=np.radians(1.5)):
    """[N] for each true (rho, theta): the closest found line's (drho,
    dtheta), with theta compared mod pi (rho's sign flips over the
    wrap)."""
    v = _host_np(res.valid)
    rho = _host_np(res.rho)[v].astype(np.float64)
    th = _host_np(res.theta)[v].astype(np.float64)
    out = []
    for r0, t0 in truth:
        d = []
        for r, t in zip(rho, th):
            dt = abs(t - t0)
            if dt > np.pi / 2:
                d.append((abs(-r - r0), np.pi - dt))
            else:
                d.append((abs(r - r0), dt))
        out.append(min(d, key=lambda x: x[0] / rho_tol + x[1] / theta_tol,
                       default=(np.inf, np.inf)))
    return out


def _line_gap(a, b, rho_bin: float) -> tuple:
    """(same count, the largest distance in (rho, theta) bins from a line of
    ``a`` to the nearest line of ``b``).  theta bins are 1 deg."""
    va, vb = _host_np(a.valid), _host_np(b.valid)
    ra, ta = _host_np(a.rho)[va], _host_np(a.theta)[va]
    rb, tb = _host_np(b.rho)[vb], _host_np(b.theta)[vb]
    worst = 0.0
    for r, t in zip(ra, ta):
        d = np.maximum(np.abs(rb - r) / rho_bin,
                       np.abs(tb - t) / np.radians(1.0))
        worst = max(worst, float(d.min()) if d.size else np.inf)
    return va.sum() == vb.sum(), worst


def phase_lines(dev) -> None:
    """``lines:`` 640x480 scenes with planted lines: ``hough_binary`` of six
    1-px lines (180 x 801 bins), ``hough_gradient`` of a pentagon's five
    edges (180 x 401 bins, 1.5 px and 2 deg), ``grid_ransac_lines`` +
    ``connect_segments`` on the pentagon with hypothesis pairs drawn on the
    CPU from a generator seeded 0 and passed to both devices.  Bars: every planted line within 1.5 px and
    1.5 deg; every pentagon edge covered by a connected segment within 2
    deg and 3 px spanning half of it; the card's lines within a bin of the
    CPU's, its segments equal."""
    from boofcv_tpu_torch.feature import lines
    bw = np.zeros((H, W), np.uint8)
    for rho, theta in LINES_TRUE:
        bw |= _rasterize(H, W, rho, theta)
    tb = torch.from_numpy(bw).to(dev)
    res, _ = _multiview("lines", f"hough_binary 180 x 801 bins, {W}x{H}, "
                        f"{int(bw.sum())} edge pixels",
                        lambda: lines.hough_binary(tb, n_rho=801,
                                                   max_lines=6,
                                                   peak_radius=3),
                        dev, reps=5)
    cpu = lines.hough_binary(torch.from_numpy(bw), n_rho=801, max_lines=6,
                             peak_radius=3)
    found = _lines_found(res, LINES_TRUE)
    ok_b = all(dr <= 1.5 and dt <= np.radians(1.5) for dr, dt in found)
    img, edges = polygon_scene()
    ti = torch.from_numpy(img).to(dev)
    truth = [_polar(e, H, W) for e in edges]
    gres, _ = _multiview("lines", f"hough_gradient 180 x 401 bins, {W}x{H}",
                         lambda: lines.hough_gradient(
                             ti, n_rho=401, max_lines=5, peak_radius=3,
                             edge_threshold=100.0), dev, reps=5)
    gcpu = lines.hough_gradient(torch.from_numpy(img), n_rho=401,
                                max_lines=5, peak_radius=3,
                                edge_threshold=100.0)
    gfound = _lines_found(gres, truth)
    # each pixel votes at its truncated Sobel angle: up to a bin (1 deg) low
    ok_g = all(dr <= 1.5 and dt <= np.radians(2.0) for dr, dt in gfound)
    # the card's float64 cos and sin round otherwise than the CPU's: a
    # vote on a bin edge may move to the next bin, and a peak with it
    max_r = float(np.hypot(H - 1, W - 1)) / 2.0
    nb, gb = _line_gap(res, cpu, 2 * max_r / 800), _line_gap(gres, gcpu,
                                                             2 * max_r / 400)
    same = nb[0] and gb[0] and max(nb[1], gb[1]) <= 1.0
    worst = lambda f: (max(x[0] for x in f), np.degrees(max(x[1]
                                                            for x in f)))
    print(f"lines: accuracy: hough_binary: the 6 planted lines found within "
          f"{worst(found)[0]:.3f} px and {worst(found)[1]:.3f} deg (bars 1.5 "
          f"px, 1.5 deg); hough_gradient: the pentagon's 5 edges within "
          f"{worst(gfound)[0]:.3f} px and {worst(gfound)[1]:.3f} deg (bars "
          f"1.5 px, 2 deg); lines on the card within {nb[1]:.3f} and "
          f"{gb[1]:.3f} bins of the CPU's (bar 1): {same}")
    check(ok_b and ok_g and same, "lines: a planted line missed")

    nreg = (H // 32) * (W // 32)
    pairs = torch.randint(0, 48, (nreg, 64, 2),
                          generator=torch.Generator().manual_seed(0))
    pd = pairs.to(dev)

    def grid():
        segs = lines.grid_ransac_lines(ti, pair_idx=pd)
        return segs, lines.connect_segments(segs, dist_tol=3.0)
    (segs, merged), _ = _multiview(
        "lines", f"grid_ransac_lines ({nreg} regions of 32 px, 64 "
        f"hypotheses, 2 rounds) + connect_segments on the host, {W}x{H}",
        grid, dev, reps=5)
    csegs = lines.grid_ransac_lines(torch.from_numpy(img), pair_idx=pairs)
    same = (torch.equal(segs.valid.cpu(), csegs.valid)
            and torch.equal(segs.inliers.cpu(), csegs.inliers)
            and max(_gap(getattr(segs, f)[segs.valid],
                         getattr(csegs, f)[csegs.valid])
                    for f in ("x0", "y0", "x1", "y1")) < 1e-3)
    cover = []
    for (x0, y0), (x1, y1) in edges:
        length = np.hypot(x1 - x0, y1 - y0)
        ux, uy = (x1 - x0) / length, (y1 - y0) / length
        best = 0.0
        for a, b, c, d in zip(merged.x0, merged.y0, merged.x1, merged.y1):
            seg_len = np.hypot(c - a, d - b)
            ang = abs(np.arctan2(d - b, c - a) - np.arctan2(uy, ux)) % np.pi
            ang = min(ang, np.pi - ang)
            off = max(abs((a - x0) * uy - (b - y0) * ux),
                      abs((c - x0) * uy - (d - y0) * ux))
            if ang <= np.radians(2.0) and off <= 3.0:
                best = max(best, seg_len / length)
        cover.append(best)
    print(f"lines: accuracy: grid_ransac_lines: {int(segs.valid.sum())} "
          f"fragments, connected into {len(merged.x0)} segments; each "
          f"pentagon edge's longest matching segment spans "
          f"{[round(float(c), 3) for c in cover]} of it (bar 0.5, within 2 "
          f"deg and 3 px); fragments on the card = on the CPU (1e-3 px): {same}")
    check(min(cover) >= 0.5 and same, "lines: grid-RANSAC segments off")


def template_scene(seed=61) -> tuple:
    """(noisy image, template, (ty, tx)): a 640x480 noise texture with
    noise sigma 2, the 32x32 template cut from the clean image."""
    from boofcv_tpu_torch.io import simulate
    rng = np.random.default_rng(seed)
    clean = simulate.noise_texture(rng, size=W)[:H, :W]
    ty, tx = 201, 333
    tmpl = clean[ty:ty + TEMPLATE_SIDE, tx:tx + TEMPLATE_SIDE].copy()
    noisy = clean + rng.normal(0, 2.0, clean.shape).astype(np.float32)
    return noisy.astype(np.float32), tmpl, (ty, tx)


def phase_template(dev) -> None:
    """``template:`` a 32x32 template in a 640x480 texture: ``match_ssd``,
    ``match_sad`` and ``match_ncc`` with ``find_matches`` find the planted
    location exactly, on the card as on the CPU; the correlation as one
    ``F.conv2d`` (float32, TF32 off) timed beside 1,024 shifted adds."""
    from boofcv_tpu_torch.feature import template
    img, tmpl, where = template_scene()
    ti = torch.from_numpy(img).to(dev)
    tt = torch.from_numpy(tmpl).to(dev)
    found = {}
    for name in ("match_ssd", "match_sad", "match_ncc"):
        fn = getattr(template, name)

        def run(fn=fn):
            score = fn(ti, tt)
            return score, template.find_matches(score, max_matches=1)
        (score, det), _ = _multiview("template", f"{name} + find_matches, "
                                     f"{TEMPLATE_SIDE}x{TEMPLATE_SIDE} in "
                                     f"{W}x{H}", run, dev, reps=5)
        cpu = fn(torch.from_numpy(img), torch.from_numpy(tmpl))
        span = float(cpu.max() - cpu.min())
        found[name] = ((int(det.ys[0]), int(det.xs[0])),
                       _gap(score, cpu) / span)
    conv = template._valid_correlate(ti, tt)
    shifted = template._valid_correlate_shifted(ti, tt)
    conv_ms = _solve_ms(lambda: template._valid_correlate(ti, tt))
    shift_ms = _solve_ms(lambda: template._valid_correlate_shifted(ti, tt),
                         reps=3)
    rel = _gap(conv, shifted) / float(shifted.abs().max())
    print(f"template: accuracy: peaks {({k: v[0] for k, v in found.items()})}"
          f" against the planted {where}; score maps card against the CPU "
          f"{({k: f'{v[1]:.2e}' for k, v in found.items()})} of their range "
          f"(bar 1e-5); the correlation: F.conv2d median "
          f"{np.median(conv_ms):.3f} ms, 1,024 shifted adds median "
          f"{np.median(shift_ms):.3f} ms (CUDA events), equal to "
          f"{rel:.2e} of the largest value (bar 1e-5)")
    check(all(v[0] == where and v[1] < 1e-5 for v in found.values())
          and rel < 1e-5, "template: a peak off the planted location")


def phase_dense(dev) -> None:
    """``dense:`` ``hog`` (cell 8, 2x2 blocks, 9 bins, float64) and
    ``dense_sift`` (cell 8, step 8) of a 640x480 texture, card against
    CPU."""
    from boofcv_tpu_torch.feature import dense
    img, _, _ = template_scene(seed=71)
    ti = torch.from_numpy(img).to(dev)
    hog, _ = _multiview("dense", f"hog cell 8, 2x2 blocks, 9 bins, {W}x{H}",
                        lambda: dense.hog(ti), dev, reps=5)
    (ys, xs, desc), _ = _multiview("dense", f"dense_sift cell 8, step 8, "
                                   f"{W}x{H}", lambda: dense.dense_sift(ti),
                                   dev, reps=5)
    chog = dense.hog(torch.from_numpy(img)).numpy()
    _, _, cdesc = dense.dense_sift(torch.from_numpy(img))
    hdiff = np.abs(_host_np(hog) - chog).max(axis=-1)
    ddiff = np.abs(_host_np(desc) - cdesc.numpy()).max(axis=-1)
    norms = np.linalg.norm(_host_np(desc), axis=1)
    print(f"dense: accuracy: hog {tuple(hog.shape)} blocks, card against "
          f"the CPU within 1e-6 on {np.mean(hdiff <= 1e-6):.6f} of them "
          f"(bar 0.999; a gradient angle on a bin edge rounds either way), "
          f"max {hdiff.max():.3e}; dense_sift {len(ys)} descriptors of "
          f"norm {norms.min():.6f}-{norms.max():.6f}, within 1e-4 of the "
          f"CPU's on {np.mean(ddiff <= 1e-4):.6f} of them (bar 0.99), max "
          f"{ddiff.max():.3e}")
    check(np.mean(hdiff <= 1e-6) >= 0.999 and np.mean(ddiff <= 1e-4) >= 0.99
          and abs(norms - 1).max() < 1e-4, "dense: card differs from CPU")


TRACK_SIDE = 64                   # the target's side (px)
TRACK_V = (1, 2)                  # its motion a frame (dy, dx)


def tracker_scene(n=SLICE_FRAMES + 1, seed=81) -> tuple:
    """(frames, true centres): a 64 px target moving (1, 2) px a frame (the
    JAX tests' speeds) over a smooth dark 640x480 texture (grey 10-90):
    bright at its centre (grey 240), dimmer to its edges (110), with
    texture of +-19 (enough for KLT and the correlation filter, little
    enough for the histograms)."""
    from boofcv_tpu_torch.io import simulate
    rng = np.random.default_rng(seed)
    ground = simulate.noise_texture(rng, size=W)[:H, :W] / 245.0 * 80 + 10
    r = np.hypot(*(np.mgrid[0:TRACK_SIDE, 0:TRACK_SIDE]
                   - (TRACK_SIDE - 1) / 2.0))
    target = (110 + 130 * np.exp(-0.5 * (r / 18.0) ** 2)
              + (simulate.noise_texture(rng, size=TRACK_SIDE, octaves=2)
                 - 127.5) * 0.15)
    frames, centres = [], []
    for i in range(n):
        y0, x0 = 100 + TRACK_V[0] * i, 120 + TRACK_V[1] * i
        f = ground.copy()
        f[y0:y0 + TRACK_SIDE, x0:x0 + TRACK_SIDE] = target
        frames.append(f.astype(np.float32))
        centres.append((y0 + (TRACK_SIDE - 1) / 2.0,
                        x0 + (TRACK_SIDE - 1) / 2.0))
    return frames, centres


def phase_trackers(dev) -> dict:
    """``trackers:`` circulant (window 96), mean-shift likelihood (radius
    24), SFOT (the 64 px region, 9x9 grid, scales 1/2/4) and Comaniciu
    (half size 32) over 30 frames of ``tracker_scene``; each frame a step,
    timed, syncs counted and profiled as the VO families are.  Bars: the
    centre within the JAX tests' distances of the truth on every frame (3
    px circulant, 4 px mean-shift and Comaniciu; SFOT's move of every
    frame within 0.5 px of the true move); the card's last centre against
    the CPU's over the same frames (circulant and mean-shift 1e-3 px, SFOT
    0.05 px, Comaniciu 2 px: 30 mean-shift iterations a scale on
    bin-quantized histograms amplify rounding).  SFOT runs ``klt_track``;
    returns its launches."""
    from boofcv_tpu_torch.feature import trackers as tr
    frames, centres = tracker_scene()
    half = (TRACK_SIDE - 1) / 2.0
    specs = {
        "circulant": (lambda f, c, d: tr.circulant_init(f, *c, size=96,
                                                        device=d),
                      lambda s, prev, f: tr.circulant_track(s, f), 3.0,
                      1e-3),
        "meanshift": (lambda f, c, d: tr.meanshift_init(f, *c, radius=24,
                                                        device=d),
                      lambda s, prev, f: tr.meanshift_track(s, f), 4.0,
                      1e-3),
        "sfot": (lambda f, c, d: tr.sfot_init(*c, TRACK_SIDE, TRACK_SIDE,
                                              device=d),
                 lambda s, prev, f: tr.sfot_track(prev, f, s)[0], 0.5,
                 0.05),
        "comaniciu": (lambda f, c, d: tr.comaniciu_init(f, *c, half, half,
                                                        device=d),
                      lambda s, prev, f: tr.comaniciu_track(s, f), 4.0,
                      2.0),
    }
    launches = {}
    for name, (init, step, bar, tol) in specs.items():
        imgs = [torch.from_numpy(f).to(dev) for f in frames]
        state = [init(imgs[0], centres[0], dev)]
        seen = []

        def process(i, state=state, seen=seen, step=step, imgs=imgs):
            state[0] = step(state[0], imgs[i], imgs[i + 1])
            seen.append(torch.stack([state[0].cy, state[0].cx]))

        def accuracy(seen=seen, bar=bar, name=name):
            got = torch.stack(seen).double().cpu().numpy()
            truth = np.array(centres[:len(got) + 1])
            errs = np.hypot(*(got - truth[1:]).T)
            text = (f"centre error against the truth over {len(errs)} "
                    f"frames max {errs.max():.4f} px, last {errs[-1]:.4f}")
            if name != "sfot":
                return f"{text} (bar {bar} px)", errs.max() < bar
            # SFOT's bar is its JAX test's, on one step: the error of each
            # frame's move (the drift above sums 28 of them)
            moves = np.diff(np.vstack([truth[:1], got]), axis=0)
            step = np.hypot(*(moves - np.array(TRACK_V)).T)
            return (f"{text}; error of each frame's move max "
                    f"{step.max():.4f} px (bar {bar} px)", step.max() < bar)
        kernels = ("klt_track",) if name == "sfot" else ()
        got = _family("trackers", f"{name} {W}x{H}", dev, process, accuracy,
                      kernels, n_frames=SLICE_FRAMES)
        if got:
            launches[f"trackers {name}"] = got
        cimgs = [torch.from_numpy(f) for f in frames]
        cs = init(cimgs[0], centres[0], "cpu")
        for i in range(SLICE_FRAMES):
            cs = step(cs, cimgs[i], cimgs[i + 1])
        gap = float(np.hypot(float(state[0].cy) - float(cs.cy),
                             float(state[0].cx) - float(cs.cx)))
        print(f"trackers: accuracy: {name}: the last centre on the card "
              f"against the CPU's over the same {SLICE_FRAMES} frames "
              f"{gap:.3e} px (bar {tol})")
        check(gap <= tol, f"trackers: {name} differs on the card")
    return launches


def _same_detection(a, b, atol=1e-4) -> bool:
    """Two detector outputs agree: the same structure (None, tuples, lists,
    dicts), integers and masks equal, coordinates within ``atol``."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_detection(x, y, atol)
                                        for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_detection(a[k], b[k], atol)
                                            for k in a)
    if isinstance(a, (bytes, str)):
        return a == b
    x, y = np.asarray(a), np.asarray(b)
    if x.shape != y.shape:
        return False
    if x.dtype.kind in "biu" and y.dtype.kind in "biu":
        return bool(np.array_equal(x, y))
    return bool(np.allclose(x, y, rtol=0, atol=atol))


def _corners_detected(img, truth) -> np.ndarray:
    """[N] bool: the true corners with an x-corner detection within 1 px."""
    from boofcv_tpu_torch.recognition import chessboard
    ys, xs, valid = chessboard.detect_corners(img, 300)
    pts = np.stack([xs[valid], ys[valid]], 1)
    return np.linalg.norm(truth[:, None] - pts[None], axis=-1).min(1) < 1.0

# --- recognition's TLD, bag of words and DeepBoof; io; the functions the
# port's modules lacked --------------------------------------------------

TLD_OBJECT = 24                   # the reacquisition object's side (px)
TLD_BOX_TOL = 0.01                # px, card against the CPU
SCENE_SIDE = 256                  # scene: texture side (px)
SCENE_TRAIN, SCENE_TEST = 60, 30  # scene: images, a third of each kind
VGG_BATCH, NIN_BATCH = 256, 32
NIN_CHANNELS = (96, 256, 384)
N_PLY = 100_000
N_PNP = 512


def _tld_object(rng, cy, cx, scale=1.0, h=None, w=None) -> np.ndarray:
    """The reference TLD test's object (``tests/test_scene_tld.py:153-165``:
    a 24 px aperiodic texture in object coordinates, magnified by
    ``scale``) on a noisy background of grey 100."""
    h, w = h or H, w or W
    yy, xx = np.mgrid[0:h, 0:w]
    bg = rng.normal(100, 3, (h, w))
    u = (yy - cy) / scale
    v = (xx - cx) / scale
    obj = (np.abs(u) < TLD_OBJECT / 2) & (np.abs(v) < TLD_OBJECT / 2)
    tex = 50 * np.sign(np.sin(u * 0.9 + v * 0.31) + 0.4 * np.cos(v * 0.53)) \
        + 2.0 * u
    return (bg + np.where(obj, 70 + tex, 0)).astype(np.float32)


def tld_scenes(h=None, w=None) -> dict:
    """name -> (first frame, initial box (cy, cx, h, w), frames, true
    centres, or None where the target is gone).  ``tracker_scene``: the
    trackers' 64 px target moving (1, 2) px a frame, 30 frames, box 64x64;
    ``reacquire``: the reference test's object (its scene of
    ``tests/test_scene_tld.py:168-188`` drawn on 640x480) followed for 2
    frames, gone for 2, then back 1.7x larger elsewhere for 3."""
    h, w = h or H, w or W
    frames, centres = tracker_scene()
    out = {"tracker_scene": (frames[0], (*centres[0], TRACK_SIDE,
                                         TRACK_SIDE), frames[1:],
                             centres[1:])}
    rng = np.random.default_rng(5)
    f0 = _tld_object(rng, 200, 250, 1.0, h, w)
    seq = [_tld_object(rng, cy, cx, 1.0, h, w)
           for cy, cx in ((203, 255), (206, 260))]
    seq += [rng.normal(100, 3, (h, w)).astype(np.float32) for _ in range(2)]
    seq += [_tld_object(rng, 330, 450, 1.7, h, w) for _ in range(3)]
    truth = [(203, 255), (206, 260), None, None] + [(330, 450)] * 3
    out["reacquire"] = (f0, (200.0, 250.0, TLD_OBJECT, TLD_OBJECT), seq,
                        truth)
    return out


def _tld_bars(name: str, results, truth) -> tuple:
    """(text, ok) of one scene's bars, from what the JAX TLD does on the
    same frames (see :func:`phase_tld`)."""
    boxes = np.array([b for _, b in results], np.float64)
    found = np.array([ok for ok, _ in results])
    if name == "tracker_scene":
        t = np.array(truth[:len(results)], np.float64)
        err = np.hypot(*(boxes[:, :2] - t).T)
        size = boxes[:, 2] / TRACK_SIDE
        text = (f"found {int(found.sum())}/{len(found)}, centre error max "
                f"{err.max():.3f} px, last {err[-1]:.3f}, box side "
                f"{size.min():.3f}-{size.max():.3f} x {TRACK_SIDE} (bars: "
                f"every frame, 8.5 px, 0.8-1.25)")
        return text, bool(found.all() and err.max() <= 8.5
                          and size.min() >= 0.8 and size.max() <= 1.25)
    back = [i for i, c in enumerate(truth) if c is not None and i > 2]
    first = back[0]
    ok = bool(found[first])
    d = np.abs(boxes[first, :2] - np.array(truth[first]))
    side = boxes[first, 2] / TLD_OBJECT
    text = (f"followed {int(found[:2].sum())}/2, back on frame {first}: "
            f"found={ok} centre off by ({d[0]:.3f}, {d[1]:.3f}) px, side "
            f"{side:.3f} x {TLD_OBJECT} (bars: found on the first frame "
            f"back, within 8 px an axis, side 1.3-2.2 x)")
    return text, bool(found[:2].all() and ok and d.max() < 8
                      and 1.3 < side < 2.2)


def _tld_kernel_times(calls) -> dict:
    """``klt_track`` at TLD's shape (the first ``track_pyramid`` call of a
    frame: 25 tracks, 2 levels, radius 3, 15 iterations): device ms, ms
    over 200 calls, the plain version's, and the bound from this run's
    data."""
    from boofcv_tpu_torch.feature import klt
    from boofcv_tpu_torch.kernels import klt_track as kt
    pyr, tm, ys, xs, scales, cfg = calls[0]
    args = _klt_args(pyr, tm, ys, xs, scales, cfg)
    bnd, n_evals = _klt_bound(pyr, tm, ys, xs, scales, cfg)
    kern = lambda: kt.klt_track_cuda(*args)
    plain = lambda: klt.track_pyramid_reference(pyr, tm, ys, xs, scales,
                                                cfg)
    t = {"ms": cuda_ms(kern, 200), "plain_ms": cuda_ms(plain, 20),
         "device_ms": device_ms(kern, 50, "klt_track_kernel"),
         "plain_device_ms": device_ms(plain, 5), "library_ms": None,
         "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
         "tracks": ys.numel(), "levels": len(scales),
         "max_iterations": cfg.max_iterations, "evaluations": n_evals}
    print(f"kernel: klt_track tld n={ys.numel()} levels={len(scales)} "
          f"image={tuple(pyr[0].shape[-2:])} max_iterations="
          f"{cfg.max_iterations} evaluations={n_evals} bytes={bnd['bytes']} "
          f"flops={bnd['flops']} bound_ms={bnd['bound_ms']:.6f} bound_by="
          f"{bnd['bound_by']} device_ms={t['device_ms']:.6f} (profiler) "
          f"kernel_ms={t['ms']:.6f} (CUDA events, 200 back-to-back calls) "
          f"plain_ms={t['plain_ms']:.6f} plain_device_ms="
          f"{t['plain_device_ms']:.6f} library_ms=None")
    return t


TLD_KERNEL = {}   # klt_track at TLD's shape, for the kernels' JSON line


def phase_tld(dev) -> dict:
    """``tld:`` the TLD tracker (``recognition/tld.py``) at 640x480 on two
    scenes (:func:`tld_scenes`), each frame a ``process`` call measured as
    the VO families are (``_family``: frames/s, kernels, busy ms, idle
    share, syncs by call site, peak memory), then the same frames through a
    tracker on the CPU.  Every frame launches ``klt_track`` twice (median
    flow forward and back, 25 tracks, 2 levels, 15 iterations); each call
    of one frame is held against the plain version on the card, and the
    kernel is timed at that shape (``kernel: klt_track tld``).

    Bars, from the JAX TLD on the same frames on the CPU (its run: every
    frame of ``tracker_scene`` found, centre error 6.88 px on the first
    frame, where its detector takes a box 1/1.2 of the target's side 6.8 px
    to the left of the centre, rising to 8.30 px by the last, box side
    0.833-0.836 x 64; ``reacquire`` followed on both frames, a false find
    on the second noise frame, and found again on the first frame back off
    by (5.26, 2.74) px with side 1.728 x 24): ``tracker_scene`` found on
    every frame, centre error at most 8.5 px, side 0.8-1.25 x 64 (the
    reference test's 6 px an axis is missed by the reference here: ROADMAP
    queue 3); ``reacquire`` found on both frames before, on the first frame
    back within 8 px an axis, side 1.3-2.2 x 24 (the reference test's).
    Card = CPU: found flags equal on every frame, boxes within
    ``TLD_BOX_TOL``.  A stage line splits a frame's host wall into the
    median-flow track (device pyramids and KLT, one read back) and the
    detection cascade (host numpy, one batch of NCC patches)."""
    from boofcv_tpu_torch.recognition import tld
    launches = {}
    for name, (f0, box, seq, truth) in tld_scenes().items():
        imgs = [torch.from_numpy(f).to(dev) for f in seq]
        t = tld.make_tracker(device=dev)
        t.initialize(torch.from_numpy(f0).to(dev), *box)
        results = []

        def process(i, t=t, imgs=imgs, results=results):
            results.append(t.process(imgs[i]))

        def accuracy(name=name, results=results, truth=truth):
            return _tld_bars(name, results, truth)
        got = _family("tld", f"{name} {W}x{H}", dev, process, accuracy,
                      ("klt_track",), n_frames=len(seq))
        counted = len(seq) - 2
        check(got["klt_track"] == 2 * counted, f"tld: {name}: "
              f"{got['klt_track']} klt_track launches in {counted} frames "
              f"(2 a frame expected)")
        launches["klt_track"] = launches.get("klt_track", 0) + \
            got["klt_track"]
        calls = KLT_FAMILY_CALLS[f"tld {name}"]
        check(len(calls) == 2, f"tld: {len(calls)} track_pyramid calls in "
              f"a frame (2 expected)")
        if name == "tracker_scene":
            TLD_KERNEL.update(_tld_kernel_times(calls))
        text, ok = _tld_bars(name, results, truth)
        t0 = time.perf_counter()
        c = tld.make_tracker(device="cpu")
        c.initialize(f0, *box)
        cpu = [c.process(f) for f in seq]
        cpu_ms = 1e3 * (time.perf_counter() - t0) / len(seq)
        flags = all(a[0] == b[0] for a, b in zip(results, cpu))
        gap = max(np.abs(np.subtract(a[1], b[1])).max()
                  for a, b in zip(results, cpu))
        print(f"tld: accuracy: {name}: all {len(seq)} frames: {text}; card "
              f"against the CPU: found flags equal on every frame={flags}, "
              f"boxes within {gap:.3e} px (bar {TLD_BOX_TOL}); the CPU "
              f"{cpu_ms:.1f} ms a frame (host)")
        check(ok, f"tld: {name}: bar missed: {text}")
        check(flags and gap <= TLD_BOX_TOL, f"tld: {name}: card differs "
              f"from the CPU (flags {flags}, gap {gap})")
    # a frame's host wall by stage, on a fresh tracker over the first frames
    f0, box, seq, _ = tld_scenes()["tracker_scene"]
    t = tld.make_tracker(device=dev)
    t.initialize(torch.from_numpy(f0).to(dev), *box)
    imgs = [torch.from_numpy(f).to(dev) for f in seq[:10]]
    t.process(imgs[0])
    with _StageClock([(t, "_track", "track"), (t, "_detect", "detect")]) \
            as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for img in imgs[1:]:
            t.process(img)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / (len(imgs) - 1)
    n = len(imgs) - 1
    parts = {k: v / n for k, v in clock.ms.items()}
    print(f"tld: stages a frame (host wall, synchronize after each; "
          f"tracker_scene frames 2-{n + 1}): track {parts['track']:.3f} ms "
          f"(2 pyramids, 2 templates, 2 klt_track, one read back, a patch), "
          f"detect {parts['detect']:.3f} ms (variance and fern cascade on "
          f"the host, one batch of NCC patches), the rest "
          f"{wall - sum(parts.values()):.3f} ms (fusion, learning); frame "
          f"{wall:.3f} ms")
    return {"tld": launches}


def phase_scene(dev) -> None:
    """``scene:`` bag of words (``recognition/scene.py``): 60 training
    textures at 256x256 of ``classify_scene_knn``'s three kinds and 30
    held-out ones, dense SIFT (cell 8, step 8), ``train_bow``'s default
    vocabulary of 64 words, 25 k-means iterations from rows drawn once on
    the host (``init_idx``), kNN 5.  Timed on their own lines: the
    descriptors, k-means, the training histograms, and classifying the 30.
    Bars: held-out accuracy at least the example's 80 %; the card's labels
    equal the CPU's (the whole pipeline on the CPU, same ``init_idx``)."""
    from boofcv_tpu_torch.examples.classify_scene_knn import texture
    from boofcv_tpu_torch.feature import dense
    from boofcv_tpu_torch.recognition import scene
    rng = np.random.default_rng(23)
    per = lambda n: [(texture(rng, k, SCENE_SIDE), k) for k in range(3)
                     for _ in range(n // 3)]
    train, test = per(SCENE_TRAIN), per(SCENE_TEST)
    labels = [k for _, k in train]
    timgs = [torch.from_numpy(img).to(dev) for img, _ in train + test]
    feats, _ = _multiview(
        "scene", f"dense_sift cell 8, step 8, {len(timgs)} images "
        f"{SCENE_SIDE}x{SCENE_SIDE}", lambda: [dense.dense_sift(t)[2]
                                               for t in timgs], dev, reps=3)
    tr_f, te_f = feats[:SCENE_TRAIN], feats[SCENE_TRAIN:]
    allf = torch.cat(tr_f)
    idx = torch.randperm(allf.shape[0],
                         generator=torch.Generator().manual_seed(0))[:64]
    _multiview("scene", f"kmeans {allf.shape[0]} x {allf.shape[1]} "
               f"descriptors, 64 words, 25 iterations",
               lambda: scene.kmeans(None, allf, 64, 25, init_idx=idx), dev,
               reps=5)
    clf, _ = _multiview("scene", f"train_bow (k-means and {SCENE_TRAIN} "
                        f"histograms)", lambda: scene.train_bow(
                            None, tr_f, labels, init_idx=idx, device=dev),
                        dev, reps=3)
    pred, _ = _multiview("scene", f"classify_bow x {SCENE_TEST}, kNN 5",
                         lambda: [scene.classify_bow(clf, f) for f in te_f],
                         dev, reps=3)
    truth = [k for _, k in test]
    acc = float(np.mean(np.equal(pred, truth)))
    cfeat = lambda img: dense.dense_sift(img, device="cpu")[2]
    cclf = scene.train_bow(None, [cfeat(img) for img, _ in train], labels,
                           init_idx=idx, device="cpu")
    cpred = [scene.classify_bow(cclf, cfeat(img)) for img, _ in test]
    same = int(np.sum(np.equal(pred, cpred)))
    vgap = float((clf.vocabulary.cpu() - cclf.vocabulary).abs().max())
    print(f"scene: accuracy: held out {acc:.3f} ({int(acc * len(truth))}/"
          f"{len(truth)}; bar 0.8); labels on the card equal the CPU's on "
          f"{same}/{len(truth)} (bar all); vocabulary card against CPU max "
          f"{vgap:.3e}")
    check(acc >= 0.8, f"scene: held-out accuracy {acc}")
    check(same == len(truth), "scene: labels differ on the card")


def _numpy_params(kind: str, rng) -> dict:
    """He-normal parameters in the reference's layout (HWIO convolutions,
    [in, out] dense layers) from a numpy generator: VGG-CIFAR10 (10
    classes) or NIN-ImageNet (``NIN_CHANNELS``, 1,000 classes)."""
    out = {}

    def draw(key, shape, fan_in):
        out[key] = (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        out[key.replace("_w", "_b")] = np.zeros(shape[-1], np.float32)
    cin = 3
    if kind == "vgg":
        from boofcv_tpu_torch.recognition.deepboof import VGG_CIFAR10_CHANNELS
        for bi, block in enumerate(VGG_CIFAR10_CHANNELS):
            for ci, cout in enumerate(block):
                draw(f"conv{bi}_{ci}_w", (3, 3, cin, cout), 9 * cin)
                cin = cout
        draw("fc0_w", (16 * cin, 512), 16 * cin)
        draw("fc1_w", (512, 10), 512)
        return out
    for bi, (cout, ks) in enumerate(zip(NIN_CHANNELS, (11, 5, 3))):
        for ci, kk in enumerate((ks, 1, 1)):
            draw(f"nin{bi}_{ci}_w", (kk, kk, cin, cout), kk * kk * cin)
            cin = cout
    draw("head_w", (1, 1, cin, 1000), cin)
    return out


def phase_deepboof(dev) -> None:
    """``deepboof:`` the two networks at full width on random parameters
    carried across from a numpy dict (``params_from_numpy``):
    VGG-CIFAR10 on 256 images of 32x32x3, NIN-ImageNet (96, 256, 384
    channels, 1,000 classes) on 32 of 224x224x3; ms a batch and images/s,
    logits on the card within 1e-3 of the largest CPU logit (TF32 off);
    then ``image_classification``'s run: 150 SGD steps (autograd) on 8
    images of 4 classes reaching 100 % training accuracy, on the card."""
    from boofcv_tpu_torch.examples.image_classification import overfit
    from boofcv_tpu_torch.recognition import deepboof
    rng = np.random.default_rng(31)
    for kind, fwd, batch, side, extra in (
            ("vgg", deepboof.vgg_cifar10_forward, VGG_BATCH, 32, {}),
            ("nin", deepboof.nin_forward, NIN_BATCH, 224,
             {"channels": NIN_CHANNELS})):
        params = _numpy_params(kind, rng)
        x = rng.uniform(0, 1, (batch, side, side, 3)).astype(np.float32)
        p_card = deepboof.params_from_numpy(params, device=dev)
        xc = torch.from_numpy(x).to(dev)

        def run(fwd=fwd, p=p_card, xc=xc, extra=extra):
            with torch.no_grad():
                return fwd(p, xc, **extra)
        logits, med = _multiview(
            "deepboof", f"{kind} forward, {batch} images {side}x{side}x3",
            run, dev, reps=10)
        with torch.no_grad():
            cpu = fwd(deepboof.params_from_numpy(params, device="cpu"),
                      torch.from_numpy(x), **extra)
        rel = _gap(logits, cpu) / float(cpu.abs().max())
        print(f"deepboof: accuracy: {kind}: {batch * 1e3 / med:.1f} "
              f"images/s; logits {tuple(logits.shape)} on the card against "
              f"the CPU {rel:.3e} of the largest (bar 1e-3)")
        check(tuple(logits.shape) == (batch, 10 if kind == "vgg" else 1000)
              and bool(torch.isfinite(logits).all()),
              f"deepboof: {kind} logits malformed")
        check(rel <= 1e-3, f"deepboof: {kind} logits differ on the card")
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)
    y = torch.as_tensor(np.arange(8) % 4, device=dev)
    x = torch.from_numpy(imgs).to(dev)
    params = deepboof.init_vgg_cifar10(torch.Generator().manual_seed(0),
                                       num_classes=4, device=dev)
    (trained, loss), med = _multiview(
        "deepboof", "150 SGD steps, VGG on 8 images of 4 classes",
        lambda: overfit(params, x, y), dev, reps=2)
    with torch.no_grad():
        acc = float((torch.argmax(deepboof.vgg_cifar10_forward(trained, x),
                                  -1) == y).float().mean())
    print(f"deepboof: accuracy: overfit: loss {float(loss):.4f}, training "
          f"accuracy {acc:.3f} (bar 1.0), {med / 150:.3f} ms a step")
    check(acc == 1.0, f"deepboof: overfit accuracy {acc}")


def phase_io(dev) -> None:
    """``io:`` the numpy codecs of ``io/`` on the card's host (no device
    work): PNG and PNM round trips of a 1280x720 RGB frame, calibration
    YAML (a camera and a stereo pair) and PLY of 100,000 points (binary
    with colour, ASCII without), ms to write and read each; every round
    trip exact."""
    import tempfile
    from boofcv_tpu_torch.io import calibration_io as cio
    from boofcv_tpu_torch.io import image_io, points_io
    rng = np.random.default_rng(41)
    frame = rng.integers(0, 256, (H_720P, W_720P, 3)).astype(np.float32)
    gray = frame[..., 1]
    pts = rng.normal(0, 1, (N_PLY, 3))
    cols = rng.integers(0, 256, (N_PLY, 3)).astype(np.uint8)
    cam = cio.CameraPinholeBrown(W_720P, H_720P, 720.5, 721.25, 0.0, 640.0,
                                 360.0, (-0.1, 0.03), 1e-4, -2e-4)
    stereo = cio.StereoParameters(cam, cam, np.eye(3),
                                  np.array([-0.12, 0.0, 0.0]))

    def same_ply(out, colours):
        p2, c2 = out
        return bool(np.array_equal(p2, pts) and (
            c2 is None if colours is None else np.array_equal(c2, colours)))
    cases = (
        ("png rgb", "f.png", lambda p: image_io.save(p, frame),
         image_io.load, lambda o: np.array_equal(o, frame)),
        ("pnm rgb", "f.ppm", lambda p: image_io.save(p, frame),
         image_io.load, lambda o: np.array_equal(o, frame)),
        ("pnm gray", "f.pgm", lambda p: image_io.save(p, gray),
         image_io.load, lambda o: np.array_equal(o, gray)),
        ("yaml camera", "c.yaml", lambda p: cio.save_pinhole_brown(cam, p),
         cio.load_pinhole_brown, lambda o: o == cam),
        ("yaml stereo", "s.yaml", lambda p: cio.save_stereo(stereo, p),
         cio.load_stereo, lambda o: o.left == cam and np.array_equal(
             o.t_right_to_left, stereo.t_right_to_left)),
        ("ply binary", "b.ply",
         lambda p: points_io.save_ply(p, pts, cols, binary=True),
         points_io.load_ply, lambda o: same_ply(o, cols)),
        ("ply ascii", "a.ply",
         lambda p: points_io.save_ply(p, pts, binary=False),
         points_io.load_ply, lambda o: same_ply(o, None)))
    parts = []
    with tempfile.TemporaryDirectory() as tmp:
        for what, fname, save, load, same in cases:
            path = os.path.join(tmp, fname)
            t0 = time.perf_counter()
            save(path)
            t1 = time.perf_counter()
            out = load(path)
            t2 = time.perf_counter()
            ok = same(out)
            parts.append(f"{what} {os.path.getsize(path)} B write "
                         f"{1e3 * (t1 - t0):.2f} ms read "
                         f"{1e3 * (t2 - t1):.2f} ms exact={ok}")
            check(ok, f"io: {what} round trip not exact")
    print(f"io: {W_720P}x{H_720P} frames, {N_PLY} points (host, one "
          f"call each): " + "; ".join(parts))


def _pnp_scenes(n=N_PNP, seed=43) -> dict:
    """name -> (world, obs, (R, t) true) with 1e-3 noise on the normalized
    observations: a general scene (the EPnP and DLT test's shape) and a
    planar one (world z = 0)."""
    rng = np.random.default_rng(seed)
    out = {}
    R, t = _rodrigues([0.3, -0.2, 0.15]), np.array([0.2, -0.4, 1.0])
    world = np.concatenate([rng.uniform(-2, 2, (n, 2)),
                            rng.uniform(3, 9, (n, 1))], 1)
    xc = world @ R.T + t
    out["general"] = (world, xc[:, :2] / xc[:, 2:]
                      + rng.normal(0, 1e-3, (n, 2)), (R, t))
    R, t = _rodrigues([0.2, -0.3, 0.1]), np.array([0.1, -0.2, 3.0])
    wxy = rng.uniform(-1, 1, (n, 2))
    xc = np.concatenate([wxy, np.zeros((n, 1))], 1) @ R.T + t
    out["planar"] = (wxy, xc[:, :2] / xc[:, 2:]
                     + rng.normal(0, 1e-3, (n, 2)), (R, t))
    return out


def phase_ip_more(dev) -> None:
    """``ip_more:`` the functions the port's modules lacked, at 640x480 on
    an integer-valued checker texture (``io.simulate.checker_texture``,
    rounded), and the PnP solvers on 512 points: ms a call (CUDA events
    after a warm-up, median of 5) and the card against the CPU within the
    CPU tests' tolerances (``tests/test_torch_ip_more.py``): stencils of
    small integers and FAST exact; the Gaussian pyramid, scale space and
    bicubic 2e-6 relative; structure-tensor and Hessian intensities 1e-4 of
    the largest; PnP poses 1e-8 (refined) and 1e-6 (DLT); each pose also
    against the truth (rotation within 1e-2)."""
    from boofcv_tpu_torch.core.pyramid import PyramidConfig, pyramid_shapes
    from boofcv_tpu_torch.feature import intensity
    from boofcv_tpu_torch.geo import pnp
    from boofcv_tpu_torch.io import simulate
    from boofcv_tpu_torch.ip import convolve, derivative, interpolate
    from boofcv_tpu_torch.ip import pyramid_ops
    tex = np.round(simulate.checker_texture(np.random.default_rng(47),
                                            size=max(H, W), square=32))
    img = np.clip(tex[:H, :W], 0, 255).astype(np.float32)
    rng = np.random.default_rng(53)
    ys = rng.uniform(-3, H + 2, 20_000)
    xs = rng.uniform(-3, W + 2, 20_000)
    iy = rng.integers(-2, H + 2, 4096)
    ix = rng.integers(-2, W + 2, 4096)
    k3 = torch.tensor([0.25, 0.5, 0.25])
    k2 = torch.outer(k3, torch.tensor([-1.0, 0.0, 1.0, 2.0, 0.5]))
    pcfg = PyramidConfig(scales=(1, 2, 4, 8), sigma=1.0)
    check(pyramid_shapes(pcfg, H, W) == [(480, 640), (240, 320), (120, 160),
                                         (60, 80)], "ip_more: pyramid_shapes")

    # name -> (fn of (image tensor, device), tolerance: "exact" or
    # (relative, "of the largest" | "elementwise"))
    calls = {
        "prewitt": (lambda t, d: derivative.prewitt(t), "exact"),
        "three": (lambda t, d: derivative.three(t), "exact"),
        "two0": (lambda t, d: derivative.two0(t), "exact"),
        "two1": (lambda t, d: derivative.two1(t), "exact"),
        "laplacian": (lambda t, d: derivative.laplacian(t), "exact"),
        "hessian_three": (lambda t, d: derivative.hessian_three(t), "exact"),
        "hessian_from_gradient": (
            lambda t, d: derivative.hessian_from_gradient(
                *derivative.sobel(t)),
            "exact"),
        "gradient_magnitude_angle": (
            lambda t, d: derivative.gradient_magnitude_angle(
                *derivative.sobel(t)),
            (1e-6, "elementwise")),
        "convolve_down x2": (lambda t, d: convolve.convolve_down(
            t, k3, 2, 1), "exact"),
        "sparse_sample 4096": (lambda t, d: convolve.sparse_sample(
            t, k2, torch.from_numpy(iy).to(d), torch.from_numpy(ix).to(d)),
            (1e-6, "of the largest")),
        "bicubic 20000 f64": (lambda t, d: interpolate.bicubic(
            t, torch.from_numpy(ys).to(d), torch.from_numpy(xs).to(d)),
            (2e-6, "of the largest")),
        "pyramid_discrete 1/2/4/8": (
            lambda t, d: pyramid_ops.pyramid_discrete(t, pcfg),
            (2e-6, "of the largest")),
        "gaussian_scale_space 4": (
            lambda t, d: pyramid_ops.gaussian_scale_space(
                t, (0.8, 1.6, 3.2, 6.4)), (2e-6, "of the largest")),
        "gradient three": (lambda t, d: pyramid_ops.gradient(
            pyramid_ops.pyramid_average(t, pcfg), method="three"),
            (1e-6, "of the largest")),
        "gradient prewitt": (lambda t, d: pyramid_ops.gradient(
            pyramid_ops.pyramid_average(t, pcfg), method="prewitt"),
            (1e-6, "of the largest")),
        "fast": (lambda t, d: intensity.fast(t), "exact"),
        "harris": (lambda t, d: intensity.harris(t), (1e-4, "of the largest")),
        "harris weighted": (lambda t, d: intensity.harris(t, weighted=True),
                            (1e-4, "of the largest")),
        "shi_tomasi weighted": (lambda t, d: intensity.shi_tomasi(
            t, weighted=True), (1e-4, "of the largest")),
        "kitros": (lambda t, d: intensity.kitros(t), (1e-4, "of the largest")),
        "hessian_det": (lambda t, d: intensity.hessian_det(t), "exact"),
        "hessian_trace": (lambda t, d: intensity.hessian_trace(t), "exact"),
        "median_intensity": (lambda t, d: intensity.median_intensity(t),
                             "exact"),
    }
    ti, ci = torch.from_numpy(img).to(dev), torch.from_numpy(img)
    lines = []

    def flat(x):
        if isinstance(x, (tuple, list)):
            return [y for z in x for y in flat(z)]
        return [x]
    for name, (fn, tol) in calls.items():
        got, ms = _multiview("ip_more", f"{name}, {W}x{H}",
                             lambda fn=fn: fn(ti, dev), dev, reps=5)
        want = fn(ci, "cpu")
        worst = 0.0
        for g, w in zip(flat(got), flat(want)):
            g = g.cpu()
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"ip_more: {name}: shape or dtype differs")
            if g.dtype == torch.bool:
                gap = float((g != w).sum())
            elif tol == "exact" or tol[1] == "of the largest":
                gap = float((g.double() - w.double()).abs().max())
                if tol != "exact":
                    gap /= max(float(w.abs().max()), 1e-30)
            else:
                gap = float(((g.double() - w.double()).abs()
                             / (w.double().abs() + 1e-3)).max())
            worst = max(worst, gap)
        bar = 0.0 if tol == "exact" else tol[0]
        lines.append(f"{name} {ms:.3f} ms gap {worst:.2e} (bar "
                     f"{'exact' if tol == 'exact' else bar})")
        check(worst <= bar, f"ip_more: {name} differs on the card by "
              f"{worst}")
    print("ip_more: accuracy: card against the CPU, median ms a call "
          f"(CUDA events, 5 after a warm-up), {W}x{H}: " + "; ".join(lines))
    lines = []
    scenes = _pnp_scenes()
    world, obs, (Rt, tt) = scenes["general"]
    wxy, pobs, (Rp, tp) = scenes["planar"]
    solvers = {
        "absolute_orientation": (lambda d: pnp.absolute_orientation(
            torch.from_numpy(world).to(d),
            torch.from_numpy(world @ Rt.T + tt).to(d)), 1e-8, Rt),
        "pnp_dlt": (lambda d: pnp.pnp_dlt(torch.from_numpy(world).to(d),
                                          torch.from_numpy(obs).to(d)),
                    1e-6, Rt),
        "epnp": (lambda d: pnp.epnp(torch.from_numpy(world).to(d),
                                    torch.from_numpy(obs).to(d)), 1e-8, Rt),
        "pnp_planar": (lambda d: pnp.pnp_planar(torch.from_numpy(wxy).to(d),
                                                torch.from_numpy(pobs).to(d)),
                       1e-8, Rp),
    }
    for name, (fn, tol, R_true) in solvers.items():
        _reset_launches()
        (R, t), ms = _multiview("ip_more", f"{name}, {N_PNP} points",
                                lambda fn=fn: fn(dev), dev, reps=5)
        n_gn = _launches()["gn_pose"]
        Rc, tc = fn("cpu")
        gap = max(_gap(R, Rc), _gap(t, tc))
        err = float(np.abs(_host_np(R) - R_true).max())
        lines.append(f"{name} card against the CPU {gap:.2e} (bar {tol}), "
                     f"rotation against the truth {err:.2e} (bar 1e-2), "
                     f"gn_pose launches {n_gn}")
        check(gap <= tol and err < 1e-2, f"ip_more: {name}: gap {gap}, "
              f"rotation error {err}")
        check(n_gn >= 1 or name not in ("epnp", "pnp_planar"),
              f"ip_more: {name}'s refine did not launch gn_pose")
    print("ip_more: accuracy: " + "; ".join(lines))


# ---- the commands and the examples (cli/, examples/) ----------------------

# the examples whose path reaches a hand kernel, with the kernels it runs
EXAMPLE_KERNELS = {
    "visual_odometry_stereo": ("klt_track", "window_gather", "gn_pose",
                               "pnp_bank"),
    "visual_odometry_depth": ("klt_track", "gn_pose", "pnp_bank"),
    "pnp": ("gn_pose", "pnp_bank"),
    "pose_of_calibration_target": ("gn_pose", "pnp_bank"),
    "multiview_reconstruction": ("pnp_bank",),
    "visual_odometry_mono_plane": ("klt_track",),
    "point_feature_tracker": ("klt_track",),
    "video_stabilization": ("klt_track",),
    "video_mosaic": ("klt_track",),
    "image_stitching": ("klt_track",),
    "tracker_object": ("klt_track",),
}
N_EXAMPLES = 64


def write_stereo_dirs(root: str, frames) -> tuple:
    """Each (left, right) float32 pair of ``frames`` as 8-bit PNG files
    ``left/NNN.png`` and ``right/NNN.png`` under ``root``; returns the two
    directories."""
    from boofcv_tpu_torch.io import image_io
    dirs = tuple(os.path.join(root, side) for side in ("left", "right"))
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    for i, pair in enumerate(frames):
        for d, img in zip(dirs, pair):
            image_io.save(os.path.join(d, f"{i:03d}.png"), img)
    return dirs


def _run_command(main_fn, argv) -> tuple:
    """(return code, stdout, host wall s) of ``main_fn(argv)``, with the
    card synchronized after it."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t0


def phase_cli_vo(dev, poses, frames) -> dict:
    """``cli_vo:`` the main path through the user's command: the reference
    scene's 41 640x480 frames written as PNG pairs, then
    ``cli.stereo_vo_demo.main`` in this process (``--fx 480 --baseline
    0.4 --device cuda``).  The written trajectory must equal, within 1e-6,
    a ``StereoVisualOdometry`` run on the same decoded frames, and meet the
    VO bars (``pose_ok`` on every frame, ATE below 0.15 x the motion,
    final rotation error below 2 degrees); a run with ``--calib`` (a stereo
    YAML of the scene's own calibration) must meet them too.  Prints
    frames/s end to end (PNG decode included), the share of it in
    ``process``, the hand kernels' launches, host syncs by call site (one run
    with sync warnings on) and the kernels, device busy ms and idle share
    of one profiled frame (the 21st; another run).  Returns the launches
    of the counted run."""
    import tempfile
    from boofcv_tpu_torch.cli import stereo_vo_demo
    from boofcv_tpu_torch.io import calibration_io as cio
    from boofcv_tpu_torch.io import image_io
    from boofcv_tpu_torch.sfm import stereo_vo
    svo = stereo_vo.StereoVisualOdometry
    process = svo.process
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ld, rd = write_stereo_dirs(tmp, frames)
        write_s = time.perf_counter() - t0
        cam = cio.CameraPinholeBrown(W, H, *(float(v) for v in (
            K[0, 0], K[1, 1], 0.0, K[0, 2], K[1, 2])))
        calib = os.path.join(tmp, "stereo.yaml")
        cio.save_stereo(cio.StereoParameters(
            cam, cam, np.eye(3), np.array([BASELINE, 0.0, 0.0])), calib)
        base = ["--left", ld, "--right", rd, "--device", "cuda"]
        plain = base + ["--fx", f"{K[0, 0]:g}", "--baseline", f"{BASELINE:g}"]
        out = {k: os.path.join(tmp, f"{k}.txt")
               for k in ("timed", "syncs", "traced", "calib")}

        # the counted and timed run; ``process`` timed alone beside it
        step_s = []

        def timed(self, left, right):
            t1 = time.perf_counter()
            ok = process(self, left, right)
            step_s.append(time.perf_counter() - t1)
            return ok
        _reset_launches()
        svo.process = timed
        try:
            rc, log, wall = _run_command(stereo_vo_demo.main,
                                         plain + ["--output", out["timed"]])
        finally:
            svo.process = process
        launches = _launches(STEREO_VO_KERNELS)
        check(rc == 0, f"cli_vo: stereo_vo_demo returned {rc}")
        oks = [line.split("ok=")[1].startswith("True")
               for line in log.splitlines() if line.startswith("frame ")]
        traj = np.loadtxt(out["timed"])
        check(traj.shape == (N_FRAMES, 12) and len(oks) == N_FRAMES,
              f"cli_vo: trajectory {traj.shape}, {len(oks)} frame lines")
        text, ok = _pose_bars(poses, list(traj[:, 9:]),
                              list(traj[:, :9].reshape(-1, 3, 3)), oks, 0.15)

        # the same decoded frames through StereoVisualOdometry directly
        lefts = [image_io.to_gray(a) for a in image_io.load_sequence(ld)]
        rights = [image_io.to_gray(a) for a in image_io.load_sequence(rd)]
        vo = svo(stereo_vo.StereoVoConfig(), K, BASELINE, H, W, device=dev)
        rows = []
        for left, right in zip(lefts, rights):
            vo.process(left, right)
            R, c = vo.camera_to_world()
            rows.append(np.concatenate([R.ravel(), c]))
        gap = float(np.abs(traj - np.stack(rows)).max())

        # host syncs by call site over a whole run
        (rc_s, _, _), syncs = _count_sync_warnings(
            lambda: _run_command(stereo_vo_demo.main,
                                 plain + ["--output", out["syncs"]]))
        check(rc_s == 0, f"cli_vo: stereo_vo_demo returned {rc_s}")

        # one steady-state frame under the profiler
        seen, traced = [0], []

        def profiled(self, left, right):
            seen[0] += 1
            if seen[0] != N_FRAMES // 2 + 1:
                return process(self, left, right)
            box = []
            traced.extend(_trace(lambda: box.append(
                process(self, left, right)))[0])
            return box[0]
        svo.process = profiled
        try:
            rc_p, _, _ = _run_command(stereo_vo_demo.main,
                                      plain + ["--output", out["traced"]])
        finally:
            svo.process = process
        check(rc_p == 0 and traced, "cli_vo: the profiled run failed or "
                                    "traced nothing")

        # the calibrated path: rectification maps on the card
        rc_c, log_c, wall_c = _run_command(
            stereo_vo_demo.main, base + ["--calib", calib, "--output",
                                         out["calib"]])
        check(rc_c == 0, f"cli_vo: stereo_vo_demo --calib returned {rc_c}")
        traj_c = np.loadtxt(out["calib"])
        oks_c = [line.split("ok=")[1].startswith("True")
                 for line in log_c.splitlines() if line.startswith("frame ")]
        text_c, ok_c = _pose_bars(poses, list(traj_c[:, 9:]),
                                  list(traj_c[:, :9].reshape(-1, 3, 3)),
                                  oks_c, 0.15)
    step_ms = 1e3 * float(np.median(step_s[1:]))
    busy = sum(e.device_time for e in traced) / 1e3
    klt_ms = sum(e.device_time for e in traced
                 if "klt_track_kernel" in e.name) / 1e3
    n_syncs = sum(syncs.values())
    print(f"cli_vo: stereo_vo_demo {W}x{H}, {N_FRAMES} PNG pairs (written in "
          f"{write_s:.3f} s): frames/s end to end {N_FRAMES / wall:.3f} (PNG "
          f"decode included; {1e3 * wall:.1f} ms in all); process() "
          f"{1e3 * sum(step_s):.1f} ms of it (share "
          f"{sum(step_s) / wall:.4f}), median step {step_ms:.3f} ms; "
          f"launches klt_track={launches['klt_track']} window_gather="
          f"{launches['window_gather']} gn_pose={launches['gn_pose']}")
    print(f"cli_vo: trajectory against a direct StereoVisualOdometry run on "
          f"the same decoded frames: max |gap| {gap:.3e} (bar 1e-6); "
          f"accuracy: {text}")
    print(f"cli_vo: --calib (stereo YAML of the scene's calibration): "
          f"{N_FRAMES / wall_c:.3f} frames/s end to end; accuracy: {text_c}")
    print(f"cli_vo: host syncs in one run: {n_syncs} "
          f"({n_syncs / N_FRAMES:.2f} a frame) by call site: "
          f"{dict(sorted(syncs.items()))}")
    print(f"cli_vo: one profiled steady-state frame: {len(traced)} kernels, "
          f"device busy {busy:.3f} ms (klt_track_kernel {klt_ms:.4f}), idle "
          f"share {1 - busy / step_ms:.4f} of the median step, "
          f"{1 - busy / (1e3 * wall / N_FRAMES):.4f} of the mean end-to-end "
          "frame")
    check(gap <= 1e-6, f"cli_vo: trajectory differs from the direct run by "
                       f"{gap}")
    check(ok, f"cli_vo: accuracy bar missed: {text}")
    check(ok_c, f"cli_vo: --calib accuracy bar missed: {text_c}")
    check(klt_ms > 0, "cli_vo: the profiled frame did not run "
                      "klt_track_kernel")
    check(launches["gn_pose"] == N_FRAMES - 1,
          f"cli_vo: gn_pose launched {launches['gn_pose']} times in "
          f"{N_FRAMES - 1} steps")
    check(launches["pnp_bank"] == N_FRAMES - 1,
          f"cli_vo: pnp_bank launched {launches['pnp_bank']} times "
          f"in {N_FRAMES - 1} steps")
    return launches


def phase_examples(dev) -> dict:
    """``examples:`` each of the port's 64 examples once on the card,
    in-process (``main(["--device", "cuda"])``): each must return 0 with
    ``OK`` as its last line.  One line an example: host wall ms and the
    hand kernels' launches.  Returns the launches of each example that reaches
    a hand kernel (``EXAMPLE_KERNELS``, and any other that launched one),
    each naming the kernels it runs."""
    import importlib
    import pkgutil
    import boofcv_tpu_torch.examples as examples
    names = sorted(m.name for m in pkgutil.iter_modules(examples.__path__))
    check(len(names) == N_EXAMPLES, f"examples: {len(names)} modules, not "
                                    f"{N_EXAMPLES}")
    launches, failed, total = {}, [], 0.0
    for name in names:
        mod = importlib.import_module(f"boofcv_tpu_torch.examples.{name}")
        _reset_launches()
        rc, log, wall = _run_command(mod.main, ["--device", "cuda"])
        n = _launches()
        total += wall
        last = (log.strip().splitlines() or [""])[-1]
        print(f"examples: {name}: {1e3 * wall:.1f} ms rc={rc} last line "
              f"{last!r} launches klt_track={n['klt_track']} window_gather="
              f"{n['window_gather']} gn_pose={n['gn_pose']} pnp_bank="
              f"{n['pnp_bank']}")
        if rc != 0 or last != "OK" or "device: cuda" not in log:
            failed.append(name)
            print(log)
        want = EXAMPLE_KERNELS.get(name, ())
        got = {k: v for k, v in n.items() if v or k in want}
        if got:
            launches[f"example {name}"] = got
    print(f"examples: {len(names) - len(failed)} of {len(names)} OK in "
          f"{total:.1f} s")
    check(not failed, f"examples: failed: {failed}")
    return launches


def qr_scan_dir(d: str) -> None:
    """``tests/test_cli.py``'s QR batch: codes "alpha" and "beta" (version
    1, level M, 5 px modules) and a noise decoy."""
    from boofcv_tpu_torch.io import image_io
    from boofcv_tpu_torch.recognition.qr import code as qr, detector
    os.makedirs(d, exist_ok=True)
    for i, text in enumerate(["alpha", "beta"]):
        image_io.save(os.path.join(d, f"{i}.png"),
                      detector.render(qr.encode(text, 1, "M", i % 8), 5))
    image_io.save(os.path.join(d, "z.png"),
                  np.random.default_rng(0).uniform(0, 255, (60, 60)))


CLI_BOARD = (4, 5, 0.03)          # inner rows, inner cols, square (m)
CLI_BOARD_K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1.0]])


def board_views_dir(d: str, n_views: int = 5) -> None:
    """``tests/test_cli.py``'s chessboard views through ``CLI_BOARD_K``,
    rendered 2x supersampled and box-downsampled (the corner detector needs
    antialiased edges, as real images have)."""
    from boofcv_tpu_torch.geo import se3
    from boofcv_tpu_torch.io import image_io
    rows, cols, sq = CLI_BOARD
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    ss = 2
    Kss = CLI_BOARD_K * ss
    Kss[2, 2] = 1.0
    yy, xx = np.mgrid[0:240 * ss, 0:320 * ss]
    rays = np.stack([xx, yy, np.ones_like(xx)], -1) @ np.linalg.inv(Kss).T
    board = np.zeros((rows + 1, cols + 1), bool)
    board[::2, ::2] = True
    board[1::2, 1::2] = True
    for v in range(n_views):
        w = np.array([0.3, -0.25, 0.1]) * rng.uniform(-1, 1, 3)
        R = se3.exp_so3(torch.from_numpy(w)).numpy()
        t = np.array([rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02),
                      rng.uniform(0.30, 0.45)])
        d_t = rays @ R                     # direction in the target frame
        c0 = -R.T @ t
        s = -c0[2] / np.where(np.abs(d_t[..., 2]) < 1e-12, 1e-12,
                              d_t[..., 2])
        P = c0 + s[..., None] * d_t
        bx = np.floor((P[..., 0] + (cols + 2) * sq / 2) / sq).astype(int) - 1
        by = np.floor((P[..., 1] + (rows + 2) * sq / 2) / sq).astype(int) - 1
        inside = (bx >= 0) & (bx <= cols) & (by >= 0) & (by <= rows) \
            & (s > 0)
        dark = np.zeros_like(inside)
        dark[inside] = board[by[inside], bx[inside]]
        img = np.where(dark, 25.0, 230.0).astype(np.float32)
        image_io.save(os.path.join(d, f"v{v}.png"),
                      img.reshape(240, ss, 320, ss).mean((1, 3)))


def distorted_capture_dir(d: str) -> np.ndarray:
    """``tests/test_cli.py``'s lens-distortion case: ``calib.yaml`` (a
    160x120 Brown camera, k1 -0.22, k2 0.04) and ``in/a.png``, a distorted
    capture of a texture; returns the ideal image."""
    from boofcv_tpu_torch.geo import cameras
    from boofcv_tpu_torch.io import calibration_io as cio
    from boofcv_tpu_torch.io import image_io, simulate
    from boofcv_tpu_torch.ip import distort
    h, w = 120, 160
    cam = cameras.CameraPinholeBrown(fx=140.0, fy=140.0, cx=w / 2, cy=h / 2,
                                     width=w, height=h, radial=(-0.22, 0.04))
    os.makedirs(os.path.join(d, "in"), exist_ok=True)
    cio.save_pinhole_brown(cam, os.path.join(d, "calib.yaml"))
    ideal = simulate.noise_texture(np.random.default_rng(0), size=220,
                                   octaves=5)[:h, :w]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    nx, ny = cameras.pixel_to_norm_undistorted(cam, xs, ys)
    captured = distort.warp(torch.from_numpy(ideal),
                            (ny * cam.fy + cam.cy).to(torch.float32),
                            (nx * cam.fx + cam.cx).to(torch.float32))
    image_io.save(os.path.join(d, "in", "a.png"),
                  np.clip(captured.numpy(), 0, 255).astype(np.uint8))
    return ideal


def fiducial_dir(d: str) -> None:
    """``tests/test_cli.py``'s fiducial case: ``imgs/m.png`` (marker 321,
    12 px cells, on white) and ``calib.yaml`` (a 220x200 camera, f 200)."""
    from boofcv_tpu_torch.geo import cameras
    from boofcv_tpu_torch.io import calibration_io as cio
    from boofcv_tpu_torch.io import image_io
    from boofcv_tpu_torch.recognition import fiducial_square as fid
    img = fid.encode_marker(321, cells_px=12)
    scene = np.full((200, 220), 255.0, np.float32)
    scene[40:40 + img.shape[0], 60:60 + img.shape[1]] = img
    os.makedirs(os.path.join(d, "imgs"), exist_ok=True)
    image_io.save(os.path.join(d, "imgs", "m.png"), scene.astype(np.uint8))
    cio.save_pinhole_brown(cameras.CameraPinholeBrown(
        fx=200.0, fy=200.0, cx=110.0, cy=100.0, width=220, height=200),
        os.path.join(d, "calib.yaml"))


def downsize_dir(d: str) -> np.ndarray:
    """``tests/test_cli.py``'s downsize input: ``a.png``, 96x128 uniform
    noise; returns it."""
    from boofcv_tpu_torch.io import image_io
    os.makedirs(d, exist_ok=True)
    img = np.random.default_rng(0).uniform(0, 255, (96, 128)).astype(
        np.uint8)
    image_io.save(os.path.join(d, "a.png"), img)
    return img


def phase_cli(dev) -> None:
    """``cli:`` the eight other commands on the card (``--device cuda``),
    in-process, each on the data ``tests/test_cli.py`` builds and held to
    that test's bars (``create_calibration_target``, which it does not
    test: a 5x6 chessboard of 40 px squares, margin 40, read back at its
    size).  One line a command: host wall ms and its check."""
    import importlib
    import tempfile
    from boofcv_tpu_torch.io import calibration_io as cio
    from boofcv_tpu_torch.io import image_io
    from boofcv_tpu_torch.recognition import fiducial_square as fid
    from boofcv_tpu_torch.recognition.qr import detector
    cmd = lambda name: importlib.import_module(
        f"boofcv_tpu_torch.cli.{name}").main
    dev_arg = ["--device", "cuda"]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        p = lambda *a: os.path.join(tmp, *a)

        def run(name, argv, bar):
            rc, log, wall = _run_command(cmd(name), argv + dev_arg)
            ok, what = (False, f"rc {rc}") if rc != 0 else bar(log)
            print(f"cli: {name}: {1e3 * wall:.1f} ms rc={rc} {what}")
            results.append((name, ok))

        qr_scan_dir(p("qr"))
        run("batch_scan_qr", ["--images", p("qr")], lambda log: (
            "alpha" in log and "beta" in log and "decoded 2/3" in log,
            "decoded " + log.strip().splitlines()[-1].split()[-1]
            + " (bar 2/3, alpha and beta)"))

        rows, cols, sq = CLI_BOARD
        board_views_dir(p("board"))

        def calibrated(log):
            cam = cio.load_pinhole_brown(p("cam.yaml"))
            return (abs(cam.fx - 300.0) / 300.0 < 0.05
                    and abs(cam.cx - 160.0) < 10,
                    f"fx {cam.fx:.4f} cx {cam.cx:.4f} (bars 300 +- 5 %, "
                    "160 +- 10)")
        run("camera_calibration", ["--images", p("board"), "--rows",
                                   str(rows), "--cols", str(cols),
                                   "--square", str(sq), "--output",
                                   p("cam.yaml")], calibrated)

        def markers(log):
            ids = []
            for mid in (7, 123):
                img = image_io.load(p("fid", f"fiducial_{mid:04d}.png"))
                ids += [d["id"] for d in fid.detect(img.astype(np.float32),
                                                    device=dev)]
            return ids == [7, 123], f"detected ids {ids} (bar [7, 123])"
        run("create_fiducial", ["--ids", "7", "123", "--size", "192",
                                "--output-dir", p("fid")], markers)

        ideal = distorted_capture_dir(p("lens"))

        def undistorted(log):
            out = image_io.to_gray(image_io.load(p("lens", "out", "a.png")))
            c = np.s_[20:-20, 20:-20]
            err = float(np.median(np.abs(out[c].astype(float) - ideal[c])))
            return ("undistorted 1/1" in log and err < 8.0,
                    f"median error {err:.3f} (bar 8)")
        run("batch_remove_distortion", ["--calib", p("lens", "calib.yaml"),
                                        "--input", p("lens", "in"),
                                        "--output", p("lens", "out")],
            undistorted)

        fiducial_dir(p("marker"))
        run("fiducial_detection", ["--images", p("marker", "imgs"),
                                   "--calib", p("marker", "calib.yaml"),
                                   "--size", "0.1"], lambda log: (
            "id=321" in log and "range=" in log
            and "found 1 fiducials" in log,
            log.strip().splitlines()[0]))

        def scanned(log):
            doc = image_io.to_gray(image_io.load(p("doc.png")))
            half = doc.shape[1] // 2
            texts = []
            for sl in (np.s_[:, :half], np.s_[:, half:]):
                data, _ = detector.detect_and_decode(
                    doc[sl].astype(np.float32), device=dev)
                if data is not None:
                    texts.append(data.decode())
            return (sorted(texts) == ["0123456789", "CLI DOC TEST"],
                    f"scanned back {sorted(texts)}")
        run("create_qr_document", ["--message", "CLI DOC TEST", "--message",
                                   "0123456789", "--output", p("doc.png")],
            scanned)

        img = downsize_dir(p("small", "in"))

        def downsized(log):
            out = image_io.load(p("small", "out", "a.png"))
            exp = img.reshape(48, 2, 64, 2).mean((1, 3))
            err = (float(np.abs(out.astype(float) - exp).max())
                   if out.shape == (48, 64) else float("inf"))
            return err <= 1.0, f"shape {out.shape}, max error {err} (bar 1)"
        run("batch_downsize", ["--input", p("small", "in"), "--output",
                               p("small", "out"), "--max-size", "64"],
            downsized)

        def target(log):
            out = image_io.load(p("target.png"))
            return (out.shape == (5 * 40 + 80, 6 * 40 + 80)
                    and out[40, 40] == 0 and out[0, 0] == 255,
                    f"{out.shape[1]}x{out.shape[0]}")
        run("create_calibration_target", ["--rows", "5", "--cols", "6",
                                          "--output", p("target.png")],
            target)
    bad = [name for name, ok in results if not ok]
    check(len(results) == 8 and not bad, f"cli: failed: {bad}")


# --- ``dist:``: the sharded paths on a one-rank NCCL group ----------------

DIST_PCG_ITERATIONS = 120
DIST_CPU_RANKS = 4
DIST_CPU_ITERATIONS = 5


def _dist_bytes(V: int, D: int, P: int, iters: int, solver: str) -> int:
    """Bytes one rank hands the collectives in a solve of ``iters`` LM
    iterations (f32 system, f64 costs): per iteration the Gauss-Newton
    diagonal and ``gv_t`` [V, D], ``S`` [V, V, D, D] (all-reduced, or
    reduce-scattered by view rows), two costs, and with PCG one all-gather
    of [V, D] for the preconditioned start and two a CG iteration; once,
    the final cost and the points' all-gather."""
    per_iter = 4 * (2 * V * D + V * V * D * D) + 2 * 8
    if solver == "pcg":
        per_iter += 4 * V * D * (1 + 2 * DIST_PCG_ITERATIONS)
    return iters * per_iter + 8 + 4 * P * 3


def _dist_ba(dev, mesh) -> None:
    """``optimize_sharded`` at ``ba_scale:``'s size in both solver modes,
    each held against ``ba.optimize`` on the same problem."""
    from boofcv_tpu_torch.dist import ba_sharded
    from boofcv_tpu_torch.geo import ba
    Rs, ts, pts, obs_xy, obs_view, obs_valid, fixed = big_scene()
    prob = ba.make_problem(Rs, ts, pts, obs_xy, obs_view, obs_valid,
                           fixed_views=fixed, dtype=torch.float32, device=dev)
    V, P, D, iters = len(Rs), len(pts), 6, 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _, info_ref = ba.optimize(prob, iterations=iters)
    torch.cuda.synchronize()
    peak_ref = torch.cuda.max_memory_allocated(dev) / 2**20
    ref_costs = _check_costs("dist: ba.optimize", info_ref)
    c_ref = float(info_ref["final_cost"])
    for solver in ("cholesky", "pcg"):
        solve = lambda: ba_sharded.optimize_sharded(
            prob, mesh, iterations=iters, reduced_solver=solver,
            pcg_iterations=DIST_PCG_ITERATIONS)
        solve()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        (out, info), syncs = _count_sync_warnings(solve)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        tag = f"dist: ba {solver}"
        costs = _check_costs(tag, info)
        again, info2 = solve()
        same = bool(all(torch.equal(getattr(out, k), getattr(again, k))
                        for k in ("R", "t", "points"))
                    and torch.equal(info["costs"], info2["costs"]))
        ms = _solve_ms(solve, reps=3, warm_up=False)
        events, _ = _trace(solve, cpu=False)
        busy = sum(e.device_time for e in events) / 1e3
        nccl = [e for e in events if "nccl" in e.name.lower()]
        nccl_ms = sum(e.device_time for e in nccl) / 1e3
        med = float(np.median(ms))
        c = float(info["final_cost"])
        rel = np.abs(costs - ref_costs) / np.abs(ref_costs)
        n_bytes = _dist_bytes(V, D, P, iters, solver)
        print(f"{tag}: V={V} P={P} L={obs_view.shape[1]} f32 mixed, {iters} "
              f"iterations on a one-rank NCCL group"
              + (f", {DIST_PCG_ITERATIONS} CG iterations"
                 if solver == "pcg" else "")
              + f": costs={[float(f'{x:.6e}') for x in costs]} "
              f"(ba.optimize {[float(f'{x:.6e}') for x in ref_costs]}; "
              f"largest relative gap {rel.max():.3e}); ms per solve="
              f"{[round(m, 3) for m in ms]} ms per iteration="
              f"{med / iters:.3f}; {len(events)} kernels, device busy "
              f"{busy:.3f} ms, idle share {1 - busy / med:.4f}; NCCL kernels "
              f"{len(nccl)}, device ms {nccl_ms:.4f}; bytes to the "
              f"collectives per iteration={n_bytes / iters:.0f} (S "
              f"{4 * V * V * D * D} of them; {n_bytes} a solve); host syncs="
              f"{sum(syncs.values())} {dict(sorted(syncs.items()))}; two "
              f"solves bit-equal={same}; peak device memory MiB={peak:.1f} "
              f"(ba.optimize {peak_ref:.1f}, the port's [V, V, D, D] "
              f"layout)")
        check(torch.isfinite(out.points).all() and torch.isfinite(out.R).all()
              and out.R.shape == prob.R.shape, f"{tag}: non-finite result")
        check(sum(syncs.values()) == 0, f"{tag}: host syncs in the solve: "
                                        f"{dict(syncs)}")
        if solver == "cholesky":
            check(rel.max() <= 1e-6, f"{tag}: costs {rel.max()} relative "
                                     "from ba.optimize's")
            check(same, f"{tag}: two solves differ in bits")
        else:
            check(abs(c - c_ref) <= 5e-3 * (1.0 + abs(c_ref)),
                  f"{tag}: final cost {c} against ba.optimize's {c_ref}")
            check(c < 0.5 * costs[0], f"{tag}: final cost {c} not below "
                                      f"half the first {costs[0]}")


def _dist_ransac(dev, mesh) -> None:
    """``ransac_pnp_sharded``: 512 points, 20 % outliers, 256 hypotheses
    (the JAX test's scene at 512 points)."""
    from boofcv_tpu_torch.dist.ransac_sharded import ransac_pnp_sharded
    rng = np.random.default_rng(0)
    n, n_out = 512, 512 // 5
    world = np.concatenate([rng.uniform(-2, 2, (n, 2)),
                            rng.uniform(4, 8, (n, 1))], 1)
    R_gt, t_gt = _rodrigues([0.1, -0.2, 0.05]), np.array([0.3, -0.1, 0.5])
    Xc = world @ R_gt.T + t_gt
    obs = Xc[:, :2] / Xc[:, 2:]
    obs[:n_out] += rng.uniform(0.05, 0.2, (n_out, 2))
    w, o = (torch.from_numpy(a).to(dev) for a in (world, obs))
    gen = torch.Generator(device=dev).manual_seed(1)
    call = lambda: ransac_pnp_sharded(mesh, gen, w, o,
                                      num_hypotheses_per_device=256,
                                      inlier_threshold=1e-5)
    gap, n_refine, _ = _gn_check("dist ransac_pnp_sharded",
                                 _capture_refine(call))
    GN_FAMILY_ERR["dist ransac_pnp_sharded"] = gap
    print(f"kernel: gn_pose dist ransac_pnp_sharded: {n_refine} refine "
          f"calls against the plain route, step_tol 1e-6 and 0: "
          f"max_abs_err={gap:.3e} (limit 1e-5)")
    (res, (R, t)), syncs = _count_sync_warnings(call)
    ms = _solve_ms(call, reps=5, warm_up=False)
    n_kernels, busy, _ = _profile_call(call)
    med = float(np.median(ms))
    inl = res.inliers.cpu().numpy()
    r_err = float(np.abs(R.cpu().numpy() - R_gt).max())
    t_err = float(np.abs(t.cpu().numpy() - t_gt).max())
    print(f"dist: ransac_pnp_sharded {n} points, {n_out} outliers, 256 "
          f"hypotheses on one rank: inliers {int(res.num_inliers)} (true "
          f"kept {inl[n_out:].mean():.4f}, outliers taken "
          f"{inl[:n_out].mean():.4f}); R error {r_err:.3e}, t error "
          f"{t_err:.3e} (bar 1e-5); ms per call={[round(m, 3) for m in ms]}; "
          f"{n_kernels} kernels, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / med:.4f}; host syncs={sum(syncs.values())} "
          f"{dict(sorted(syncs.items()))}")
    check(r_err < 1e-5 and t_err < 1e-5, "dist: ransac_pnp_sharded pose off")
    check(inl[n_out:].mean() > 0.95 and inl[:n_out].mean() < 0.2,
          "dist: ransac_pnp_sharded inliers off")


def _dist_matching(dev, mesh) -> None:
    """``match_pairs_sharded`` on ``sfm_uncalibrated:``'s orbit scene: 20
    views, 190 pairs, 64-dimensional descriptors."""
    from boofcv_tpu_torch.dist.matching_sharded import match_pairs_sharded
    poses, feats, ids = orbit_views(S2_VIEWS, S2_POINTS)
    n = max(len(f.xs) for f in feats)
    desc = np.zeros((S2_VIEWS, n, 64), np.float32)
    xy = np.zeros((S2_VIEWS, n, 2))
    for v, f in enumerate(feats):
        desc[v, :len(f.xs)] = f.desc
        xy[v, :len(f.xs)] = np.stack([f.xs, f.ys], 1)
    pairs = np.array([(a, b) for a in range(S2_VIEWS)
                      for b in range(a + 1, S2_VIEWS)])
    Kf = np.array([[S2_FOCAL, 0, (W - 1) / 2], [0, S2_FOCAL, (H - 1) / 2],
                   [0, 0, 1.0]])
    call = lambda: match_pairs_sharded(mesh, desc, xy, pairs,
                                       np.linalg.inv(Kf))
    out, syncs = _count_sync_warnings(call)
    ms = _solve_ms(call, reps=1, warm_up=False)
    common = np.array([len(np.intersect1d(ids[a], ids[b])) for a, b in pairs])
    share = out["num_inliers"] / common
    r_err = np.array([np.abs(out["R"][k] - poses[b][0] @ poses[a][0].T).max()
                      for k, (a, b) in enumerate(pairs)])
    print(f"dist: match_pairs_sharded {len(pairs)} pairs of {S2_VIEWS} views "
          f"(up to {n} features, 64-d) on one rank: inliers over the common "
          f"points min {share.min():.4f} median {np.median(share):.4f} (bar "
          f"0.7); relative rotation error max {r_err.max():.3e} (bar 1e-2); "
          f"ms per call={[round(m, 3) for m in ms]} (not profiled: the trace "
          f"of its hundreds of thousands of launches takes the profiler "
          f"minutes); host syncs={sum(syncs.values())}")
    check(out["num_inliers"].shape == (len(pairs),) and share.min() > 0.7
          and r_err.max() < 1e-2, "dist: match_pairs_sharded below its bars")


def _dist_reconstruction(dev, mesh) -> None:
    """``reconstruct_uncalibrated(mesh=)`` on ``sfm_uncalibrated:``'s scene:
    the pairwise graph equal to the unsharded call's, and that phase's
    bars."""
    from boofcv_tpu_torch.sfm import structure2
    poses, feats = orbit_scene(S2_VIEWS, S2_POINTS)
    imgs = [np.zeros((H, W), np.float32)] * S2_VIEWS

    def detect():
        it = iter(feats)
        return lambda im: next(it)
    plain = structure2.generate_pairwise_graph(imgs, detect=detect(),
                                               device=dev)
    run = lambda: structure2.reconstruct_uncalibrated(
        imgs, detect=detect(), device=dev, mesh=mesh)
    scene, _ = _multiview("dist", f"reconstruct_uncalibrated(mesh=) "
                          f"{S2_VIEWS} views x {S2_POINTS} points on one "
                          "rank", run, dev, reps=1, long_call=True)
    edges = scene["graph"].edges
    same = (sorted(edges) == sorted(plain.edges) and all(
        np.array_equal(edges[k].f_inliers, e.f_inliers)
        for k, e in plain.edges.items()))
    views = list(range(S2_VIEWS))
    f_est = scene["K"][0, 0]
    ferr = abs(f_est - S2_FOCAL) / S2_FOCAL
    err, span = _centre_error(poses, [scene["poses"].get(v, (np.eye(3),
                                                             np.zeros(3)))
                                      for v in views])
    print(f"dist: reconstruct_uncalibrated(mesh=): {len(edges)} edges, the "
          f"same edges and F inliers as the unsharded graph={same}; "
          f"{len(scene['poses'])}/{S2_VIEWS} views; focal {f_est:.4f} "
          f"(error {ferr:.6f}, bar 0.05); camera-centre error "
          f"{err / span:.6f} of the span (bar 0.01)")
    check(same, "dist: the sharded pairwise graph differs")
    check(sorted(scene["poses"]) == views and ferr < 0.05
          and err < 0.01 * span, "dist: reconstruct_uncalibrated(mesh=) "
                                 "below its bars")


def _dist_cpu_rank(rank, world, store, out_dir, prob) -> None:
    """One rank of the CPU leg: the problem through the 1-D mesh, the 2-D
    (host, shard) mesh and PCG."""
    import datetime
    import pickle
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from boofcv_tpu_torch.dist import ba_sharded, mesh as dmesh
        from boofcv_tpu_torch.geo import ba
        p = ba.problem_from_numpy(prob, device="cpu")
        res = {}
        for name, mesh, kw in (
                ("1d", dmesh.make_mesh(device="cpu"), {}),
                ("2d", dmesh.make_mesh_2d(2, world // 2, device="cpu"), {}),
                ("pcg", dmesh.make_mesh(device="cpu"),
                 {"reduced_solver": "pcg", "pcg_iterations": 200})):
            out, info = ba_sharded.optimize_sharded(
                p, mesh, iterations=DIST_CPU_ITERATIONS, **kw)
            res[name] = {"costs": info["costs"].numpy(),
                         "R": out.R.numpy(), "points": out.points.numpy()}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _dist_cpu_leg() -> None:
    """The same BA at test size on a four-process gloo group on this
    host's CPU (a CPU figure: it holds the collectives on this host's
    torch), against the one-process ``ba.optimize``."""
    import pickle
    import tempfile
    from boofcv_tpu_torch.geo import ba
    Rs, ts, pts, obs_xy, obs_view, obs_valid, fixed = window_ba_scene(
        V=22, P=401, L=6, seed=3)
    prob = ba.make_problem(Rs, ts, pts, obs_xy, obs_view, obs_valid,
                           fixed_views=fixed, device="cpu")
    _, info_ref = ba.optimize(prob, iterations=DIST_CPU_ITERATIONS)
    ref = info_ref["costs"].numpy()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _dist_cpu_rank, args=(DIST_CPU_RANKS, os.path.join(tmp, "store"),
                                  tmp, ba.problem_to_numpy(prob)),
            nprocs=DIST_CPU_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise SmokeFailure("dist: the CPU leg's ranks did not finish "
                                   "in 300 s")
        ranks = []
        for r in range(DIST_CPU_RANKS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    wall = time.perf_counter() - t0
    agree = all(np.array_equal(ranks[0][m][k], other[m][k])
                for other in ranks[1:] for m in ranks[0] for k in ranks[0][m])
    got = ranks[0]
    gap_1d = float((np.abs(got["1d"]["costs"] - ref) / ref).max())
    c1, c2, cp = (float(got[m]["costs"][-1]) for m in ("1d", "2d", "pcg"))
    gap_2d = abs(c2 - c1) / (1.0 + abs(c1))
    gap_pcg = abs(cp - c1) / (1.0 + abs(c1))
    print(f"dist: CPU leg (a CPU figure: {DIST_CPU_RANKS} gloo processes on "
          f"the card's host, torch {torch.__version__}, V={len(Rs)} P="
          f"{len(pts)} float64, {DIST_CPU_ITERATIONS} iterations): every rank "
          f"the same bits={agree}; 1-D costs within {gap_1d:.3e} relative of "
          f"the one-process ba.optimize (bar 1e-6); 2-D (2 x "
          f"{DIST_CPU_RANKS // 2}) final cost within {gap_2d:.3e} of the 1-D "
          f"(bar 1e-8); PCG (200 iterations, views padded to a multiple of "
          f"{DIST_CPU_RANKS}) within {gap_pcg:.3e} (bar 1e-4); {wall:.1f} s "
          f"with the processes' start")
    check(agree and gap_1d <= 1e-6 and gap_2d <= 1e-8 and gap_pcg <= 1e-4,
          "dist: the CPU leg's ranks disagree or miss their bars")


def phase_dist(dev) -> None:
    """``dist:`` the sharded paths through ``dist.make_mesh`` on the card (a
    one-rank NCCL group: the host has one card), then the CPU leg."""
    import torch.distributed as dist
    from boofcv_tpu_torch.dist import make_mesh
    mesh = make_mesh(device=dev)
    walls, by_part = {}, {}
    try:
        print(f"dist: mesh {mesh.mesh.tolist()} on {mesh.device_type}, "
              f"backend {dist.get_backend()}, NCCL "
              f"{torch.cuda.nccl.version()}")
        check(dist.get_backend() == "nccl", "dist: the card's group is not "
                                            "NCCL")
        for part in (_dist_ba, _dist_ransac, _dist_matching,
                     _dist_reconstruction):
            _reset_launches()
            t0 = time.perf_counter()
            part(dev, mesh)
            walls[part.__name__] = time.perf_counter() - t0
            by_part[part.__name__] = _launches()
    finally:
        dist.destroy_process_group()
    print(f"dist: hand-kernel launches by part: {by_part} (dist/ reaches "
          f"neither window_gather nor klt_track; ransac_pnp_sharded's "
          f"refine is gn_pose)")
    check(all(n["window_gather"] == 0 and n["klt_track"] == 0
              for n in by_part.values()),
          "dist: window_gather or klt_track launched on a path that reaches "
          "neither")
    check(by_part["_dist_ransac"]["gn_pose"] >= 1,
          "dist: ransac_pnp_sharded's refine did not launch gn_pose")
    check(by_part["_dist_ransac"]["pnp_bank"] >= 1,
          "dist: ransac_pnp_sharded's banks did not launch pnp_bank")
    t0 = time.perf_counter()
    _dist_cpu_leg()
    walls["_dist_cpu_leg"] = time.perf_counter() - t0
    print("dist: wall s by part (measurements included): " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items()))



# --- ``--sweep``: both kernels shape by shape, beside other trees' --------


_KERNEL_MODULES = ("boofcv_tpu_torch", "boofcv_tpu_torch.kernels",
                   "boofcv_tpu_torch.kernels._nvcc",
                   "boofcv_tpu_torch.kernels.window_gather",
                   "boofcv_tpu_torch.kernels.klt_track")


class _SweepTree:
    """One tree's kernel package, imported beside this tree's: its own
    wrappers, its own C interface and its own build (into its own
    ``_build/``), so a sweep times what a caller of that tree runs.
    ``defines`` are added to klt_track's nvcc flags (``-DKLT_SPLIT_ABOVE``
    picks the Gauss-Newton loop)."""

    def __init__(self, tag: str, tree: str, defines=()):
        self.tag = tag
        saved = {m: sys.modules.pop(m) for m in _KERNEL_MODULES
                 if m in sys.modules}
        sys.path.insert(0, os.path.abspath(tree))
        try:
            import boofcv_tpu_torch.kernels._nvcc as nv
            import boofcv_tpu_torch.kernels.klt_track as kt
            import boofcv_tpu_torch.kernels.window_gather as wg
            kt._KERNEL.flags += tuple(defines)
            kt._KERNEL.library()   # kept: built while this tree is imported
            wg._KERNEL.library()
        finally:
            sys.path.pop(0)
            for m in _KERNEL_MODULES:
                sys.modules.pop(m, None)
            sys.modules.update(saved)
        self.kt, self.wg = kt, wg
        self.records = {n: nv.build_record(n)
                        for n in ("klt_track", "window_gather")}

    def klt(self, args):
        return self.kt.klt_track_cuda(*args)

    def gather(self, img, oy, ox, wy, wx):
        return self.wg.gather_windows_cuda(img, oy, ox, wy, wx)

    def empty(self, n, wy, wx):
        return self.wg.launch_empty(n, wy, wx, torch.device("cuda", 0))


def _dump_sass(libs: dict, out: str) -> None:
    """``cuobjdump -sass`` of every library, with per-kernel counts of the
    instructions that shape the KLT chain."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for tag, path in libs.items():
        proc = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True)
        with open(os.path.join(out, f"{tag}.sass.txt"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        func, counts = None, {}
        for line in proc.stdout.splitlines():
            if "Function :" in line:
                func = line.split("Function :")[1].strip()
                counts[func] = {}
            elif func and line.strip().startswith("/*") and "*/" in line:
                words = line.split("*/", 1)[1].split()
                if words and words[0].startswith("@"):
                    words = words[1:]
                if words and not words[0].startswith("/*"):
                    op = words[0].split(".")[0]
                    counts[func][op] = counts[func].get(op, 0) + 1
        for func, c in counts.items():
            keep = {k: c.get(k, 0) for k in ("LDG", "LDGSTS", "LDS", "STS",
                                             "SHFL", "MUFU", "BRA", "BAR",
                                             "WARPSYNC", "VOTE", "DEPBAR",
                                             "STL", "LDL")}
            print(f"sass: {tag} {func[:60]} instructions={sum(c.values())} "
                  f"{keep}")


def _sweep_klt_inputs(dev, lefts, b, mode):
    """A ``chip_smoke._klt_case_scene`` of B streams: [512] on frames 0 ->
    1 (b = 0), b different frame pairs, or b streams on one shared pair."""
    g = torch.Generator(device=dev).manual_seed(b)
    if b == 0:
        return _klt_case_scene(dev, lefts[0], lefts[1])
    if mode == "frames":
        return _klt_case_scene(dev, lefts[:b], lefts[1:b + 1])
    jitter = torch.rand((b, 464), device=dev, generator=g) - 0.5
    return _klt_case_scene(dev, lefts[0].expand(b, H, W),
                              lefts[1].expand(b, H, W), jitter)


def _sweep_time(what, fn, kernel, reps, bnd=None, extra=""):
    """Device ms (profiler) and ms over 200 back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    dev_ms = device_ms(fn, reps, kernel)
    ms = cuda_ms(fn, 200)
    share = "" if bnd is None else (f" bound_ms={bnd['bound_ms']:.6f} "
                                    f"bound_by={bnd['bound_by']} share="
                                    f"{bnd['bound_ms'] / dev_ms:.4f}")
    print(f"sweep: {what} device_ms={dev_ms:.6f} ms_200_calls={ms:.6f}"
          f"{share}{extra}")
    return dev_ms


def _turns(others) -> list:
    """Each tree, then today twice, then each tree again in reverse."""
    tags = [o.tag for o in others] + ["today"]
    return tags + tags[::-1]


def _sweep_klt(dev, lefts, others):
    from boofcv_tpu_torch.feature import klt
    from boofcv_tpu_torch.kernels import klt_track as kt
    cfg = klt.KltConfig()
    by_tag = {o.tag: o for o in others}
    shapes = [("[512] 4 levels", 0, "frames"),
              ("[4, 512] frames", 4, "frames"),
              ("[8, 512] frames", 8, "frames"),
              ("[16, 512] frames", 16, "frames"),
              ("[64, 512] shared", 64, "shared"),
              ("[256, 512] shared", 256, "shared")]
    for what, b, mode in shapes:
        pyr, tm, ys, xs, scales = _sweep_klt_inputs(dev, lefts, b, mode)
        args = _klt_args(pyr, tm, ys, xs, scales, cfg)
        bnd, n_evals = _klt_bound(pyr, tm, ys, xs, scales, cfg)
        today = kt.klt_track_cuda(*args)
        line = f"sweep: klt_track {what} n={ys.numel()} evals={n_evals}"
        for o in others:
            old = o.klt(args)
            bits = all(torch.equal(p, q) for p, q in zip(old, today))
            faults = int((old[2] == today[2]).sum())
            err = float(torch.maximum((old[0] - today[0]).abs(),
                                      (old[1] - today[1]).abs()).max())
            line += (f" {o.tag}_bit_equal={bits} {o.tag}_faults_equal="
                     f"{faults}/{ys.numel()} {o.tag}_max_abs_px={err:.3e}")
        print(line)
        reps = 50 if b <= 16 else 20
        for tag in _turns(others):
            fn = ((lambda: kt.klt_track_cuda(*args)) if tag == "today"
                  else (lambda o=by_tag[tag]: o.klt(args)))
            _sweep_time(f"klt_track {what} {tag}", fn, "klt_track_kernel",
                        reps, bnd)
        if b == 0:        # the iteration cap and the level count
            subs = [(f"max_iterations={cap}", args[:8] + (cap,) + args[9:])
                    for cap in (1, 2, 4)]
            subs += [(f"levels={k}",
                      (args[0][:k], args[1][:k], args[2][:k], args[3][:k],
                       ys, xs, scales[:k]) + args[7:]) for k in (1, 2, 4)]
            for label, sub in subs:
                ev = int(kt.klt_track_cuda(*sub)[3].sum())
                for tag in [o.tag for o in others] + ["today"]:
                    fn = ((lambda sub=sub: kt.klt_track_cuda(*sub))
                          if tag == "today" else
                          (lambda o=by_tag[tag], sub=sub: o.klt(sub)))
                    _sweep_time(f"klt_track [512] {label} {tag}", fn,
                                "klt_track_kernel", 50,
                                extra=f" evals={ev}")
        del pyr, tm, ys, xs, args, today
        torch.cuda.empty_cache()


def _sweep_gather(dev, lefts, others):
    from boofcv_tpu_torch.kernels import window_gather as wg
    by_tag = {o.tag: o for o in others}
    g = torch.Generator(device=dev).manual_seed(1)
    for b, mode in ((0, "frames"), (16, "frames"), (64, "shared"),
                    (256, "shared")):
        lead = () if b == 0 else (b,)
        ys = torch.randint(0, H, lead + (512,), generator=g, device=dev,
                           dtype=torch.int32)
        xs = torch.randint(0, W, lead + (512,), generator=g, device=dev,
                           dtype=torch.int32)
        if b == 0:
            img = lefts[0]
        elif mode == "frames":
            img = lefts[:b]
        else:
            img = lefts[0].expand(b, H, W)
        shapes = [(7, 102, ys - 3, xs - 98), (7, 7, ys - 3, xs - 3)]
        if b == 0:
            cy, cx = ys.float() + 0.3, xs.float() + 0.6
            oy, ox, _, _ = wg.aligned_window_origin(cy, cx, 3, H, W)
            shapes.append((24, 16, oy, ox))
        for wy, wx, oy, ox in shapes if b == 0 else shapes[:1]:
            oy, ox = oy.contiguous(), ox.contiguous()
            want = wg.gather_windows_reference(img, oy, ox, wy, wx)
            got = wg.gather_windows_cuda(img, oy, ox, wy, wx)
            check(torch.equal(got, want), f"gather {wy}x{wx} B={b}")
            line = f"sweep: window_gather {wy}x{wx} b={b} {mode} equal=True"
            for o in others:
                line += (f" {o.tag}_equal="
                         f"{torch.equal(o.gather(img, oy, ox, wy, wx), want)}")
            print(line)
            shared = mode == "shared" and b > 0
            bnd = bound(touched_bytes(H, W, oy, ox, wy, wx,
                                            shared)
                           + 4 * oy.numel() * wy * wx + 8 * oy.numel(), 0)
            for tag in _turns(others):
                fn = ((lambda: wg.gather_windows_cuda(img, oy, ox, wy, wx))
                      if tag == "today" else
                      (lambda o=by_tag[tag]: o.gather(img, oy, ox, wy, wx)))
                _sweep_time(f"window_gather {wy}x{wx} origins="
                            f"{list(oy.shape)} {mode} {tag}", fn,
                            "window_gather_kernel", 50 if b <= 16 else 20,
                            bnd)
            n = oy.numel()
            for tag in [o.tag for o in others] + ["today"]:
                fn = ((lambda: wg.launch_empty(n, wy, wx, dev))
                      if tag == "today" else
                      (lambda o=by_tag[tag]: o.empty(n, wy, wx)))
                _sweep_time(f"window_gather {wy}x{wx} n={n} empty launch "
                            f"{tag}", fn, "window_gather_empty_kernel", 50)


def _gn_sweep_scene(dev, lead, n=600):
    """[*lead] pose problems of n points as ``robust.ransac_pnp`` hands them
    to the refine (R, t float32 0.035 rad and 5 cm off a true identity
    pose; world 3-12 m ahead, obs with 1e-3 noise and weights in float64,
    a fifth of the rows masked: weight 0, world 1.0, obs 0)."""
    from boofcv_tpu_torch.geo import se3
    g = torch.Generator().manual_seed(n + len(lead))
    shape = tuple(lead) + (n,)
    f64 = torch.float64
    world = torch.cat([torch.rand(shape + (2,), generator=g, dtype=f64) * 8
                       - 4, torch.rand(shape + (1,), generator=g,
                                       dtype=f64) * 9 + 3], -1)
    obs = (world[..., :2] / world[..., 2:]
           + 1e-3 * torch.randn(shape + (2,), generator=g, dtype=f64))
    keep = torch.rand(shape, generator=g) > 0.2
    world = torch.where(keep[..., None], world, 1.0)
    obs = torch.where(keep[..., None], obs, 0.0)
    R0 = se3.exp_so3(torch.full(tuple(lead) + (3,), 0.02, dtype=f64))
    t0 = torch.full(tuple(lead) + (3,), 0.03, dtype=f64)
    return [x.to(dev) for x in (R0.float(), t0.float(), world, obs,
                                keep.to(f64))]


def _sweep_gn_pose(dev):
    """``gn_pose`` at the VO cells' shapes, [600] and [16, 600] problems at
    50 iterations (their ``refine_iterations``): the kernel against the
    plain route (``geo/pnp._gn_pose_f32``) on the same tensors, the
    kernel's device ms, ms a call over 200 calls and bound, the plain
    route's device ms (every kernel it launches) and ms a call.  With the
    refine's tolerance (1e-6) a problem leaves the loop when it converges;
    with 0 every iteration runs, which the bound (:func:`_gn_bound`)
    counts."""
    from boofcv_tpu_torch.geo import pnp
    from boofcv_tpu_torch.kernels import _nvcc
    from boofcv_tpu_torch.kernels import gn_pose as gp
    gp._KERNEL.library()
    rec = _nvcc.build_record("gn_pose")
    print(f"sweep: gn_pose built={rec['built']} nvcc_s={rec['build_s']:.3f}")
    for fn, regs, stores, loads, stack in ptxas_summary(rec["ptxas"]):
        print(f"sweep: gn_pose ptxas: {fn} registers={regs} "
              f"spill_stores={stores} spill_loads={loads} "
              f"stack_frame={stack}")
    iterations = 50
    for lead in ((), (16,)):
        args = _gn_sweep_scene(dev, lead)
        n = args[2].shape[-2]
        for tol in (1e-6, 0.0):
            kernel = lambda: gp.gn_pose_cuda(*args, iterations, 1e-9, tol)
            plain = lambda: pnp._gn_pose_f32(*args, iterations, 1e-9, tol)
            (R, t), (Rp, tp) = kernel(), plain()
            gap = max(float((R - Rp).abs().max()), float((t - tp).abs().max()))
            check(gap <= 1e-5, f"gn_pose {list(lead)} step_tol={tol}: "
                               f"{gap:.3e} from the plain route")
            bnd = _gn_bound(args, iterations) if tol == 0 else None
            what = f"gn_pose [{', '.join(map(str, lead + (n,)))}] " \
                   f"iterations={iterations} step_tol={tol:g}"
            _sweep_time(what, kernel, "gn_pose_kernel", 50, bnd,
                        f" max_abs_from_plain={gap:.3e}")
            print(f"sweep: {what} plain device_ms="
                  f"{device_ms(plain, 3):.6f} ms_a_call="
                  f"{cuda_ms(plain, 5):.6f}")


def _sweep_pnp_bank(dev):
    """``pnp_bank`` at the VO cells' shapes, [200 x 4, 600] and [16,
    200 x 4, 600] (K = 200 samples of four solutions against N = 600
    tracks): the kernel against the plain route on the same banks, its
    device ms, ms a call and bound, the plain route's device ms (every
    kernel it launches), ms a call and launches (:func:`_bank_case`)."""
    from boofcv_tpu_torch.kernels import _nvcc
    from boofcv_tpu_torch.kernels import pnp_bank as pb
    pb._KERNEL.library()
    rec = _nvcc.build_record("pnp_bank")
    print(f"sweep: pnp_bank built={rec['built']} nvcc_s={rec['build_s']:.3f}")
    for fn, regs, stores, loads, stack in ptxas_summary(rec["ptxas"]):
        print(f"sweep: pnp_bank ptxas: {fn} registers={regs} "
              f"spill_stores={stores} spill_loads={loads} "
              f"stack_frame={stack}")
    for lead in ((), (16,)):
        _bank_case("sweep", *_bank_scene(dev, lead, seed=7))


def _venice_problem(dev, seed=1):
    """The float32 BA problem of the benchmark's ``venice.lm10`` cell (BAL
    Venice's counts, ``perfbench/traffic/bal_scene.py`` and the
    configuration's file), at start 0 of ``seed``, through
    ``io/bal.to_problem``."""
    import importlib.util
    from boofcv_tpu_torch.io import bal
    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "_bal_scene", os.path.join(root, "perfbench", "traffic",
                                   "bal_scene.py"))
    scene = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scene)
    with open(os.path.join(root, "perfbench", "configs",
                           "ba.bal_venice_1778.json")) as f:
        config = json.load(f)
    d = scene.draw(seed, config)
    cams, pts = scene.start(seed, config, d, 0)
    return bal.to_problem(dict(d, cameras=cams, points=pts),
                          dtype=torch.float32, device=dev)


def _sweep_schur_fill(dev):
    """``schur_fill`` at BAL Venice's shapes: the first LM iteration's
    Jacobi-scaled W and Y of each group of the solve's plan (lam 1e-3,
    point blocks inverted in float64, as ``optimize`` runs them), the
    kernel against the plain version (``ba._pair_sums``, run on the card)
    on the same tensors: the largest
    gap over S's largest element, whether the bits agree, the kernel's
    device ms (profiler) and bound, the plain version's device ms (every
    kernel it launches), and their sums over the groups: one iteration's
    fill-in."""
    from boofcv_tpu_torch.geo import ba
    from boofcv_tpu_torch.kernels import _nvcc
    from boofcv_tpu_torch.kernels import schur_fill as sf
    sf._KERNEL.library()
    rec = _nvcc.build_record("schur_fill")
    print(f"sweep: schur_fill built={rec['built']} "
          f"nvcc_s={rec['build_s']:.3f}")
    for fn, regs, stores, loads, stack in ptxas_summary(rec["ptxas"]):
        print(f"sweep: schur_fill ptxas: {fn} registers={regs} "
              f"spill_stores={stores} spill_loads={loads} "
              f"stack_frame={stack}")
    t0 = time.perf_counter()
    prob = _venice_problem(dev)
    V = prob.R.shape[0]
    plan = ba._buckets(prob, V)
    Jv, Jp, r = ba._slot_jacobians(prob, plan)
    Jv, Jp, _, _ = ba._slot_scale(plan, Jv, Jp,
                                  ba._slot_view_diag(Jv, plan, V))
    lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    print(f"sweep: schur_fill Venice V={V} slots={Jv.shape[0]} groups="
          f"{len(plan.groups)} pieces={len(plan.pieces)} (made in "
          f"{time.perf_counter() - t0:.1f}s)")
    total = {"kernel": 0.0, "plain": 0.0, "bound": 0.0, "bytes": 0,
             "flops": 0}
    S = torch.zeros((V * V,) + Jv.shape[-1:] * 2, device=dev)
    worst = 0.0
    for g, ((p0, p1, _, _, pairs), order, fill) in enumerate(zip(
            plan.groups, plan.orders, plan.fills)):
        blocks = [ba._point_blocks(ba._piece(Jv, pc), ba._piece(Jp, pc),
                                   ba._piece(r, pc), lam, torch.float64)
                  for pc in plan.pieces[p0:p1]]
        W, Y = (torch.cat([b[i].reshape((-1,) + b[i].shape[2:])
                           for b in blocks]) for i in (1, 5))
        del blocks
        plain = lambda: ba._pair_sums(W, Y, order, fill)
        want = plain()
        got = torch.zeros_like(want)
        ba._fill_in(got, W, Y, order, fill)
        got.neg_()
        gap = float((got - want).abs().max()) / float(want.abs().max())
        same = bool(torch.equal(got, want))
        del got, want
        worst = max(worst, gap)
        check(gap <= 1e-5, f"schur_fill Venice group {g}: {gap:.3e} from "
                           f"the plain version")
        bnd = _fill_bound(order, W)
        kernel_ms = _sweep_time(
            f"schur_fill Venice group {g} ({pairs} pairs formed, "
            f"{int(order.pair_offsets[-1])} valid)",
            lambda: ba._fill_in(S, W, Y, order, fill), "schur_fill_kernel",
            5, bnd, f" max_rel_from_plain={gap:.3e} bit_equal={same}")
        plain_ms = device_ms(plain, 2)
        print(f"sweep: schur_fill Venice group {g} plain device_ms="
              f"{plain_ms:.6f}")
        total["kernel"] += kernel_ms
        total["plain"] += plain_ms
        total["bound"] += bnd["bound_ms"]
        total["bytes"] += bnd["bytes"]
        total["flops"] += bnd["flops"]
    print(f"sweep: schur_fill Venice one iteration ({len(plan.groups)} "
          f"launches): device_ms={total['kernel']:.6f} bound_ms="
          f"{total['bound']:.6f} (bytes={total['bytes']} flops="
          f"{total['flops']}) share={total['bound'] / total['kernel']:.4f}; "
          f"plain version device_ms={total['plain']:.6f}; largest gap "
          f"{worst:.3e}")


def sweep_main(argv) -> int:
    """``chip_smoke.py --sweep``: see the module's docstring."""
    from boofcv_tpu_torch.kernels import _nvcc
    ap = argparse.ArgumentParser(prog="chip_smoke.py --sweep")
    ap.add_argument("--baseline", action="append", default=[],
                    metavar="[TAG=]DIR")
    ap.add_argument("--out", default=os.path.join(
        "boofcv_tpu_torch", "kernels", "_build", "sweep"))
    ap.add_argument("--kernel", action="append", choices=list(KERNELS),
                    help="time only these kernels (repeatable; default: "
                         "all)")
    a = ap.parse_args(argv)
    only = set(a.kernel or KERNELS)
    if not torch.cuda.is_available():
        print("chip_smoke --sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    os.makedirs(a.out, exist_ok=True)
    phase_environment()
    phase_build()
    records = {f"today_{n}": _nvcc.build_record(n)
               for n in ("klt_track", "window_gather")}
    others = []
    for i, spec in enumerate(a.baseline):
        tag, _, tree = spec.rpartition("=")
        others.append(_SweepTree(tag or ("baseline" if i == 0
                                         else f"baseline{i}"), tree))
    # this tree's klt_track with each Gauss-Newton loop at every count
    loops = [_SweepTree("single_loop", ".", ("-DKLT_SPLIT_ABOVE=2147483647",)),
             _SweepTree("split_loop", ".", ("-DKLT_SPLIT_ABOVE=0",))
             ] if "klt_track" in only else []
    for o in others + loops:
        records.update({f"{o.tag}_{n}": r for n, r in o.records.items()})
    for tag, rec in records.items():
        with open(os.path.join(a.out, f"{tag}.ptxas.txt"), "w") as f:
            f.write(rec["ptxas"] or "not measured: no report kept\n")
    _dump_sass({tag: rec["library"] for tag, rec in records.items()}, a.out)
    if only & {"window_gather", "klt_track"}:
        _, frames = _scene(17, K, H, W, seed=0)
        lefts = torch.stack([torch.from_numpy(frames[i][0])
                             for i in range(17)]).to(dev)
    try:
        if "gn_pose" in only:
            _sweep_gn_pose(dev)
        if "window_gather" in only:
            _sweep_gather(dev, lefts, others)
        if "klt_track" in only:
            _sweep_klt(dev, lefts, others + loops)
        if "schur_fill" in only:
            _sweep_schur_fill(dev)
        if "pnp_bank" in only:
            _sweep_pnp_bank(dev)
    except SmokeFailure as e:
        print(f"chip_smoke --sweep: FAILED: {e}", file=sys.stderr)
        return 1
    print("chip_smoke --sweep: OK")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    try:
        t_start = time.perf_counter()
        clock = lambda what: print(f"clock: {what} done "
                                   f"{time.perf_counter() - t_start:.1f} s "
                                   f"into the run")
        phase_environment()
        phase_build()
        t0 = time.perf_counter()
        poses, frames = _scene(N_FRAMES, K, H, W, seed=0)
        print(f"scene: rendered {N_FRAMES} frames {W}x{H} on the host in "
              f"{time.perf_counter() - t0:.2f}s")
        measured = {"window_gather": phase_kernel(dev),
                    "klt_track": phase_klt_kernel(dev, frames)}
        single = phase_slice(dev, poses, frames)
        measured["gn_pose"] = phase_gn_kernel(dev, "single stream",
                                              single.pop("refine_calls"))
        measured["pnp_bank"], batched_bank = phase_bank_kernel(dev)
        batched = phase_batched_kernels(dev, frames)
        by_path, calls16 = phase_batched(dev, poses, frames, single)
        batched["gn_pose"] = phase_gn_kernel(dev, "B=16", calls16)
        batched["pnp_bank"] = batched_bank
        del calls16
        launches = {"single stream": single["launches"], **by_path}
        phase_720p(dev)
        phase_ba(dev)
        measured["schur_fill"] = phase_ba_stages(dev)
        batched["schur_fill"] = None            # no stream axis
        launches["VO with window BA"] = phase_ba_vo(dev, poses, frames)
        phase_ba_scale(dev)
        clock("the VO and BA phases")
        phase_breadth_disparity(dev)
        phase_breadth_surf(dev)
        phase_breadth_assoc(dev)
        phase_breadth_flow(dev)
        clock("breadth_bm to breadth_flow")
        for phase in (phase_breadth_canny, phase_breadth_sift,
                      phase_breadth_flow2, phase_breadth_zhang99,
                      phase_geo_robust):
            phase(dev)
            clock(phase.__name__)
        launches["sparse SSD"] = phase_sparse_ssd(dev)
        launches.update(phase_vo_families(dev, poses, frames))
        clock("phase_vo_families")
        launches.update(phase_motion2d(dev))
        launches.update(phase_point_trackers(dev))
        clock("phase_motion2d and phase_point_trackers")
        phase_breadth_cpu_vs_card(dev)
        clock("phase_sparse_ssd and phase_breadth_cpu_vs_card")
        for phase in (phase_pose_graph, phase_spherical, phase_cloud,
                      phase_three_view, phase_sfm_uncalibrated,
                      phase_sfm_incremental, phase_binary, phase_fiducial,
                      phase_qr, phase_calib_targets, phase_ip_rest,
                      phase_background, phase_segmentation, phase_lines,
                      phase_template, phase_dense):
            phase(dev)
            clock(phase.__name__)
        launches.update(phase_trackers(dev))
        clock("phase_trackers")
        launches.update(phase_tld(dev))
        clock("phase_tld")
        for phase in (phase_scene, phase_deepboof, phase_io, phase_ip_more):
            phase(dev)
            clock(phase.__name__)
        launches["cli stereo_vo_demo"] = phase_cli_vo(dev, poses, frames)
        clock("phase_cli_vo")
        launches.update(phase_examples(dev))
        clock("phase_examples")
        phase_cli(dev)
        clock("phase_cli")
        phase_dist(dev)
        clock("phase_dist")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    measured["klt_track"]["max_abs_err"] = max(
        measured["klt_track"]["max_abs_err"],
        batched["klt_track"].pop("max_abs_err"), *KLT_FAMILY_ERR.values())
    measured["klt_track"]["max_abs_err_by_family"] = KLT_FAMILY_ERR
    measured["klt_track"]["tld_shape"] = TLD_KERNEL
    measured["gn_pose"]["max_abs_err"] = max(
        measured["gn_pose"]["max_abs_err"], *GN_FAMILY_ERR.values())
    measured["gn_pose"]["max_abs_err_by_family"] = GN_FAMILY_ERR
    # each path names the kernels it runs (the sparse SSD path runs only
    # the gather); every one of them must have launched on it
    for path, counts in launches.items():
        for name, n in counts.items():
            if n < 1:
                print(f"chip_smoke: FAILED: {name} was not launched on the "
                      f"path {path!r}", file=sys.stderr)
                return 1
    # top-level times and bound: the single-stream main path's shapes
    # ([512] windows of 7x102; 512 tracks on 4 levels; one pose problem of
    # 512 points); "batched": the B = 8 and B = 16 shapes
    from boofcv_tpu_torch.kernels import _nvcc
    fields = ("kernel", "registers", "spill_stores", "spill_loads",
              "stack_frame")
    ptxas = {name: [dict(zip(fields, row)) for row in
                    ptxas_summary(_nvcc.build_record(name)["ptxas"])]
                   or None for name in KERNELS}    # None: not measured
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
         "launches": sum(c.get(name, 0) for c in launches.values()),
         "launches_by_path": {p: c[name] for p, c in launches.items()
                              if name in c},
         **measured[name], "batched": batched[name], "ptxas": ptxas[name]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sweep"]:
        sys.exit(sweep_main(sys.argv[2:]))
    sys.exit(main())
