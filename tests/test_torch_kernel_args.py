"""The kernel wrappers' argument checks and packing, on the CPU.

``klt_track._pack``, ``window_gather._gather_geometry``, ``gn_pose._pack``
and ``schur_fill._pack`` are what the wrappers run before a launch: one
pass of cheap checks that fills the C structs (or the launch arguments),
and on anything refused the detailed
checks that name it.  They take tensors on any device (the kernels
themselves only run on the card, see test_torch_cuda.py), so what the
kernel is handed, and every refusal's message, is checked here; so is the
launch layer under the wrappers (``kernels/_nvcc.Kernel``), on a stub
library."""

import ctypes
import os
import subprocess
import types

import numpy as np
import pytest
import torch

from boofcv_tpu_torch.geo import ba, pnp
from boofcv_tpu_torch.kernels import _nvcc
from boofcv_tpu_torch.kernels import gn_pose as gp
from boofcv_tpu_torch.kernels import klt_track as kt
from boofcv_tpu_torch.kernels import pnp_bank as pb
from boofcv_tpu_torch.kernels import schur_fill as sf
from boofcv_tpu_torch.kernels import window_gather as wg

SCALES = (1, 2, 4)
SHAPES = ((60, 80), (30, 40), (15, 20))
CFG = (3, 8, 25.0, 0.001, 0.01)     # radius, iterations, error, det, tol


def _klt_args(lead=(), shared=False, n=16, p=7):
    g = torch.Generator().manual_seed(0)
    if shared:
        pyr = [torch.rand((h, w), generator=g).expand(lead + (h, w))
               for h, w in SHAPES]
    else:
        pyr = [torch.rand(lead + (h, w), generator=g) for h, w in SHAPES]
    tm = [[torch.rand(lead + (n, p, p), generator=g) for _ in SCALES]
          for _ in range(3)]
    ys = torch.rand(lead + (n,), generator=g) * 50
    xs = torch.rand(lead + (n,), generator=g) * 70
    return [pyr, *tm, ys, xs, SCALES, *CFG]


@pytest.mark.parametrize("lead,shared", [((), False), ((3,), False),
                                         ((3,), True)])
def test_klt_pack_fills_the_kernel_structs(lead, shared):
    """Every field of ``KltLevels`` and ``KltParams`` as the kernel reads
    it: level pointers, plane strides (0 for one frame or a shared one),
    sizes, ratios, and the scalar parameters."""
    args = _klt_args(lead, shared)
    pyr, desc, gx, gy, ys = args[:5]
    idx, shape, n = kt._pack(*args)
    assert (idx, tuple(shape), n) == (-1, tuple(ys.shape), ys.numel())
    (lv, prm, _), _ = kt._KERNEL.structs()
    for l, (h, w) in enumerate(SHAPES):
        assert lv.img[l] == pyr[l].data_ptr()
        assert (lv.desc[l], lv.gx[l], lv.gy[l]) == (
            desc[l].data_ptr(), gx[l].data_ptr(), gy[l].data_ptr())
        assert (lv.h[l], lv.w[l]) == (h, w)
        assert lv.stride[l] == (h * w if lead and not shared else 0)
    assert list(lv.ratio)[:4] == [1.0, 2.0, 2.0, 1.0]
    assert (lv.top_scale, lv.n_levels) == (4.0, 3)
    assert (prm.n, prm.per_stream, prm.radius, prm.max_iterations) == (
        ys.numel(), ys.shape[-1], 3, 8)
    assert np.allclose([prm.max_per_pixel_error, prm.min_determinant,
                        prm.convergence_tol], CFG[2:])
    assert ctypes.sizeof(kt._Levels) == kt._LEVELS_FMT.size


def _bad_klt_cases():
    """(what, change to the arguments, the refusal's words)."""
    def level0(i, f):
        return lambda a: a.__setitem__(i, [f(a[i][0])] + a[i][1:])
    return [
        ("ys float64", lambda a: a.__setitem__(4, a[4].double()),
         "ys must be float32"),
        ("desc half", level0(1, lambda t: t.half()),
         "desc.0. must be float32"),
        ("plane transposed", level0(0, lambda t: t.t().contiguous().t()),
         "contiguous"),
        ("desc transposed", level0(1, lambda t: t.transpose(1, 2)),
         "desc.0. must be contiguous"),
        ("grad_y 5x5", level0(3, lambda t: t[:, :5, :5].contiguous()),
         "grad_y.0. must be"),
        ("levels", lambda a: a.__setitem__(0, a[0][:2]),
         "pyramid has 2 levels"),
        ("xs shape", lambda a: a.__setitem__(5, a[5][:4]), "xs must be"),
        ("ys 2-D level", level0(0, lambda t: t[None].expand(2, *t.shape)),
         "for ys"),
        ("ys 3-D", lambda a: a.__setitem__(4, a[4][None, None]),
         r"\[N\] or \[B, N\]"),
        ("radius 8", lambda a: a.__setitem__(7, 8), "template_radius 8"),
        ("iterations", lambda a: a.__setitem__(8, -1), "negative"),
        ("nine levels", lambda a: a.__setitem__(6, tuple(range(1, 10))),
         "9 pyramid levels"),
        ("not a tensor", level0(2, lambda t: t.numpy()), "must be a tensor"),
    ]


@pytest.mark.parametrize("what,change,match", _bad_klt_cases(),
                         ids=[c[0] for c in _bad_klt_cases()])
def test_klt_pack_refuses_what_the_kernel_does_not_take(what, change, match):
    args = _klt_args()
    change(args)
    with pytest.raises(ValueError, match=match):
        kt._pack(*args)


@pytest.mark.parametrize("radius", [1, 3, 5, 7])
def test_klt_pack_takes_every_radius_and_a_strided_stack_not(radius):
    """Patches from 3x3 to 15x15 (every instantiation of the kernel) pack;
    every other frame of a longer stack is no stack the kernel takes."""
    args = _klt_args(p=2 * radius + 1)
    args[7] = radius
    assert kt._pack(*args) == (-1, torch.Size([16]), 16)
    assert kt._KERNEL.structs()[0][1].radius == radius
    args = _klt_args((4,), p=2 * radius + 1)
    args[7] = radius
    args[0] = [p.repeat(2, 1, 1)[::2] for p in args[0]]
    with pytest.raises(ValueError, match="stack"):
        kt._pack(*args)


@pytest.mark.parametrize("lead,mode", [((), "one"), ((3,), "stack"),
                                       ((3,), "shared")])
@pytest.mark.parametrize("wy,wx", [(7, 102), (7, 7), (24, 16), (5, 33)])
def test_gather_geometry(lead, mode, wy, wx):
    """What the gather's launch is given: the plane stride (0 for one
    frame, shared or not), the image size, windows an image, the output's
    shape."""
    g = torch.Generator().manual_seed(wx)
    img = torch.rand((40, 50), generator=g)
    if mode == "stack":
        img = torch.rand((3, 40, 50), generator=g)
    elif mode == "shared":
        img = img.expand(3, 40, 50)
    oy = torch.randint(-5, 45, lead + (9,), generator=g, dtype=torch.int32)
    ox = torch.randint(-5, 55, lead + (9,), generator=g, dtype=torch.int32)
    idx, geometry, shape = wg._gather_geometry(img, oy, ox, wy, wx)
    assert idx == -1
    assert geometry == ((2000 if mode == "stack" else 0), 40, 50, 9)
    assert shape == lead + (9, wy, wx)
    assert shape == tuple(wg.gather_windows_reference(img, oy, ox, wy,
                                                      wx).shape)


def _bad_gather_cases():
    img = torch.rand((3, 40, 50))
    o = torch.zeros((3, 9), dtype=torch.int32)
    return [
        ("origins int64", (img, o.long(), o, 7, 7), "oy must be"),
        ("image float64", (img.double(), o, o, 7, 7), "float32"),
        ("image transposed", (img.transpose(1, 2), o, o, 7, 7),
         "contiguous"),
        ("strided stack", (img.repeat(2, 1, 1)[::2], o, o, 7, 7), "stack"),
        ("origins for 2 images", (img, o[:2], o[:2], 7, 7), "origins for"),
        ("ox shape", (img, o, o[:, :4], 7, 7), "ox"),
        ("ox strided", (img, o, torch.zeros((3, 18), dtype=torch.int32)[:,
                                                                     ::2],
                        7, 7), "ox must be contiguous"),
        ("window", (img, o, o, 0, 7), "window 0x7"),
        ("empty image", (img[:, :0], o, o, 7, 7), "empty"),
        ("1-D image", (img[0, 0], o[0], o[0], 7, 7), r"\[h, w\]"),
    ]


@pytest.mark.parametrize("what,args,match", _bad_gather_cases(),
                         ids=[c[0] for c in _bad_gather_cases()])
def test_gather_geometry_refuses_what_the_kernel_does_not_take(what, args,
                                                               match):
    with pytest.raises(ValueError, match=match):
        wg._gather_geometry(*args)


def _cpu_calls(name):
    """Calls of kernel ``name``'s public function on CPU tensors (and, for
    ``schur_fill``, on no tensor at all)."""
    o = torch.zeros(4, dtype=torch.int32)
    return {
        "klt_track": [lambda: kt.klt_track_cuda(*_klt_args())],
        "window_gather": [lambda: wg.gather_windows_cuda(torch.zeros(8, 8),
                                                         o, o, 3, 3)],
        "gn_pose": [lambda: gp.gn_pose_cuda(*_gn_args(), 10, 1e-9, 1e-6)],
        "schur_fill": [lambda: sf.schur_fill_cuda(*_fill_args()),
                       lambda: sf.schur_fill_cuda(None, *_fill_args()[1:])],
        "pnp_bank": [lambda: pb.pnp_bank_cuda(*_bank_args(), 1e-5),
                     lambda: pb.pnp_bank_cuda(None, *_bank_args()[1:],
                                              1e-5)],
    }[name]


KERNELS = {"klt_track": kt, "window_gather": wg, "gn_pose": gp,
           "schur_fill": sf, "pnp_bank": pb}


@pytest.mark.parametrize("name", list(KERNELS))
def test_wrappers_refuse_cpu_tensors_before_any_check(name):
    """A CPU tensor never reaches the packing or the library."""
    mod = KERNELS[name]
    before = mod.launch_count()
    for call in _cpu_calls(name):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert mod.launch_count() == before


def test_each_thread_packs_its_own_structs():
    """Launches from several threads never see each other's arguments:
    each thread packs into its own structs (checked under a short switch
    interval, more threads than cores)."""
    import sys
    import threading
    errors = []

    def worker(n):
        args = _klt_args(n=n)
        gn = _gn_args(n=n)
        fill = _fill_args(R=n)
        try:
            for _ in range(200):
                kt._pack(*args)
                (lv, prm, _), _ = kt._KERNEL.structs()
                if prm.n != n or lv.desc[0] != args[1][0].data_ptr():
                    errors.append(n)
                geometry = wg._gather_geometry(args[0][0], args[4].int(),
                                               args[5].int(), 7, n)[1:]
                if geometry != ((0, 60, 80, n), (n, 7, n)):
                    errors.append(-n)
                gp._pack(*gn, n, 1e-9, 1e-6)
                (a,), _ = gp._KERNEL.structs()
                if a.iterations != n or a.world != gn[2].data_ptr():
                    errors.append(1000 + n)
                sf._pack(*fill)
                (a,), _ = sf._KERNEL.structs()
                if a.num_runs != n or a.S != fill[0].data_ptr():
                    errors.append(2000 + n)
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(n,))
                   for n in range(9, 25)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []


F32, F64 = torch.float32, torch.float64
RANSAC_DTYPES = (F32, F32, F64, F64, F64)   # as robust.ransac_pnp passes them


def _gn_args(lead=(), n=7, dtypes=RANSAC_DTYPES):
    """R, t, world, obs, weights of ``gn_pose_cuda`` (values do not
    matter to the packing)."""
    g = torch.Generator().manual_seed(n)
    shapes = (lead + (3, 3), lead + (3,), lead + (n, 3), lead + (n, 2),
              lead + (n,))
    return [torch.rand(s, generator=g, dtype=d)
            for s, d in zip(shapes, dtypes)]


@pytest.mark.parametrize("lead,dtypes", [((), RANSAC_DTYPES),
                                         ((16,), RANSAC_DTYPES),
                                         ((2, 3), (F64,) * 5),
                                         ((4,), (F32,) * 5)])
def test_gn_pose_pack_fills_the_kernel_struct(lead, dtypes):
    """Every field of ``GnPoseArgs`` as the kernel reads it: the input
    pointers, a float64 flag each, the problems (leading axes flattened),
    points, iterations, damping and tolerance; the output pointers are the
    wrapper's, after its allocation."""
    args = _gn_args(lead, dtypes=dtypes)
    idx, shape, b = gp._pack(*args, 50, 1e-9, 1e-6)
    assert (idx, tuple(shape), b) == (-1, lead, int(np.prod(lead)))
    (a,), _ = gp._KERNEL.structs()
    assert [a.R, a.t, a.world, a.obs, a.wgt] == [x.data_ptr() for x in args]
    assert (a.R_out, a.t_out) == (None, None)
    assert (a.b, a.n, a.iterations) == (b, 7, 50)
    assert (a.damping, a.step_tol) == (np.float32(1e-9), np.float32(1e-6))
    assert [a.R_f64, a.t_f64, a.world_f64, a.obs_f64, a.wgt_f64] == [
        int(d is F64) for d in dtypes]
    assert ctypes.sizeof(gp._Args) == gp._ARGS_FMT.size


def _bad_gn_cases():
    """(what, change to the arguments, the refusal's words)."""
    def at(i, f):
        return lambda a: a.__setitem__(i, f(a[i]))
    return [
        ("R half", at(0, lambda x: x.half()),
         "R must be float32 or float64"),
        ("weights int64", at(4, lambda x: x.long()),
         "weights must be float32 or float64"),
        ("R of one problem", at(0, lambda x: x[0]), r"R must be \(3, 3, 3\)"),
        ("t 2 columns", at(1, lambda x: x[:, :2].contiguous()),
         r"t must be \(3, 3\)"),
        ("obs 3 columns", at(3, lambda x: torch.cat([x, x[..., :1]], -1)),
         r"obs must be \(3, 7, 2\)"),
        ("weights one short", at(4, lambda x: x[:, 1:].contiguous()),
         r"weights must be \(3, 7\)"),
        ("world 2 columns", at(2, lambda x: x[..., :2].contiguous()),
         r"world must be \[\.\.\., N, 3\]"),
        ("world 1-D", at(2, lambda x: x[0, 0]), "world must be"),
        ("world transposed",
         at(2, lambda x: x.transpose(-1, -2).contiguous().transpose(-1, -2)),
         "world must be contiguous"),
        ("obs strided",
         at(3, lambda x: torch.cat([x, x], -1)[..., ::2]),
         "obs must be contiguous"),
        ("not a tensor", at(0, lambda x: x.numpy()), "R must be a tensor"),
        ("iterations", lambda a: a.__setitem__(5, -1), "negative"),
    ]


@pytest.mark.parametrize("what,change,match", _bad_gn_cases(),
                         ids=[c[0] for c in _bad_gn_cases()])
def test_gn_pose_pack_refuses_what_the_kernel_does_not_take(what, change,
                                                            match):
    args = _gn_args((3,)) + [50, 1e-9, 1e-6]
    change(args)
    with pytest.raises(ValueError, match=match):
        gp._pack(*args)


def _pose_scene(lead=(), n=120, seed=0):
    """A PnP problem: points 4-8 m ahead, their normalized projections
    with 1e-3 noise, a tenth of them masked as ``robust.ransac_pnp`` masks
    rows (weight 0, world 1.0, obs 0), and a start pose 0.03 rad and 5 cm
    off."""
    rng = np.random.default_rng(seed)
    world = np.concatenate([rng.uniform(-3, 3, lead + (n, 2)),
                            rng.uniform(4, 8, lead + (n, 1))], -1)
    obs = world[..., :2] / world[..., 2:] + rng.normal(0, 1e-3,
                                                       lead + (n, 2))
    keep = rng.uniform(size=lead + (n,)) > 0.1
    world = np.where(keep[..., None], world, 1.0)
    obs = np.where(keep[..., None], obs, 0.0)
    w = np.array([0.02, -0.01, 0.015])
    th = np.linalg.norm(w)
    Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R0 = (np.eye(3) + np.sin(th) / th * Kx
          + (1 - np.cos(th)) / th ** 2 * Kx @ Kx)
    R0 = np.broadcast_to(R0, lead + (3, 3))
    t0 = np.broadcast_to(np.array([0.03, -0.02, 0.05]), lead + (3,))
    return (torch.from_numpy(R0.astype(np.float32)),
            torch.from_numpy(t0.astype(np.float32)),
            torch.from_numpy(world), torch.from_numpy(obs),
            torch.from_numpy(keep.astype(np.float64)))


@pytest.mark.parametrize("lead,polish", [((), 0), ((4,), 0), ((), 2)])
def test_gauss_newton_pose_on_cpu_takes_the_plain_loop(lead, polish):
    """CPU tensors never reach the kernel: no launch, and the float32 stage
    is the plain version's, bit for bit (the polish after it too)."""
    R0, t0, world, obs, wgt = _pose_scene(lead)
    before = gp.launch_count()
    R, t = pnp.gauss_newton_pose(R0, t0, world, obs, wgt, iterations=12,
                                 damping=1e-9, polish_iterations=polish)
    assert gp.launch_count() == before
    Rp, tp = pnp._gn_pose_f32(R0, t0, world, obs, wgt, 12 - polish, 1e-9,
                              1e-6)
    if polish:
        Rp, tp = pnp._gn_pose_loop(Rp, tp, world, obs, wgt, polish, 1e-9,
                                   torch.float64, 1e-14)
    assert R.dtype == t.dtype == torch.float64
    assert torch.equal(R, Rp) and torch.equal(t, tp)
    # the true pose is the identity: the refine got there, masked rows
    # adding nothing, and R is a rotation after the Newton-polar steps
    eye = torch.eye(3, dtype=torch.float64)
    assert float((R - eye).abs().max()) < 2e-3
    assert float(t.abs().max()) < 2e-2
    assert float((R @ R.transpose(-1, -2) - eye).abs().max()) < 1e-12


@pytest.mark.parametrize("dtype,shape,want", [
    (torch.float16, (3, 3), torch.float32),
    (torch.bfloat16, (4, 3, 3), torch.float32),
    (torch.int64, (3, 3), torch.float32),
    (torch.float64, (3, 3), torch.float64),
    (torch.float32, (4, 3, 3), torch.float32)])
def test_kernel_input_casts_and_broadcasts_as_the_plain_loop_reads(
        dtype, shape, want):
    """What ``gauss_newton_pose`` hands the kernel: float32 or float64 as
    given, any other dtype cast to float32 (the plain loop's cast), the
    leading shape broadcast to world's, contiguous; an input already so
    is passed on as it is."""
    x = torch.arange(9).reshape(shape[-2:]).to(dtype).expand(shape)
    y = pnp._kernel_input(x, (4, 3, 3))
    assert y.dtype == want and y.shape == (4, 3, 3) and y.is_contiguous()
    assert torch.equal(y, x.to(want).expand(4, 3, 3))
    if x.is_contiguous() and x.shape == (4, 3, 3):
        assert y is x


def test_gauss_newton_pose_broadcasts_on_cpu():
    """The contract both routes keep: world's leading shape is the
    problems', and R, t, obs and weights broadcast to it in any real dtype,
    giving what the same call with each expanded and cast gives, to the
    float32 loop's resolution (1e-5: a broadcast operand takes another
    GEMM, which sums in another order)."""
    R0, t0, world, obs, wgt = _pose_scene()
    world = world + 1e-3 * torch.arange(4.0, dtype=world.dtype)[:, None,
                                                                 None]
    R, t = pnp.gauss_newton_pose(R0, t0.half(), world, obs, wgt.long(),
                                 iterations=12, damping=1e-9,
                                 polish_iterations=0)
    ex = lambda x, s: x.expand(s)
    Rp, tp = pnp.gauss_newton_pose(
        ex(R0, (4, 3, 3)), ex(t0.half().float(), (4, 3)), world,
        ex(obs, (4,) + obs.shape), ex(wgt.float(), (4,) + wgt.shape),
        iterations=12, damping=1e-9, polish_iterations=0)
    assert R.shape == (4, 3, 3) and t.shape == (4, 3)
    np.testing.assert_allclose(R, Rp, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t, tp, atol=1e-5, rtol=0)


def _long_tracks(V=40, P=300, longest=30, L=34, seed=0):
    """A BA problem (float64, the CPU, track lengths noted) whose points
    are seen by 2 to ``longest`` consecutive views, each point's
    observations in random columns of a [P, L] table with invalid slots
    between them.  Only the views matter here."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(2 + rng.zipf(1.5, P), longest)
    lengths[:3] = (longest, 17, 24)
    view = np.zeros((P, L), np.int64)
    valid = np.zeros((P, L), bool)
    for p, n in enumerate(lengths):
        cols = rng.permutation(L)[:n]
        view[p, cols] = (rng.integers(V) + np.arange(n)) % V
        valid[p, cols] = True
    return ba.make_problem(np.tile(np.eye(3), (V, 1, 1)), np.zeros((V, 3)),
                           rng.normal(size=(P, 3)), np.zeros((P, L, 2)),
                           view, valid, model="snavely", device="cpu")


def _decode(pairs, pieces):
    """The slots (l, m) of a group's pair indices, as csrc/schur_fill.cu
    decodes them: the last piece with pair0 <= e holds e, and e - pair0 =
    (point * width + a) * width + b."""
    rows = np.asarray(pieces, np.int64)
    k = np.searchsorted(rows[:, 0], pairs, side="right") - 1
    pair0, slot0, w = rows[k].T
    point, rem = np.divmod(pairs - pair0, w * w)
    a, b = np.divmod(rem, w)
    return slot0 + point * w + a, slot0 + point * w + b


@pytest.mark.parametrize("budget", [None, 81 * 8 * 900])
def test_fill_tables_decode_to_every_valid_pair_once(budget, monkeypatch):
    """The fill table ``_buckets`` builds for each group: pieces in
    increasing pair0 with the group's own slot offsets, and the view pairs
    that have a pair listed first, each part in key order.  Every pair
    index in a run decodes to two valid slots of one point whose views are
    the run's; over the groups every valid (point, v_l, v_m) appears once.
    With a small budget the plan has many groups and tracks wider than
    16."""
    if budget is not None:
        monkeypatch.setattr(ba, "_PAIR_BYTES", budget)
    prob = _long_tracks()
    V = prob.R.shape[0]
    plan = ba._buckets(prob, V)
    assert len(plan.fills) == len(plan.groups) == len(plan.orders)
    assert (len(plan.groups) > 4) == (budget is not None)
    assert max(w for _, _, w, _ in plan.pieces) == 30
    view = plan.obs_view.long().numpy()
    found = []
    for (p0, p1, s0, s1, pairs), order, fill in zip(
            plan.groups, plan.orders, plan.fills):
        assert len(fill.pieces) == p1 - p0
        assert [row[1:] for row in fill.pieces] == [
            (a - s0, w) for a, _, w, _ in plan.pieces[p0:p1]]
        assert fill.pieces[0][0] == 0 and all(
            b[0] - a[0] == n * w * w for a, b, (_, n, w, _) in zip(
                fill.pieces, fill.pieces[1:], plan.pieces[p0:p1]))
        off = order.pair_offsets.numpy()
        runs = fill.runs.numpy()
        assert fill.runs.dtype == torch.int32 and runs.shape == (V * V,)
        full = off[runs + 1] > off[runs]
        n_full = int(full.sum())
        assert full[:n_full].all() and not full[n_full:].any()
        assert (np.diff(runs[:n_full]) > 0).all()
        assert (np.diff(runs[n_full:]) > 0).all()
        perm = order.pair_perm.numpy()[:off[-1]]
        key = np.repeat(np.arange(V * V), np.diff(off))
        sl, sm = _decode(perm, fill.pieces)
        assert ((0 <= sl) & (sl < s1 - s0) & (0 <= sm) & (sm < s1 - s0)).all()
        sl, sm = sl + s0, sm + s0
        assert (view[sl] * V + view[sm] == key).all()
        point = plan.slot_point.numpy()
        assert (point[sl] == point[sm]).all()
        assert plan.obs_valid.numpy()[sl].all()
        assert plan.obs_valid.numpy()[sm].all()
        found.append(np.stack([plan.points.numpy()[point[sl]], view[sl],
                               view[sm]], 1))
    found = np.concatenate(found)
    v = prob.obs_view.long().numpy()
    ok = prob.obs_valid.numpy()
    want = [(p, a, b) for p in range(v.shape[0]) for a in v[p][ok[p]]
            for b in v[p][ok[p]]]
    assert len(found) == len(want) == ba.pair_counts()[1]
    assert sorted(map(tuple, found.tolist())) == sorted(want)


def test_kernel_sums_as_decoded_are_the_plain_fill_in(monkeypatch):
    """What the kernel adds, emulated from the fill table alone (each run's
    pairs decoded and summed in run order, the sum subtracted from S),
    is what the plain version (``_pair_products`` and ``_segment_sum``)
    subtracts, group by group, within float64 rounding; the plain version
    launches nothing."""
    monkeypatch.setattr(ba, "_PAIR_BYTES", 81 * 8 * 2000)
    prob = _long_tracks(seed=1)
    V = prob.R.shape[0]
    plan = ba._buckets(prob, V)
    assert len(plan.groups) > 1
    rng = np.random.default_rng(2)
    before = sf.launch_count()
    for (_, _, s0, s1, _), order, fill in zip(plan.groups, plan.orders,
                                              plan.fills):
        W = rng.normal(size=(s1 - s0, 3, 9))
        Y = rng.normal(size=(s1 - s0, 3, 9))
        S0 = rng.normal(size=(V * V, 9, 9))
        got = torch.from_numpy(S0.copy())
        ba._fill_in(got, torch.from_numpy(W), torch.from_numpy(Y), order,
                    fill)
        want = S0.copy()
        off = order.pair_offsets.numpy()
        perm = order.pair_perm.numpy()
        for run in fill.runs.numpy():
            if off[run] == off[run + 1]:
                break
            sl, sm = _decode(perm[off[run]:off[run + 1]], fill.pieces)
            acc = np.zeros((9, 9))
            for a, b in zip(sl, sm):
                acc += W[a].T @ Y[b]
            want[run] -= acc
        assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    assert sf.launch_count() == before


def _fill_args(D=9, dtype=torch.float32, N=12, R=16, pairs=40):
    """S, W, Y, pair_perm, pair_offsets, runs, pieces of ``schur_fill_cuda``
    (values do not matter to the packing)."""
    g = torch.Generator().manual_seed(D)
    return [torch.rand((R, D, D), generator=g, dtype=dtype),
            torch.rand((N, 3, D), generator=g, dtype=dtype),
            torch.rand((N, 3, D), generator=g, dtype=dtype),
            torch.arange(pairs), torch.linspace(0, pairs, R + 1).long(),
            torch.arange(R, dtype=torch.int32), ((0, 0, 2), (8, 4, 4))]


@pytest.mark.parametrize("D,dtype", [(9, torch.float32), (6, torch.float64),
                                     (7, torch.float32)])
def test_schur_fill_pack_fills_the_kernel_struct(D, dtype):
    """Every field of ``SchurFillArgs`` as the kernel reads it: the
    pointers, runs, pieces and their rows, D and the float64 flag."""
    args = _fill_args(D, dtype)
    assert sf._pack(*args) == (-1, 16)
    (a,), _ = sf._KERNEL.structs()
    assert [a.W, a.Y, a.pair_perm, a.pair_offsets, a.runs, a.S] == [
        x.data_ptr() for x in args[1:6] + args[:1]]
    assert (a.num_runs, a.num_pieces, a.d, a.f64) == (
        16, 2, D, int(dtype == torch.float64))
    assert list(a.pieces[:6]) == [0, 0, 2, 8, 4, 4]
    assert ctypes.sizeof(a) == 6 * 8 + 4 * 4 + 4 * 3 * sf.MAX_PIECES
    assert sf._HEAD_FMT.size == sf._Args.pieces.offset


def _bad_fill_cases():
    """(what, change to the arguments, the refusal's words)."""
    def at(i, f):
        return lambda a: a.__setitem__(i, f(a[i]))
    return [
        ("S half", at(0, lambda x: x.half()), "S must be float32 or float64"),
        ("S not square", at(0, lambda x: x[:, :, :8]),
         r"S must be \[R, D, D\]"),
        ("D 10", lambda a: a.__setitem__(slice(0, 3), [
            torch.zeros(16, 10, 10), torch.zeros(12, 3, 10),
            torch.zeros(12, 3, 10)]), "1 to 9"),
        ("W float64", at(1, lambda x: x.double()), "W must be torch.float32"),
        ("Y one slot short", at(2, lambda x: x[1:]),
         r"Y must be \(12, 3, 9\)"),
        ("W 2-D", at(1, lambda x: x[0]), r"W must be \[N, 3, 9\]"),
        ("Y transposed", at(2, lambda x: x.transpose(0, 1).contiguous()
                            .transpose(0, 1)), "Y must be contiguous"),
        ("pair_perm int32", at(3, lambda x: x.int()),
         "pair_perm must be torch.int64"),
        ("pair_offsets one short", at(4, lambda x: x[1:]),
         r"pair_offsets must be \(17,\)"),
        ("runs int64", at(5, lambda x: x.long()), "runs must be torch.int32"),
        ("runs strided", at(5, lambda x: torch.stack([x, x], 1)[:, 0]),
         "runs must be contiguous"),
        ("W on meta", at(1, lambda x: x.to("meta")), "W on meta"),
        ("not a tensor", at(2, lambda x: x.numpy()), "Y must be a tensor"),
        ("no piece", lambda a: a.__setitem__(6, ()), "0 pieces"),
        ("too many pieces", lambda a: a.__setitem__(
            6, tuple((k, 0, 1) for k in range(sf.MAX_PIECES + 1))),
         "129 pieces"),
        ("pair0 past the pairs", lambda a: a.__setitem__(
            6, ((0, 0, 2), (40, 4, 4))), "outside 40 pairs"),
        ("slot0 past the slots", lambda a: a.__setitem__(
            6, ((0, 12, 2),)), "outside 40 pairs and 12 slots"),
        ("pieces out of order", lambda a: a.__setitem__(
            6, ((0, 0, 2), (8, 4, 4), (8, 6, 2))), "increasing pair0"),
    ]


@pytest.mark.parametrize("what,change,match", _bad_fill_cases(),
                         ids=[c[0] for c in _bad_fill_cases()])
def test_schur_fill_pack_refuses_what_the_kernel_does_not_take(what, change,
                                                               match):
    args = _fill_args()
    change(args)
    with pytest.raises(ValueError, match=match):
        sf._pack(*args)


# --- the launch layer under the wrappers (kernels/_nvcc.Kernel) ----------


class _StubLibrary:
    """Stands in for a kernel's loaded library: ``<name>_launch`` records
    its arguments and returns ``err``; ``<name>_error_string`` names the
    code as the kernel's own would."""

    def __init__(self, name, err=0):
        self.calls = []

        def launch(*args):
            self.calls.append(args)
            return err

        def error_string(code):
            return f"{name} refused it ({code})".encode()

        setattr(self, f"{name}_launch", launch)
        setattr(self, f"{name}_error_string", error_string)
        setattr(self, f"{name}_empty_launch", launch)


def _stub_kernel(monkeypatch, mod, err=0):
    """Load ``mod``'s kernel as a stub library and launch through a fake
    device call that hands the launcher stream 77; every cached piece of
    the kernel is put back afterwards."""
    k = mod._KERNEL
    for attr in ("_lib", "_launcher", "_launches"):
        monkeypatch.setattr(k, attr, getattr(k, attr))
    k._lib = k._launcher = None
    lib = _StubLibrary(k.name, err)
    loads = []

    def load(name, flags=()):
        loads.append((name, tuple(flags)))
        return lib
    monkeypatch.setattr(_nvcc, "load_library", load)
    monkeypatch.setattr(_nvcc, "call_on_device",
                        lambda index, fn, *args: fn(*args, 77))
    return k, lib, loads


@pytest.mark.parametrize("err", [0, 700])
@pytest.mark.parametrize("name", list(KERNELS))
def test_launch_raises_the_kernels_message_and_counts_success(
        monkeypatch, name, err):
    """A launch hands the launcher this thread's structs and the stream,
    in the C ABI the layer declared; a nonzero return raises with the
    kernel's own message and is not counted, a zero return counts once."""
    mod = KERNELS[name]
    k, lib, loads = _stub_kernel(monkeypatch, mod, err)
    before = mod.launch_count()
    if err:
        with pytest.raises(RuntimeError,
                           match=rf"^{name} launch failed: {name} refused it "
                                 rf"\(700\) \(700\)$"):
            k.launch(0)
    else:
        k.launch(0)
    assert mod.launch_count() == before + (err == 0)
    assert loads == [(name, k.flags)]
    (call,) = lib.calls
    objs, refs = k.structs()
    assert len(call) == len(objs) + 1 and call[-1] == 77
    assert [ctypes.addressof(r._obj) for r in call[:-1]] == [
        ctypes.addressof(o) for o in objs]
    fn = getattr(lib, f"{name}_launch")
    assert fn.argtypes == [ctypes.POINTER(type(o)) for o in objs] + [
        ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    assert getattr(lib, f"{name}_error_string").restype is ctypes.c_char_p
    mod.reset_launch_count()
    assert mod.launch_count() == 0


def test_the_empty_probe_is_not_counted(monkeypatch):
    """``launch_empty`` runs the probe on the device's stream and counts
    nothing; a failed probe raises with the kernel's message."""
    monkeypatch.setattr(torch.cuda, "_get_device_index",
                        lambda device, optional=False: 0)
    k, lib, _ = _stub_kernel(monkeypatch, wg)
    before = wg.launch_count()
    wg.launch_empty(512, 7, 102, "cuda")
    assert lib.calls == [(512, 7, 102, 77)]
    assert wg.launch_count() == before
    k, lib, _ = _stub_kernel(monkeypatch, wg, err=98)
    with pytest.raises(RuntimeError, match="^empty launch failed: "
                                           "window_gather refused it"):
        wg.launch_empty(512, 7, 102, "cuda")
    assert wg.launch_count() == before


def test_threads_racing_to_first_use_load_once(monkeypatch):
    """Threads that reach a kernel's first use together (``chip_smoke``
    builds every kernel from a pool) build and declare it once, and each
    gets the same library."""
    import threading
    import time
    k, lib, loads = _stub_kernel(monkeypatch, gp)
    slow = _nvcc.load_library

    def load(name, flags=()):
        time.sleep(0.05)
        return slow(name, flags)
    monkeypatch.setattr(_nvcc, "load_library", load)
    got = []
    threads = [threading.Thread(target=lambda: got.append(k.library()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(loads) == 1 and got == [lib] * 8


@pytest.mark.parametrize("name", list(KERNELS))
def test_nvcc_command_carries_each_kernels_own_flags(monkeypatch, tmp_path,
                                                     name):
    """The nvcc command a wrapper's first use runs is the shared flags and
    then the module's own: ``-fmad=false`` for ``klt_track`` and
    ``pnp_bank`` alone.  ``_nvcc`` itself names no kernel."""
    k = KERNELS[name]._KERNEL
    monkeypatch.setattr(k, "_lib", None)
    monkeypatch.setattr(k, "_launcher", None)
    monkeypatch.setattr(_nvcc, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_nvcc, "_LIBS", {})
    monkeypatch.setattr(_nvcc, "_find_nvcc", lambda: "nvcc")
    commands = []

    def run(cmd, **kw):
        commands.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "stub nvcc")
    monkeypatch.setattr(_nvcc, "subprocess",
                        types.SimpleNamespace(run=run))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        k.library()
    (cmd,) = commands
    want = (("-fmad=false",) if name in ("klt_track", "pnp_bank")
            else ())
    assert cmd[1:1 + len(_nvcc.NVCC_FLAGS)] == list(_nvcc.NVCC_FLAGS)
    assert tuple(cmd[1 + len(_nvcc.NVCC_FLAGS):-3]) == want
    assert cmd[-1].endswith(f"csrc/{name}.cu")
    assert k._lib is None and os.listdir(tmp_path) == []
    with open(_nvcc.__file__) as f:
        source = f.read()
    assert not any(n in source for n in KERNELS)


# ---- the RANSAC bank's kernel (kernels/pnp_bank.py) -----------------------

def _bank_args(lead=(), n=7, k=5, dtypes=(F64, F64), mask=True):
    """world, obs, idx, valid_mask of ``pnp_bank_cuda`` (values do not
    matter to the packing)."""
    g = torch.Generator().manual_seed(n + k)
    world = torch.rand(lead + (n, 3), generator=g, dtype=dtypes[0])
    obs = torch.rand(lead + (n, 2), generator=g, dtype=dtypes[1])
    idx = torch.randint(0, n, lead + (k, 3), generator=g)
    valid = torch.rand(lead + (n,), generator=g) > 0.2 if mask else None
    return [world, obs, idx, valid]


@pytest.mark.parametrize("lead,dtypes,mask", [((), (F64, F64), True),
                                              ((16,), (F64, F64), True),
                                              ((3,), (F32, F64), False),
                                              ((), (F32, F32), False)])
def test_pnp_bank_pack_fills_the_kernel_struct(lead, dtypes, mask):
    """Every field of ``PnpBankArgs`` as the kernel reads it: the input
    pointers (no mask: 0), streams, points, samples, the threshold in
    float32 (as PyTorch compares a float32 error with a Python float) and a
    float64 flag for world and obs; output and scratch pointers are the
    wrapper's, after its allocation."""
    args = _bank_args(lead, dtypes=dtypes, mask=mask)
    index, got_lead, b, n, k = pb._pack(*args, 2.5e-6)
    assert (index, tuple(got_lead), b, n, k) == (-1, lead, lead[0] if lead
                                                 else 1, 7, 5)
    (a,), _ = pb._KERNEL.structs()
    world, obs, idx, valid = args
    assert [a.world, a.obs, a.idx] == [x.data_ptr() for x in args[:3]]
    assert a.valid == (valid.data_ptr() if mask else None)
    assert [a.sol, a.tickets, a.R_out, a.t_out, a.err_out, a.count_out,
            a.ok_out, a.inliers_out] == [None] * 8
    assert (a.b, a.n, a.k) == (b, 7, 5)
    assert a.thr == np.float32(2.5e-6)
    assert (a.world_f64, a.obs_f64) == tuple(int(d is F64) for d in dtypes)
    assert ctypes.sizeof(pb._Args) == pb._ARGS_FMT.size
    # the C struct's order: twelve pointers, then b, n, k, thr and flags
    offsets = [getattr(pb._Args, f).offset for f, _ in pb._Args._fields_]
    assert offsets == [8 * i for i in range(12)] + [96, 100, 104, 108, 112,
                                                    116]


def _bad_bank_cases():
    """(what, change to the arguments, the refusal's words)."""
    def at(i, f):
        return lambda a: a.__setitem__(i, f(a[i]))
    return [
        ("world half", at(0, lambda x: x.half()),
         "world must be torch.float32 or torch.float64"),
        ("obs int64", at(1, lambda x: x.long()),
         "obs must be torch.float32 or torch.float64"),
        ("idx int32", at(2, lambda x: x.int()), "idx must be torch.int64"),
        ("mask float", at(3, lambda x: x.float()),
         "valid_mask must be torch.bool"),
        ("idx 2 columns", at(2, lambda x: x[..., :2].contiguous()),
         r"idx must be \(3, 5, 3\)"),
        ("idx of one stream", at(2, lambda x: x[0]), "idx must be"),
        ("obs 3 columns", at(1, lambda x: torch.cat([x, x[..., :1]], -1)),
         r"obs must be \(3, 7, 2\)"),
        ("mask one short", at(3, lambda x: x[:, 1:].contiguous()),
         r"valid_mask must be \(3, 7\)"),
        ("world 2 columns", at(0, lambda x: x[..., :2].contiguous()),
         r"world must be \[N, 3\] or \[B, N, 3\]"),
        ("world 4-D", lambda a: [a.__setitem__(i, a[i][None].expand(
            (2,) + a[i].shape).contiguous()) for i in range(4)],
         r"world must be \[N, 3\] or \[B, N, 3\]"),
        ("world transposed",
         at(0, lambda x: x.transpose(-1, -2).contiguous().transpose(-1, -2)),
         "world must be contiguous"),
        ("idx strided", at(2, lambda x: torch.cat([x, x], -1)[..., ::2]),
         "idx must be contiguous"),
        ("not a tensor", at(1, lambda x: x.numpy()), "obs must be a tensor"),
        ("no samples", at(2, lambda x: x[:, :0]), "at least one"),
        ("no points", lambda a: [a.__setitem__(i, a[i][:, :0])
                                 for i in (0, 1, 3)], "at least one"),
        ("too many streams", lambda a: [a.__setitem__(i, a[i][:1].expand(
            (65536,) + a[i].shape[1:]).contiguous()) for i in range(4)],
         "at most 65535 streams"),
    ]


@pytest.mark.parametrize("what,change,match", _bad_bank_cases(),
                         ids=[c[0] for c in _bad_bank_cases()])
def test_pnp_bank_pack_refuses_what_the_kernel_does_not_take(what, change,
                                                             match):
    args = _bank_args((3,))
    change(args)
    with pytest.raises(ValueError, match=match):
        pb._pack(*args, 1e-5)


@pytest.mark.parametrize("bad", [-1, 7, 100])
def test_pnp_bank_check_indices_refuses_what_lies_outside(bad):
    """``check_indices`` takes indices in [0, N) and refuses one outside,
    naming the range it found."""
    idx = torch.randint(0, 7, (3, 5, 3),
                        generator=torch.Generator().manual_seed(0))
    pb.check_indices(idx, 7)
    idx[1, 2, 0] = bad
    with pytest.raises(ValueError, match=r"outside \[0, 7\) for 7 points"):
        pb.check_indices(idx, 7)


def _bank_problem(lead=(), n=60, seed=0):
    """A PnP problem as the VO hands RANSAC one (float64 world points ahead
    of an identity camera, their projections with 1e-3 noise and a fifth
    of outliers, an eighth of the points masked)."""
    rng = np.random.default_rng(seed)
    world = np.concatenate([rng.uniform(-3, 3, lead + (n, 2)),
                            rng.uniform(4, 8, lead + (n, 1))], -1)
    obs = world[..., :2] / world[..., 2:] + rng.normal(0, 1e-3,
                                                       lead + (n, 2))
    obs = np.where(rng.uniform(size=lead + (n, 1)) < 0.2,
                   rng.uniform(-0.6, 0.6, lead + (n, 2)), obs)
    valid = rng.uniform(size=lead + (n,)) > 0.125
    return (torch.from_numpy(world), torch.from_numpy(obs),
            torch.from_numpy(valid))


def _generators(lead):
    if not lead:
        return torch.Generator().manual_seed(3)
    return [torch.Generator().manual_seed(3 + b) for b in range(lead[0])]


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("p3p", ["grunert", "finsterwalder"])
def test_ransac_pnp_on_cpu_takes_the_plain_route(lead, p3p):
    """CPU tensors (and Finsterwalder anywhere) never reach the kernel: no
    launch, the plain route counted, and the bank is the generic
    ``ransac`` on the same draws, bit for bit."""
    from boofcv_tpu_torch.geo import robust
    world, obs, valid = _bank_problem(lead)
    robust.reset_bank_routes()
    before = pb.launch_count()
    res, _ = robust.ransac_pnp(_generators(lead), world, obs,
                               num_hypotheses=32, inlier_threshold=4e-6,
                               valid_mask=valid, refine_iterations=5,
                               p3p=p3p)
    assert pb.launch_count() == before
    assert robust.bank_routes() == {"kernel": 0, "plain": 1}
    plain = robust._plain_bank(_generators(lead), world, obs, 32, 4e-6,
                               valid, p3p, None)
    for a, b in zip(torch.utils._pytree.tree_leaves(res),
                    torch.utils._pytree.tree_leaves(plain)):
        assert torch.equal(a, b)
    robust.reset_bank_routes()
    assert robust.bank_routes() == {"kernel": 0, "plain": 0}


def _fake_kernel(monkeypatch):
    """``pnp_bank_cuda`` replaced by the plain route on what it is handed
    (after the wrapper's own checks); returns the list of its calls'
    arguments."""
    from boofcv_tpu_torch.geo import robust
    calls = []

    def fake(world, obs, idx, valid, thr):
        pb._pack(world, obs, idx, valid, thr)
        calls.append((world, obs, idx, valid, thr))
        r = robust._plain_bank(None, world, obs, idx.shape[-2], thr, valid,
                               "grunert", idx)
        return r.model, r.inliers, r.num_inliers, r.best_error
    monkeypatch.setattr(pb, "pnp_bank_cuda", fake)
    return calls


@pytest.mark.parametrize("lead", [(), (3,)])
def test_kernel_bank_draws_as_the_plain_route(lead, monkeypatch):
    """What ``ransac_pnp``'s card route hands the kernel, shown on the CPU
    with the kernel stood in for by the plain route: the same index sets
    as the plain route draws from the same generators (so the same result,
    bit for bit), inputs as they came, one call."""
    from boofcv_tpu_torch.geo import robust
    calls = _fake_kernel(monkeypatch)
    world, obs, valid = _bank_problem(lead)
    got = robust._kernel_bank(_generators(lead), world, obs, 32, 4e-6,
                              valid, None)
    want = robust._plain_bank(_generators(lead), world, obs, 32, 4e-6,
                              valid, "grunert", None)
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)
    (w, o, idx, v, thr), = calls
    assert w is world and o is obs and v is valid and thr == 4e-6
    assert idx.shape == lead + (32, 3) and idx.dtype == torch.int64


def test_kernel_bank_reads_inputs_as_the_plain_route(monkeypatch):
    """The card route reads what the plain route reads: world and obs in a
    real dtype other than float32 and float64 as float32, a mask of one
    stream beside B streams broadcast, a caller's index sets in any integer
    dtype; a caller's index outside [0, N), or a bank of another size than
    ``num_hypotheses``, is refused before the kernel."""
    from boofcv_tpu_torch.geo import robust
    calls = _fake_kernel(monkeypatch)
    world, obs, valid = _bank_problem((3,))
    idx = torch.randint(0, 60, (3, 16, 3), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1))
    robust._kernel_bank(None, world.half(), obs, 16, 4e-6, valid[0], idx)
    (w, o, i, v, _), = calls
    assert w.dtype == torch.float32 and o is obs
    assert torch.equal(w, world.half().float())
    assert v.shape == (3, 60) and v.is_contiguous()
    assert torch.equal(v, valid[0].expand(3, 60))
    assert i.dtype == torch.int64 and torch.equal(i, idx.long())
    for bad, words in ((idx.clone().fill_(60), r"outside \[0, 60\)"),
                       (idx[:, :8], r"must be \[\.\.\., 16, 3\]")):
        with pytest.raises(ValueError, match=words):
            robust._kernel_bank(None, world, obs, 16, 4e-6, valid, bad)
    assert len(calls) == 1


_BROKEN_BANKS = {
    "transposed R": lambda R, t, ok, inl, c, e: (
        (R.transpose(-1, -2), t, ok), inl, c, e),
    "shifted t": lambda R, t, ok, inl, c, e: ((R, t + 1e-3, ok), inl, c, e),
    "count": lambda R, t, ok, inl, c, e: ((R, t, ok), inl, c + 1, e),
    "mask": lambda R, t, ok, inl, c, e: ((R, t, ok), ~inl, c, e),
    "msac": lambda R, t, ok, inl, c, e: ((R, t, ok), inl, c, e * 1.001),
}


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("broken", sorted(_BROKEN_BANKS))
def test_bank_verdict_catches_a_broken_bank(lead, broken):
    """``chip_smoke.bank_verdict``, the check of ``pnp_bank`` against its
    plain route on the card, shown on the CPU with the plain route in the
    kernel's place: the plain route passes against itself (each stream its
    own winner, R and t exact), and a result with a transposed R, a
    shifted t, another count, another mask or another MSAC fails."""
    import chip_smoke as cs
    from boofcv_tpu_torch.geo import robust
    world, obs, valid, idx = cs._bank_scene("cpu", lead, n=100, k=40,
                                            seed=2)
    r = robust._plain_bank(None, world, obs, 40, cs.BANK_THR, valid,
                           "grunert", idx)
    (R, t, ok), inl, c, e = r.model, r.inliers, r.num_inliers, r.best_error
    v = cs.bank_verdict(((R, t, ok), inl, c, e), world, obs, idx, valid)
    streams = int(np.prod(lead))
    assert v == {"streams": streams, "same_winner": streams,
                 "near_ties": 0, "pose_err": 0.0, "mask_differ": 0}
    with pytest.raises(cs.SmokeFailure, match="stream 0"):
        cs.bank_verdict(_BROKEN_BANKS[broken](R, t, ok, inl, c, e), world,
                        obs, idx, valid)
