"""The two kernel wrappers' argument checks and packing, on the CPU.

``klt_track._pack`` and ``window_gather._gather_geometry`` are what the
wrappers run before a launch: one pass of cheap checks that fills the C
structs (or the launch arguments), and on anything refused the detailed
checks that name it.  They take tensors on any device (the kernels
themselves only run on the card, see test_torch_cuda.py), so what the
kernel is handed, and every refusal's message, is checked here."""

import ctypes

import numpy as np
import pytest
import torch

from boofcv_tpu_torch.kernels import klt_track as kt
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
    (lv, prm, _), _ = kt._launch_structs()
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
    assert kt._launch_structs()[0][1].radius == radius
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


def test_wrappers_refuse_cpu_tensors_before_any_check():
    """A CPU tensor never reaches the packing or the library."""
    args = _klt_args()
    before = kt.launch_count(), wg.launch_count()
    with pytest.raises(ValueError, match="CUDA"):
        kt.klt_track_cuda(*args)
    o = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        wg.gather_windows_cuda(torch.zeros(8, 8), o, o, 3, 3)
    assert (kt.launch_count(), wg.launch_count()) == before


def test_each_thread_packs_its_own_structs():
    """Launches from several threads never see each other's arguments:
    each thread packs into its own structs (checked under a short switch
    interval, more threads than cores)."""
    import sys
    import threading
    errors = []

    def worker(n):
        args = _klt_args(n=n)
        try:
            for _ in range(200):
                kt._pack(*args)
                (lv, prm, _), _ = kt._launch_structs()
                if prm.n != n or lv.desc[0] != args[1][0].data_ptr():
                    errors.append(n)
                geometry = wg._gather_geometry(args[0][0], args[4].int(),
                                               args[5].int(), 7, n)[1:]
                if geometry != ((0, 60, 80, n), (n, 7, n)):
                    errors.append(-n)
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
