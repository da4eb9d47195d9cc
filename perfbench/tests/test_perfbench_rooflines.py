"""The roofline counts against hand counts at a small shape."""

import types

import torch

from harness import spec

from conftest import ROOT


def _counts(name):
    return spec.Benchmark(ROOT).module("rooflines", name)


def test_klt_count_by_hand():
    klt = _counts("klt")
    p = 7
    pyramid = [torch.zeros(64, 80), torch.zeros(32, 40)]
    tm = types.SimpleNamespace(desc=[torch.zeros(2, p, p)] * 2)
    # two tracks far apart: each support is 8 x 8 on both levels
    ys = torch.tensor([20.0, 40.0])
    xs = torch.tensor([20.0, 60.0])
    rec = klt.capture((pyramid, tm, ys, xs, [1, 2], None), {})
    nbytes, flops = klt.count(rec)
    pixels = 2 * 64 + 2 * 64
    assert nbytes == (4 * pixels + 2 * 2 * 3 * 49 * 4 + 2 * 8 + 2 * 12)
    assert flops == 2 * 2 * (49 * 14 + 10)


def test_klt_count_takes_each_pixel_once():
    klt = _counts("klt")
    pyramid = [torch.zeros(64, 80)]
    tm = types.SimpleNamespace(desc=[torch.zeros(2, 7, 7)])
    same = torch.tensor([30.0, 30.0])
    rec = klt.capture((pyramid, tm, same, same, [1], None), {})
    nbytes, _ = klt.count(rec)
    assert nbytes == 4 * 64 + 2 * 3 * 49 * 4 + 2 * 8 + 2 * 12


def test_sad_gather_count_by_hand():
    sad = _counts("sad_gather")
    cfg = types.SimpleNamespace(min_disparity=0, max_disparity=10,
                                radius_x=1, radius_y=1)
    img = torch.zeros(30, 40)
    ys = torch.tensor([10], dtype=torch.int32)
    xs = torch.tensor([20], dtype=torch.int32)
    rec = sad.capture((img, img, ys, xs, cfg), {})
    nbytes, flops = sad.count(rec)
    left = 3 * 3
    right = 3 * (10 + 2)       # columns 20 - 1 - 9 .. 20 + 1
    assert nbytes == 4 * (left + right) + 8 + 5
    assert flops == 10 * 9 * 3


def test_sad_gather_strip_is_clipped_to_the_image():
    sad = _counts("sad_gather")
    cfg = types.SimpleNamespace(min_disparity=0, max_disparity=10,
                                radius_x=1, radius_y=1)
    img = torch.zeros(30, 40)
    rec = sad.capture((img, img, torch.tensor([10], dtype=torch.int32),
                       torch.tensor([3], dtype=torch.int32), cfg), {})
    nbytes, _ = sad.count(rec)
    assert nbytes == 4 * (9 + 3 * 5) + 8 + 5
