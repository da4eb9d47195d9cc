"""Fault: the KLT faults every track, so no track is carried, RANSAC has
nothing to fit and every pose after a bootstrap comes back unusable.
Listed under ``faults`` in a test cell's settings, and read on the card
by ``control.py --fault klt_lost``; never in a benchmark cell."""

import torch


def apply(port):
    klt = port.klt
    orig = klt.track_pyramid

    def broken(*a, **k):
        ys, xs, fault = orig(*a, **k)
        return ys, xs, torch.full_like(fault, klt.FAULT_FAILED)

    klt.track_pyramid = broken

    def undo():
        klt.track_pyramid = orig
    return undo
