"""A kernel's share, in %, of its roofline over the profiled replay: the
least time the card could take for the work of each call of ``span``
(the larger of its bytes over the HBM peak and its operations over the
float32 peak, counted by ``rooflines/<counts>.py`` from the call's
inputs), summed, over the device time of every kernel launched inside
those calls.  Nothing to read (no call, or no device time) gives
nothing."""

import json
import os

from harness import trace


def read(ctx, span: str, counts: str):
    if ctx.profile is None or span in ctx.missing:
        return None
    calls = ctx.captures.get(span, [])
    device = trace.span_device_s(ctx.profile, span)
    if not calls or len(calls) != len(device):
        return None
    counter = ctx.bench.module("rooflines", counts)
    with open(os.path.join(ctx.bench.dir, "rooflines",
                           "peaks.h100.json")) as f:
        peak = json.load(f)
    bound = dev = 0.0
    for rec, d in zip(calls, device):
        if d <= 0:
            continue
        nbytes, flops = counter.count(rec)
        bound += max(nbytes / peak["hbm_bytes_per_s"],
                     flops / peak["fp32_flops_per_s"])
        dev += d
    return 100.0 * bound / dev if dev > 0 else None
