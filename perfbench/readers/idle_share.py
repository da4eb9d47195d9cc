"""Share, in %, of the profiled replay in which no device operation ran:
one less the union of the kernel, copy and set intervals over the
window."""

from harness import trace


def read(ctx):
    if ctx.profile is None:
        return None
    window = trace.window_s(ctx.profile)
    return 100.0 * (1.0 - trace.busy(ctx.profile) / window)
