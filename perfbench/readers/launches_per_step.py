"""Device kernels in the profiled replay over its steps (the profiler's
head-loss pads left out)."""


def read(ctx):
    if ctx.profile is None or not ctx.profiled_steps:
        return None
    return len(ctx.profile["kernels"]) / ctx.profiled_steps
