"""Frames completed in the window, summed over the streams, over the
window's seconds (host clock)."""


def read(ctx):
    return ctx.frames / ctx.window_s if ctx.window_s > 0 else None
