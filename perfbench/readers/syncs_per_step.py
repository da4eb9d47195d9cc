"""Synchronizing CUDA operations in the measured window (PyTorch's sync
debug warnings) over its steps."""


def read(ctx):
    return ctx.syncs / ctx.steps if ctx.steps else None
