"""Seconds from the process's start to the window's: imports, CUDA
initialisation, the kernels' libraries, rendering the scene, the warm
replay."""


def read(ctx):
    return ctx.setup_s
