"""Control: the image path in bfloat16, the precision below the float32
that the configuration states for it.  The pyramid's levels, their Sobel
gradients (whence the KLT templates) and the sparse SAD cost table are
rounded to bfloat16 where the program makes them; everything else runs
as it is."""

import torch


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def apply(port):
    from boofcv_tpu_torch.feature import disparity
    from boofcv_tpu_torch.ip import pyramid_ops
    orig = (pyramid_ops.pyramid_average, pyramid_ops.gradient,
            disparity._sparse_costs_sad)

    def pyramid_average(*a, **k):
        return tuple(_bf16(level) for level in orig[0](*a, **k))

    def gradient(*a, **k):
        return tuple(tuple(_bf16(g) for g in gs) for gs in orig[1](*a, **k))

    def costs(*a, **k):
        return _bf16(orig[2](*a, **k))

    (pyramid_ops.pyramid_average, pyramid_ops.gradient,
     disparity._sparse_costs_sad) = pyramid_average, gradient, costs

    def undo():
        (pyramid_ops.pyramid_average, pyramid_ops.gradient,
         disparity._sparse_costs_sad) = orig
    return undo
