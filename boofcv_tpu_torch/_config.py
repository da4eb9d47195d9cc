"""Precision policy of the port (counterpart of ``boofcv_tpu/_config.py``).

The reference runs images, pyramids and KLT in float32; world points, the
pose, ``pixel_to_3d_rectified`` and the returned pose in float64; the P3P
hypothesis bank, its K x N scoring and the Gauss-Newton refine loop in
float32, followed by a float64 Newton-polar re-orthogonalisation.  The port
keeps those dtypes function by function (``IMAGE_DTYPE`` / ``GEO_DTYPE``).

Nothing on the path may run in TF32: PyTorch lets cuDNN convolutions use it
by default on Hopper.  Importing the package turns both TF32 switches off
for the process, as importing the reference turns float64 on for JAX.  The
path also avoids ``conv2d`` altogether (shifted adds and pooling instead).
"""

from __future__ import annotations

import torch

IMAGE_DTYPE = torch.float32
GEO_DTYPE = torch.float64

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
