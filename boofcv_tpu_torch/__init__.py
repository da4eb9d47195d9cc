"""boofcv_tpu_torch — the PyTorch / CUDA port of boofcv_tpu for NVIDIA Hopper.

Mirrors the JAX package's tree: ``boofcv_tpu_torch/feature/klt.py`` is the
counterpart of ``boofcv_tpu/feature/klt.py`` and so on.  Plain functions on
tensors; every op allocates on its input's device.  The window gather, the
one kernel the reference wrote for the TPU, is a hand-written CUDA kernel
(``kernels/csrc/window_gather.cu``) launched for CUDA tensors; CPU tensors
take its plain PyTorch version.  The package imports torch and numpy and
never jax.
"""

from boofcv_tpu_torch import _config  # noqa: F401  (precision policy)
