"""The port's image-processing examples against the JAX package's on the
CPU (helpers and conventions: ``tests/test_torch_examples_motion.py``).
None of them draws random numbers at run time and each JAX run takes under
10 s, so each prints the JAX example's lines but ``convolution``, which is
held to the truth only: the separable-against-2-D error it prints is
float32 rounding (4.6e-5 in JAX, 7.6e-5 here; the bar is 1e-3).  None takes
its scene from ``io.simulate`` or a local ``_frame``.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_examples_motion import (  # noqa: E402
    assert_runs, assert_same_numbers, run_ref)

torch.set_num_threads(1)

PARITY = ["binary_ops", "canny_edge", "color_histogram_lookup",
          "color_space", "fourier_transform", "image_filtering",
          "image_pyramids", "interpolation_zoo", "morphological_thinning",
          "planar_images", "point_deform_mls", "thresholding_techniques"]


def test_convolution_example_runs():
    assert_runs("convolution")


@pytest.mark.parametrize("name", PARITY)
def test_ip_example_prints_what_jax_prints(name):
    out = assert_runs(name)
    rc, ref = run_ref(name)
    assert rc == 0
    assert_same_numbers(ref, out)
