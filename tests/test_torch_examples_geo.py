"""The port's geometry, stereo and calibration examples against the JAX
package's on the CPU (helpers and conventions:
``tests/test_torch_examples_motion.py``).

Held to the truth only (their bars in ``main``), not to the JAX run's
printed numbers: ``fundamental_matrix``, ``pnp`` and ``stereo_uncalibrated``
(RANSAC: a ``torch.Generator`` where the JAX examples use
``jax.random.PRNGKey(0)``), and ``fisheye_calibration``,
``rectify_calibrated_stereo``, ``stereo_disparity`` and
``stereo_disparity_3d``, whose JAX runs take over 10 s.  ``overhead_view``
renders one view and tracks nothing, so it sits here and not with the
kernel paths.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_examples_motion import (  # noqa: E402
    assert_bit_equal, assert_runs, assert_same_numbers, capture_ref,
    run_ref)

torch.set_num_threads(1)

PARITY = ["depth_point_cloud", "overhead_view", "remove_lens_distortion",
          "remove_perspective", "stereo_calibration"]
TRUTH = ["fisheye_calibration", "fundamental_matrix", "pnp",
         "rectify_calibrated_stereo", "stereo_disparity",
         "stereo_disparity_3d", "stereo_uncalibrated"]


@pytest.mark.parametrize("name", TRUTH)
def test_geo_example_runs(name):
    assert_runs(name)


@pytest.mark.parametrize("name", PARITY)
def test_geo_example_prints_what_jax_prints(name):
    out = assert_runs(name)
    rc, ref = run_ref(name)
    assert rc == 0
    assert_same_numbers(ref, out)


def _port_scene(name):
    import importlib
    return importlib.import_module(
        f"boofcv_tpu_torch.examples.{name}")._scene()


@pytest.mark.parametrize("name", ["stereo_disparity", "stereo_disparity_3d"])
def test_stereo_pair_matches_jax(monkeypatch, name):
    from boofcv_tpu.io import simulate
    (frames,) = capture_ref(monkeypatch, name, simulate,
                            "render_stereo_sequence", result=True)
    assert_bit_equal(frames[0], _port_scene(name))


def test_verged_pair_matches_jax(monkeypatch):
    """The two views the JAX example rectifies."""
    from boofcv_tpu.ip import distort
    seen = capture_ref(monkeypatch, "rectify_calibrated_stereo", distort,
                       "warp_homography", stop_after=2)
    assert_bit_equal([s[0] for s in seen],
                     _port_scene("rectify_calibrated_stereo")[1:])


@pytest.mark.parametrize("name", ["remove_lens_distortion",
                                  "remove_perspective"])
def test_warped_texture_matches_jax(monkeypatch, name):
    """The ideal image / document the JAX example first warps."""
    from boofcv_tpu.ip import distort
    (seen,) = capture_ref(monkeypatch, name, distort, "warp")
    assert_bit_equal([seen[0]], [_port_scene(name)])


def test_uncalibrated_views_match_jax(monkeypatch):
    """The two views whose integral images the JAX example takes."""
    from boofcv_tpu.ip import integral
    seen = capture_ref(monkeypatch, "stereo_uncalibrated", integral,
                       "transform", stop_after=2, through=True)
    assert_bit_equal([s[0] for s in seen],
                     _port_scene("stereo_uncalibrated"))
