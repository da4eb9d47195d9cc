"""The port's feature examples against the JAX package's on the CPU
(helpers and conventions: ``tests/test_torch_examples_motion.py``).

Held to the truth only (their bars in ``main``), not to the JAX run's
printed numbers: ``associate_points``, ``dense_optical_flow`` and
``feature_surf``, whose JAX runs take over 10 s.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_examples_motion import (  # noqa: E402
    assert_bit_equal, assert_runs, assert_same_numbers, capture_ref,
    run_ref)

torch.set_num_threads(1)

PARITY = ["background_removal", "corner_features", "dense_image_features",
          "fit_shapes", "line_detection", "segment_mean_shift"]
TRUTH = ["associate_points", "dense_optical_flow", "feature_surf"]


@pytest.mark.parametrize("name", TRUTH)
def test_feature_example_runs(name):
    assert_runs(name)


@pytest.mark.parametrize("name", PARITY)
def test_feature_example_prints_what_jax_prints(name):
    out = assert_runs(name)
    rc, ref = run_ref(name)
    assert rc == 0
    assert_same_numbers(ref, out)


def test_associate_views_match_jax(monkeypatch):
    from boofcv_tpu.ip import integral
    from boofcv_tpu_torch.examples import associate_points as port
    seen = capture_ref(monkeypatch, "associate_points", integral,
                       "transform", stop_after=2, through=True)
    assert_bit_equal([s[0] for s in seen], port._scene())


def test_flow_pair_matches_jax(monkeypatch):
    from boofcv_tpu.feature import flow
    from boofcv_tpu_torch.examples import dense_optical_flow as port
    (seen,) = capture_ref(monkeypatch, "dense_optical_flow", flow,
                          "horn_schunck_pyramid")
    assert_bit_equal(seen[:2], port._scene())


def test_background_frames_match_jax(monkeypatch):
    """The background the JAX example learns from, and its ``_frame``
    at every step of the object's path."""
    from boofcv_tpu.examples import background_removal as ref
    from boofcv_tpu.feature import background
    from boofcv_tpu_torch.examples import background_removal as port
    (seen,) = capture_ref(monkeypatch, "background_removal", background,
                          "basic_init")
    base = port._scene()
    assert_bit_equal([seen[0]], [base])
    for cy, cx in port.PATH:
        assert np.array_equal(ref._frame(np.asarray(seen[0]), cy, cx),
                              port._frame(base, cy, cx))
