"""The port's motion examples (group 1 of the examples: the ones whose path
reaches the hand kernels) and the two recognition examples, against the
JAX package's on the CPU.

Each example runs once with ``--device cpu`` and must return 0 with ``OK``
last.  Where the JAX example's scene comes from ``io.simulate`` or a local
``_frame``, the arrays it feeds the library (caught where the library
takes them; the JAX run stops there) equal the port's ``_scene()`` bit for
bit.  Examples that draw no random numbers print the same labelled lines
as the JAX example run in the same test, each number within 2 in its last
printed digit or 1e-3 relative (``assert_same_numbers``).

Held to the truth only (their bars in ``main``), not to the JAX run's
printed numbers: every example here that reaches RANSAC (the VO front ends
and the stitcher draw hypotheses from a ``torch.Generator``, the JAX ones
from ``jax.random``): ``visual_odometry_stereo``, ``visual_odometry_depth``,
``visual_odometry_mono_plane``, ``video_stabilization``, ``video_mosaic``,
``image_stitching``; and ``point_feature_tracker``, whose JAX run takes
over 10 s.  The helpers here are shared by the other
``test_torch_examples_*`` files.
"""

import contextlib
import importlib
import io
import re
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


class _Stop(Exception):
    """Raised by a capture to end the JAX example where its scene enters
    the library."""


def run_port(name):
    """(return code, stdout) of the port's example ``name`` on the CPU."""
    mod = importlib.import_module(f"boofcv_tpu_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(["--device", "cpu"])
    return rc, buf.getvalue()


def run_ref(name):
    """(return code, stdout) of the JAX example ``name`` (on the CPU: the
    test process runs JAX there)."""
    mod = importlib.import_module(f"boofcv_tpu.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main([])
    return rc, buf.getvalue()


def _last_digit(token: str) -> float:
    """The value of one unit in the last printed digit of ``token``."""
    m = re.match(r"[-+]?\d*\.?(\d*)(?:[eE]([-+]?\d+))?$", token)
    return 10.0 ** (int(m.group(2) or 0) - len(m.group(1)))


def assert_same_numbers(ref: str, port: str):
    """The port's stdout (less its ``device:`` line) has the JAX example's
    lines, the same words around the numbers, each number within 2 in its
    last printed digit or 1e-3 relative, whichever is looser."""
    ref_lines = ref.strip().splitlines()
    port_lines = [line for line in port.strip().splitlines()
                  if not line.startswith("device:")]
    assert len(port_lines) == len(ref_lines), (ref, port)
    for a, b in zip(ref_lines, port_lines):
        assert NUMBER.sub("#", a) == NUMBER.sub("#", b), (a, b)
        for x, y in zip(NUMBER.findall(a), NUMBER.findall(b)):
            tol = max(2 * _last_digit(x), 1e-3 * abs(float(x)))
            assert abs(float(x) - float(y)) <= tol, (a, b)


def assert_runs(name):
    """The port's example returns 0, says which device, and ends OK;
    returns its stdout."""
    rc, out = run_port(name)
    assert rc == 0, out
    lines = out.strip().splitlines()
    assert "device: cpu" in lines and lines[-1] == "OK", out
    return out


def capture_ref(monkeypatch, name, owner, attr, stop_after=1,
                returns=None, result=False, through=False, extra=()):
    """Run the JAX example ``name`` with ``owner.attr`` replaced by a
    recorder; returns what it saw, one entry a call: the call's positional
    arguments (a bound method's without ``self``), or with ``result`` what
    the real call returned.  The run ends (``_Stop``) at the
    ``stop_after``-th call; until then (with ``stop_after=None``: to the
    end) each call is answered with ``returns``, or with ``through`` by the
    real call.  ``extra``: more (owner, attr, value) patches for the
    run."""
    seen = []
    real = getattr(owner, attr)
    is_method = isinstance(owner, type)

    def recorder(*args, **kwargs):
        if result:
            seen.append(real(*args, **kwargs))
        else:
            seen.append(args[1:] if is_method else args)
        if stop_after is not None and len(seen) >= stop_after:
            raise _Stop
        return real(*args, **kwargs) if through else returns

    monkeypatch.setattr(owner, attr, recorder)
    for o, a, v in extra:
        monkeypatch.setattr(o, a, v)
    try:
        run_ref(name)
    except _Stop:
        pass
    return seen


def assert_bit_equal(ref_arrays, port_arrays):
    assert len(ref_arrays) == len(port_arrays)
    for a, b in zip(ref_arrays, port_arrays):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def _flat(frames):
    return [a for f in frames for a in (f if isinstance(f, tuple) else (f,))]


# --- group 1: the kernel paths -------------------------------------------

MOTION = ["visual_odometry_stereo", "visual_odometry_depth",
          "visual_odometry_mono_plane", "point_feature_tracker",
          "video_stabilization", "video_mosaic", "image_stitching"]


@pytest.mark.parametrize("name", MOTION)
def test_motion_example_runs(name):
    assert_runs(name)


def _pose_dummy():
    return lambda self: (np.eye(3), np.zeros(3))


def test_stereo_vo_scene_matches_jax(monkeypatch):
    from boofcv_tpu.io import simulate
    from boofcv_tpu_torch.examples import visual_odometry_stereo as port
    (frames,) = capture_ref(monkeypatch, "visual_odometry_stereo", simulate,
                            "render_stereo_sequence", result=True)
    assert_bit_equal(_flat(frames), _flat(port._scene()[1]))


@pytest.mark.parametrize("name,owner", [
    ("visual_odometry_depth", "depth_vo.DepthVisualOdometry"),
    ("visual_odometry_mono_plane", "mono_plane_vo.MonoPlaneVisualOdometry")])
def test_vo_scene_matches_jax(monkeypatch, name, owner):
    """Every frame the JAX front end is given (gray, and depth where it
    takes one), each answered with an accepted identity pose."""
    mod, cls = owner.split(".")
    vo = getattr(importlib.import_module(f"boofcv_tpu.sfm.{mod}"), cls)
    seen = capture_ref(monkeypatch, name, vo, "process", stop_after=None,
                       returns=True,
                       extra=[(vo, "camera_to_world", _pose_dummy())])
    port = importlib.import_module(f"boofcv_tpu_torch.examples.{name}")
    frames = port._scene()[1]
    assert_bit_equal([a for s in seen for a in s],
                     _flat([f if isinstance(f, tuple) else (f,)
                            for f in frames]))


@pytest.mark.parametrize("name", ["video_stabilization", "video_mosaic",
                                  "image_stitching"])
def test_stitcher_scene_matches_jax(monkeypatch, name):
    """Every frame the JAX stitcher is given."""
    from boofcv_tpu.sfm import stitch2d
    seen = capture_ref(monkeypatch, name, stitch2d.Stitcher, "process",
                       stop_after=None, returns=True)
    port = importlib.import_module(f"boofcv_tpu_torch.examples.{name}")
    frames = port._scene()
    frames = frames[1] if isinstance(frames, tuple) else frames
    assert_bit_equal([np.asarray(s[0]) for s in seen], frames)


def test_point_tracker_scene_matches_jax(monkeypatch):
    """Every frame the JAX KLT tracker is given (it answers with one
    motionless track)."""
    from boofcv_tpu.feature import point_tracker
    from boofcv_tpu_torch.examples import point_feature_tracker as port
    cls = point_tracker.PointTrackerKlt
    track = types.SimpleNamespace(uid=0, y=0.0, x=0.0)
    seen = capture_ref(monkeypatch, "point_feature_tracker", cls, "process",
                       stop_after=None,
                       extra=[(cls, "spawn", lambda self: None),
                              (cls, "active_tracks", lambda self: [track])])
    assert_bit_equal([np.asarray(s[0]) for s in seen], port._scene())


# --- group 6: recognition ------------------------------------------------

@pytest.mark.parametrize("name", ["detect_qr_code", "fiducial_pose"])
def test_recognition_example_prints_what_jax_prints(name):
    out = assert_runs(name)
    rc, ref = run_ref(name)
    assert rc == 0
    assert_same_numbers(ref, out)
