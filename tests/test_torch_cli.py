"""The port's commands (``boofcv_tpu_torch/cli``) against the JAX package's
on the same inputs, each with ``--device cpu``: the eight tests of
``tests/test_cli.py`` (on the data ``chip_smoke.py``'s ``cli:`` phase
builds the same way), ``stereo_vo_demo`` with a calibration and
``create_calibration_target``, each holding the port's output files
against the reference command's.  Last,
every ported example and command asks for the card when no ``--device`` is
given, and raises without one."""

import importlib
import os
import pkgutil

import numpy as np
import pytest
import torch

import boofcv_tpu_torch.cli
import boofcv_tpu_torch.examples
import chip_smoke as cs

CPU = ["--device", "cpu"]


def _both(name, argv, capsys):
    """(reference stdout, port stdout) of ``cli.<name>.main`` on the same
    argv (the port's with ``--device cpu``); both must return 0."""
    ref = importlib.import_module(f"boofcv_tpu.cli.{name}")
    port = importlib.import_module(f"boofcv_tpu_torch.cli.{name}")
    assert ref.main(list(argv)) == 0
    ref_out = capsys.readouterr().out
    assert port.main(list(argv) + CPU) == 0
    return ref_out, capsys.readouterr().out


def test_batch_scan_qr_cli(tmp_path, capsys):
    """The same decoded texts, versions and levels, line for line."""
    cs.qr_scan_dir(str(tmp_path))
    ref, out = _both("batch_scan_qr", ["--images", str(tmp_path)], capsys)
    assert "alpha" in out and "beta" in out
    assert "decoded 2/3" in out
    assert out == ref


def test_camera_calibration_cli(tmp_path, capsys):
    """The intrinsics within 1e-4 relative of the reference command's, and
    both near the true camera (``tests/test_cli.py``'s bars)."""
    from boofcv_tpu_torch.io import calibration_io as cio
    from boofcv_tpu_torch.cli import camera_calibration
    from boofcv_tpu.cli import camera_calibration as ref_cmd
    rows, cols, sq = cs.CLI_BOARD
    d = str(tmp_path / "imgs")
    cs.board_views_dir(d)
    args = ["--images", d, "--rows", str(rows), "--cols", str(cols),
            "--square", str(sq)]
    ref_yaml, out_yaml = str(tmp_path / "ref.yaml"), str(tmp_path / "c.yaml")
    assert ref_cmd.main(args + ["--output", ref_yaml]) == 0
    assert camera_calibration.main(args + ["--output", out_yaml] + CPU) == 0, \
        capsys.readouterr().err
    cam, ref = cio.load_pinhole_brown(out_yaml), cio.load_pinhole_brown(
        ref_yaml)
    assert abs(cam.fx - 300.0) / 300.0 < 0.05, cam.fx
    assert abs(cam.cx - 160.0) < 10
    assert (cam.width, cam.height) == (ref.width, ref.height)
    for f in ("fx", "fy", "cx", "cy"):
        a, b = getattr(cam, f), getattr(ref, f)
        assert abs(a - b) <= 1e-4 * abs(b), (f, a, b)
    assert abs(cam.skew - ref.skew) <= 1e-4 * abs(ref.fx)


def _stereo_dirs(tmp_path):
    """``tests/test_cli.py``'s four-frame forward creep as PNG pairs."""
    from boofcv_tpu_torch.io import simulate
    H, W = 120, 160
    K = np.array([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1.0]])
    poses = [(np.eye(3), -np.array([0.0, 0.0, 0.05 * i])) for i in range(4)]
    frames = simulate.render_stereo_sequence(np.random.default_rng(0), K,
                                             0.3, poses, H, W)
    return (K,) + cs.write_stereo_dirs(str(tmp_path), frames)


@pytest.mark.parametrize("calib", [False, True], ids=["rectified", "calib"])
def test_stereo_vo_demo_cli(tmp_path, capsys, calib):
    """Rectified input (``--fx``/``--baseline``) and a stereo YAML of the
    same rig: the trajectory [4, 12] ends about 0.15 ahead, and every
    camera centre is within 0.05 of the reference command's (the bound of
    ``tests/test_torch_stereo_vo.py``: the two RANSAC streams differ)."""
    from boofcv_tpu_torch.io import calibration_io as cio
    from boofcv_tpu.io import calibration_io as ref_cio
    K, ld, rd = _stereo_dirs(tmp_path)
    args = ["--left", ld, "--right", rd]
    if calib:
        cam = cio.CameraPinholeBrown(160, 120, 150.0, 150.0, 0.0, 80.0, 60.0)
        path = str(tmp_path / "stereo.yaml")
        cio.save_stereo(cio.StereoParameters(cam, cam, np.eye(3),
                                             np.array([0.3, 0.0, 0.0])), path)
        assert ref_cio.load_stereo(path).left.fx == 150.0
        args += ["--calib", path]
    else:
        args += ["--fx", "150", "--baseline", "0.3"]
    from boofcv_tpu_torch.cli import stereo_vo_demo
    from boofcv_tpu.cli import stereo_vo_demo as ref_cmd
    ref_txt, out_txt = str(tmp_path / "ref.txt"), str(tmp_path / "traj.txt")
    assert ref_cmd.main(args + ["--output", ref_txt]) == 0
    ref_out = capsys.readouterr().out
    assert stereo_vo_demo.main(args + ["--output", out_txt] + CPU) == 0
    out = capsys.readouterr().out
    traj, ref = np.loadtxt(out_txt), np.loadtxt(ref_txt)
    assert traj.shape == ref.shape == (4, 12)
    assert abs(traj[-1, 11] - 0.15) < 0.05, traj[-1]
    assert np.linalg.norm(traj[:, 9:] - ref[:, 9:], axis=1).max() < 0.05
    assert out.count("ok=True") == ref_out.count("ok=True") == 4


def test_create_fiducial_cli_roundtrip(tmp_path):
    """Markers bit-equal to the reference command's, each detected with
    its id by the port."""
    from boofcv_tpu_torch.cli import create_fiducial as cf
    from boofcv_tpu_torch.io import image_io
    from boofcv_tpu_torch.recognition import fiducial_square as fs
    from boofcv_tpu.cli import create_fiducial as ref_cf
    args = ["--ids", "7", "123", "--size", "192"]
    assert cf.main(args + ["--output-dir", str(tmp_path)] + CPU) == 0
    assert ref_cf.main(args + ["--output-dir", str(tmp_path / "ref")]) == 0
    for mid in (7, 123):
        name = f"fiducial_{mid:04d}.png"
        img = image_io.load(str(tmp_path / name))
        assert np.array_equal(img, image_io.load(str(tmp_path / "ref" /
                                                     name)))
        assert (tmp_path / name).read_bytes() == (tmp_path / "ref" /
                                                  name).read_bytes()
        dets = fs.detect(img.astype(np.float32), device="cpu")
        assert len(dets) == 1 and dets[0]["id"] == mid


def test_batch_remove_distortion_cli(tmp_path, capsys):
    """The undistorted PNG within one grey level of the reference
    command's, and near the ideal image (``tests/test_cli.py``'s bar)."""
    from boofcv_tpu_torch.cli import batch_remove_distortion
    from boofcv_tpu_torch.io import image_io
    ideal = cs.distorted_capture_dir(str(tmp_path))
    args = ["--calib", str(tmp_path / "calib.yaml"), "--input",
            str(tmp_path / "in"), "--output"]
    ref, out = _both("batch_remove_distortion", args + [
        str(tmp_path / "out")], capsys)
    assert "undistorted 1/1" in out and out == ref
    assert batch_remove_distortion.main(args + [str(tmp_path / "mine")]
                                        + CPU) == 0
    got = image_io.load(str(tmp_path / "mine" / "a.png")).astype(int)
    want = image_io.load(str(tmp_path / "out" / "a.png")).astype(int)
    assert np.abs(got - want).max() <= 1
    c = np.s_[20:-20, 20:-20]
    assert np.median(np.abs(got[c] - ideal[c])) < 8.0


def test_fiducial_detection_cli(tmp_path, capsys):
    """The same ids, centres, turns and ranges, line for line, and the
    poses of both packages within 1e-6 from the detected corners."""
    from boofcv_tpu_torch.io import image_io, calibration_io as cio
    from boofcv_tpu_torch.recognition import fiducial_square as fid
    from boofcv_tpu.recognition import fiducial_square as ref_fid
    cs.fiducial_dir(str(tmp_path))
    calib = str(tmp_path / "calib.yaml")
    ref, out = _both("fiducial_detection", [
        "--images", str(tmp_path / "imgs"), "--calib", calib, "--size",
        "0.1"], capsys)
    assert "id=321" in out and "range=" in out
    assert "found 1 fiducials" in out
    assert out == ref
    gray = image_io.to_gray(image_io.load(str(tmp_path / "imgs" / "m.png")))
    (det,), (rdet,) = fid.detect(gray, device="cpu"), ref_fid.detect(gray)
    assert det["id"] == rdet["id"] and det["rotation"] == rdet["rotation"]
    np.testing.assert_allclose(det["corners"], np.asarray(rdet["corners"]),
                               atol=1e-6, rtol=0)
    K = np.asarray(cio.load_pinhole_brown(calib).K)
    R, t = fid.estimate_pose(det["corners"], 0.1, K, device="cpu")
    rR, rt = ref_fid.estimate_pose(rdet["corners"], 0.1, K)
    np.testing.assert_allclose(R, np.asarray(rR), atol=1e-6, rtol=0)
    np.testing.assert_allclose(t, np.asarray(rt), atol=1e-6, rtol=0)


def test_create_qr_document_cli_roundtrip(tmp_path, capsys):
    """The document bit-equal to the reference command's; both codes scan
    back with the port's detector."""
    from boofcv_tpu_torch.io import image_io
    from boofcv_tpu_torch.recognition.qr import detector
    out_png, ref_png = tmp_path / "doc.png", tmp_path / "ref.png"
    msgs = ["--message", "CLI DOC TEST", "--message", "0123456789"]
    ref, out = _both("create_qr_document", msgs + ["--output", str(ref_png)],
                     capsys)
    from boofcv_tpu_torch.cli import create_qr_document
    assert create_qr_document.main(msgs + ["--output", str(out_png)]
                                   + CPU) == 0
    assert out_png.read_bytes() == ref_png.read_bytes()
    doc = image_io.to_gray(image_io.load(str(out_png)))
    W = doc.shape[1]
    texts = []
    for sl in (np.s_[:, :W // 2], np.s_[:, W // 2:]):
        data, info = detector.detect_and_decode(doc[sl].astype(np.float32),
                                                device="cpu")
        if data is not None:
            texts.append(data.decode())
    assert sorted(texts) == ["0123456789", "CLI DOC TEST"]


@pytest.mark.parametrize("how", [["--max-size", "64"], ["--scale", "1.5"]],
                         ids=["box", "bilinear"])
def test_batch_downsize_cli(tmp_path, capsys, how):
    """An integer factor (the 2x2 box average) and a fractional one
    (bilinear ``distort.scale``): the PNG within one grey level of the
    reference command's."""
    from boofcv_tpu_torch.cli import batch_downsize
    from boofcv_tpu_torch.io import image_io
    d_in = str(tmp_path / "in")
    img = cs.downsize_dir(d_in)
    ref, out = _both("batch_downsize", ["--input", d_in, "--output",
                                        str(tmp_path / "ref")] + how, capsys)
    assert batch_downsize.main(["--input", d_in, "--output",
                                str(tmp_path / "out")] + how + CPU) == 0
    got = image_io.load(str(tmp_path / "out" / "a.png")).astype(int)
    want = image_io.load(str(tmp_path / "ref" / "a.png")).astype(int)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    if how[0] == "--max-size":
        assert got.shape == (48, 64)
        exp = img.reshape(48, 2, 64, 2).mean((1, 3))
        assert np.abs(got - exp).max() <= 1.0


@pytest.mark.parametrize("kind", ["chessboard", "square_grid",
                                  "circle_regular", "circle_hexagonal"])
def test_create_calibration_target_cli(tmp_path, capsys, kind):
    """Each target type, bit-equal to the reference command's file."""
    args = ["--type", kind, "--rows", "4", "--cols", "5", "--square", "30"]
    ref, out = _both("create_calibration_target", args + [
        "--output", str(tmp_path / "ref.png")], capsys)
    from boofcv_tpu_torch.cli import create_calibration_target
    assert create_calibration_target.main(args + [
        "--output", str(tmp_path / "t.png")] + CPU) == 0
    assert (tmp_path / "t.png").read_bytes() == (tmp_path /
                                                 "ref.png").read_bytes()


# --- every entry point asks for the card -----------------------------------

COMMAND_ARGS = {
    "stereo_vo_demo": ["--left", "L", "--right", "R"],
    "batch_downsize": ["--input", "I", "--output", "O", "--scale", "2"],
    "batch_remove_distortion": ["--calib", "C", "--input", "I",
                                "--output", "O"],
    "batch_scan_qr": ["--images", "I"],
    "camera_calibration": ["--images", "I", "--rows", "4", "--cols", "5"],
    "create_calibration_target": ["--rows", "2", "--cols", "2"],
    "create_fiducial": ["--ids", "7"],
    "create_qr_document": ["--message", "A", "--output", "doc.png"],
    "fiducial_detection": ["--images", "I"],
}
EXAMPLES = sorted(m.name for m in pkgutil.iter_modules(
    boofcv_tpu_torch.examples.__path__))
COMMANDS = sorted(m.name for m in pkgutil.iter_modules(
    boofcv_tpu_torch.cli.__path__))


def test_every_command_and_example_is_listed():
    assert sorted(COMMAND_ARGS) == COMMANDS
    assert len(EXAMPLES) == 64


@pytest.mark.parametrize("entry", [f"examples.{e}" for e in EXAMPLES]
                         + [f"cli.{c}" for c in COMMANDS])
def test_entry_point_raises_without_a_card(entry, tmp_path, monkeypatch):
    """Without ``--device`` an example or command runs on the card; without
    a card it raises before it reads or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"boofcv_tpu_torch.{entry}")
    argv = COMMAND_ARGS.get(entry.split(".")[1], [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(list(argv))
    assert os.listdir(tmp_path) == []
