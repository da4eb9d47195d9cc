"""The port's ``io/`` host modules against the JAX package's: the
reference's round trips (``tests/test_io.py``) on the port's copies, files
written by each package byte-equal to the other's (PNM, PNG, calibration
YAML, binary and ASCII PLY, MJPEG), and each package reading the other's
files exactly.  Every comparison is exact.
"""

import os

import numpy as np
import pytest

from boofcv_tpu.io import calibration_io as jcio
from boofcv_tpu.io import image_io as jimg
from boofcv_tpu.io import points_io as jpts
from boofcv_tpu.io import video as jvid
from boofcv_tpu.io import visualize as jvis
from boofcv_tpu_torch.io import calibration_io as tcio
from boofcv_tpu_torch.io import image_io as timg
from boofcv_tpu_torch.io import points_io as tpts
from boofcv_tpu_torch.io import video as tvid
from boofcv_tpu_torch.io import visualize as tvis


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _cross(tmp_path, name, save_t, save_j, load_t, load_j, check):
    """Write with both packages, compare the bytes, read each file with
    both packages."""
    pt, pj = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
    save_t(pt)
    save_j(pj)
    assert _bytes(pt) == _bytes(pj), name
    for load in (load_t, load_j):
        for path in (pt, pj):
            check(load(path))


# --- images ------------------------------------------------------------------

@pytest.mark.parametrize("ext", [".pgm", ".ppm", ".png", ".pnm"])
def test_image_files_byte_equal(tmp_path, ext):
    rng = np.random.default_rng(4)
    shape = (30, 41, 3) if ext == ".ppm" else (33, 47)
    img = rng.uniform(-20, 275, shape).astype(np.float32)   # clipped, rounded
    want = np.clip(np.round(img), 0, 255)
    _cross(tmp_path, "img" + ext, lambda p: timg.save(p, img),
           lambda p: jimg.save(p, img), timg.load, jimg.load,
           lambda got: np.testing.assert_array_equal(got, want))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_colour_byte_equal(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (21, 19, channels)).astype(np.float32)
    _cross(tmp_path, "c.png", lambda p: timg.save_png(p, img),
           lambda p: jimg.save_png(p, img), timg.load_png, jimg.load_png,
           lambda got: np.testing.assert_array_equal(got, img[..., :3]))


def test_pnm_roundtrip(tmp_path):
    """tests/test_io.py's PNM round trip, on the port."""
    rng = np.random.default_rng(4)
    gray = rng.integers(0, 255, (30, 40)).astype(np.float32)
    p = str(tmp_path / "img.pgm")
    timg.save(p, gray)
    np.testing.assert_array_equal(timg.load(p), gray)
    rgb = rng.integers(0, 255, (20, 25, 3)).astype(np.float32)
    p = str(tmp_path / "img.ppm")
    timg.save(p, rgb)
    np.testing.assert_array_equal(timg.load(p), rgb)


def test_pnm_16_bit_and_comments(tmp_path):
    """A 16-bit P5 with a comment in its header reads big-endian samples
    in both packages."""
    vals = np.array([[0, 1, 256], [65535, 4660, 7]], np.uint16)
    p = str(tmp_path / "deep.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n# a comment\n3 2\n65535\n")
        f.write(vals.astype(">u2").tobytes())
    np.testing.assert_array_equal(timg.load(p), vals.astype(np.float32))
    np.testing.assert_array_equal(timg.load(p), jimg.load(p))


def test_save_pnm_refuses_other_channel_counts(tmp_path):
    with pytest.raises(ValueError, match="P6"):
        timg.save_pnm(str(tmp_path / "x.ppm"), np.zeros((4, 4, 4)))
    with pytest.raises(ValueError, match="unsupported image format"):
        timg.save(str(tmp_path / "x.bmp"), np.zeros((4, 4)))


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    gray = rng.integers(0, 255, (33, 47)).astype(np.float32)
    p = str(tmp_path / "img.png")
    timg.save(p, gray)
    np.testing.assert_array_equal(timg.load(p), gray)
    rgb = rng.integers(0, 255, (21, 19, 3)).astype(np.float32)
    timg.save(p, rgb)
    np.testing.assert_array_equal(timg.load(p), rgb)
    with open(p, "r+b") as f:
        f.write(b"GIF8")
    with pytest.raises(ValueError, match="not a PNG"):
        timg.load_png(p)


def _filtered_png(path, arr):
    """A gray PNG whose rows use filters 0-4 in turn (tests/test_io.py)."""
    import struct
    import zlib
    h, w = arr.shape
    rows = []
    prev = np.zeros(w, np.int32)
    for y in range(h):
        f = y % 5
        line = arr[y].astype(np.int32)
        enc = line.copy()
        if f == 1:
            for x in range(w - 1, 0, -1):
                enc[x] = (enc[x] - line[x - 1]) & 0xFF
        elif f == 2:
            enc = (line - prev) & 0xFF
        elif f == 3:
            for x in range(w - 1, -1, -1):
                left = line[x - 1] if x >= 1 else 0
                enc[x] = (enc[x] - ((left + prev[x]) >> 1)) & 0xFF
        elif f == 4:
            for x in range(w - 1, -1, -1):
                a = line[x - 1] if x >= 1 else 0
                b = prev[x]
                c = prev[x - 1] if x >= 1 else 0
                p_ = a + b - c
                pa, pb, pc = abs(p_ - a), abs(p_ - b), abs(p_ - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc
                                                           else c)
                enc[x] = (enc[x] - pred) & 0xFF
        rows.append(bytes([f]) + enc.astype(np.uint8).tobytes())
        prev = line
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    with open(path, "wb") as fo:
        fo.write(b"\x89PNG\r\n\x1a\n")
        fo.write(timg._png_chunk(b"IHDR", ihdr))
        fo.write(timg._png_chunk(b"IDAT", zlib.compress(b"".join(rows))))
        fo.write(timg._png_chunk(b"IEND", b""))


def test_png_filtered_decode(tmp_path):
    arr = np.random.default_rng(6).integers(0, 255, (10, 12)).astype(
        np.uint8)
    p = str(tmp_path / "f.png")
    _filtered_png(p, arr)
    np.testing.assert_array_equal(timg.load(p), arr.astype(np.float32))
    np.testing.assert_array_equal(timg.load(p), jimg.load(p))


def test_load_sequence_and_to_gray(tmp_path):
    rng = np.random.default_rng(7)
    for i in range(3):
        timg.save(str(tmp_path / f"f{i}.png"),
                  rng.integers(0, 255, (6, 9, 3)).astype(np.float32))
    (tmp_path / "notes.txt").write_text("skip me")
    got = timg.load_sequence(str(tmp_path))
    want = jimg.load_sequence(str(tmp_path))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(timg.to_gray(g), jimg.to_gray(w))
    np.testing.assert_array_equal(timg.to_gray(got[0][..., 0]),
                                  got[0][..., 0])


# --- calibration ---------------------------------------------------------------

def _cam(mod):
    return mod.CameraPinholeBrown(640, 480, 525.1, 526.2, 0.1, 320.5, 241.2,
                                  (-0.1, 0.03), 1e-4, -2e-4)


def test_pinhole_yaml_byte_equal(tmp_path):
    want = _cam(tcio)
    _cross(tmp_path, "cam.yaml",
           lambda p: tcio.save_pinhole_brown(_cam(tcio), p),
           lambda p: jcio.save_pinhole_brown(_cam(jcio), p),
           tcio.load_pinhole_brown, jcio.load_pinhole_brown,
           lambda got: (_same_cam(got, want)))
    np.testing.assert_allclose(want.K, _cam(jcio).K)


def _same_cam(a, b):
    for f in ("width", "height", "fx", "fy", "skew", "cx", "cy", "radial",
              "t1", "t2"):
        assert getattr(a, f) == getattr(b, f), f


def test_stereo_yaml_byte_equal(tmp_path):
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec([0.01, 0.02, -0.01]).as_matrix()
    t = np.array([-0.12, 0.001, 0.002])

    def make(mod):
        cam = mod.CameraPinholeBrown(640, 480, 500.0, 500.0, 0.0, 320.0,
                                     240.0)
        return mod.StereoParameters(cam, cam, R, t)

    def check(sp):
        np.testing.assert_array_equal(sp.R_right_to_left, R)
        np.testing.assert_array_equal(sp.t_right_to_left, t)
        assert sp.left.fx == 500.0 and sp.right.cy == 240.0
    _cross(tmp_path, "stereo.yaml",
           lambda p: tcio.save_stereo(make(tcio), p),
           lambda p: jcio.save_stereo(make(jcio), p),
           tcio.load_stereo, jcio.load_stereo, check)


def test_boofcv_layout_with_block_sequences(tmp_path):
    """BoofCV's CalibrationIO layout, ``radial`` as a block sequence."""
    text = ("model: pinhole_radial_tangential\n"
            "pinhole:\n  fx: 500.5\n  fy: 501.0\n  cx: 320.0\n  cy: 240.0\n"
            "  skew: 0.0\n  width: 640\n  height: 480\n"
            "radial:\n- -0.25\n- 0.07\nt1: 0.001\nt2: -0.002\n")
    p = tmp_path / "boof.yaml"
    p.write_text(text)
    got = tcio.load_pinhole_brown(str(p))
    _same_cam(got, jcio.load_pinhole_brown(str(p)))
    assert got.radial == (-0.25, 0.07) and got.width == 640


# --- point clouds --------------------------------------------------------------

@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("colors", [True, False])
def test_ply_byte_equal(tmp_path, binary, colors):
    rng = np.random.default_rng(int(binary) * 2 + int(colors))
    pts = rng.normal(0, 1, (100, 3))
    cols = rng.integers(0, 255, (100, 3)).astype(np.uint8) if colors \
        else None

    def check(out):
        p2, c2 = out
        np.testing.assert_array_equal(p2, pts)
        if colors:
            np.testing.assert_array_equal(c2, cols)
        else:
            assert c2 is None
    _cross(tmp_path, "cloud.ply",
           lambda p: tpts.save_ply(p, pts, cols, binary=binary),
           lambda p: jpts.save_ply(p, pts, cols, binary=binary),
           tpts.load_ply, jpts.load_ply, check)


def test_ply_float_properties(tmp_path):
    """A binary PLY with float32 properties (another writer's)."""
    pts = np.random.default_rng(9).normal(0, 1, (7, 3)).astype("<f4")
    p = str(tmp_path / "f32.ply")
    with open(p, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 7\n"
                b"property float x\nproperty float y\nproperty float z\n"
                b"end_header\n" + pts.tobytes())
    got, cols = tpts.load_ply(p)
    assert cols is None and got.dtype == np.float64
    np.testing.assert_array_equal(got, pts.astype(np.float64))
    np.testing.assert_array_equal(got, jpts.load_ply(p)[0])


# --- video ----------------------------------------------------------------------

def test_mjpeg_roundtrip_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (32, 48), dtype=np.uint8)
              for _ in range(4)]
    pt, pj = str(tmp_path / "t.mjpeg"), str(tmp_path / "j.mjpeg")
    tvid.write_mjpeg(pt, frames, quality=95)
    jvid.write_mjpeg(pj, frames, quality=95)
    assert _bytes(pt) == _bytes(pj)
    out = list(tvid.read_mjpeg(pt))
    assert len(out) == 4
    for a, b, c in zip(frames, out, jvid.read_mjpeg(pt)):
        assert b.shape[:2] == a.shape
        np.testing.assert_array_equal(b, c)
        assert np.abs(a.astype(float) - b.astype(float)).mean() < 6.0
    data = _bytes(pt)
    assert [len(f) for f in tvid.split_mjpeg(b"junk" + data)] == \
        [len(f) for f in jvid.split_mjpeg(data)]


def test_image_sequence(tmp_path):
    rng = np.random.default_rng(1)
    for i in range(3):
        timg.save(str(tmp_path / f"f{i:03d}.pgm"),
                  rng.integers(0, 255, (10, 12)).astype(np.uint8))
    seq = tvid.ImageSequence(str(tmp_path / "*.pgm"))
    frames = list(seq)
    assert len(seq) == 3 and len(frames) == 3
    assert frames[0].shape == (10, 12)
    for a, b in zip(frames, jvid.ImageSequence(str(tmp_path / "*.pgm"))):
        np.testing.assert_array_equal(a, b)


# --- visualize -----------------------------------------------------------------

def test_visualize_writes_the_reference_plots(tmp_path):
    """Each plot as a PNG of the reference's size (matplotlib's Agg)."""
    from PIL import Image
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (60, 80))
    ys, xs = rng.uniform(0, 60, 20), rng.uniform(0, 80, 20)
    valid = rng.random(20) > 0.3
    cloud = rng.normal(0, 1, (50, 3))
    traj = np.cumsum(rng.normal(0, 0.1, (12, 3)), 0)
    calls = {
        "features": lambda m, p: m.save_features(p, img, ys, xs, valid),
        "disparity": lambda m, p: m.save_disparity(p, img / 10.0),
        "cloud": lambda m, p: m.save_point_cloud(p, cloud),
        "trajectory": lambda m, p: m.save_trajectory(p, traj, traj * 1.1),
    }
    for name, call in calls.items():
        pt, pj = str(tmp_path / f"t_{name}.png"), str(tmp_path /
                                                     f"j_{name}.png")
        call(tvis, pt)
        call(jvis, pj)
        assert os.path.getsize(pt) > 0
        with Image.open(pt) as a, Image.open(pj) as b:
            assert a.size == b.size
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
