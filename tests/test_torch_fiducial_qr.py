"""Square fiducials and QR codes: the port against the JAX package on the
scenes of ``tests/test_fiducial.py`` and ``tests/test_qr.py``.

Tolerances: ids, rotations, decoded strings, QR module matrices and the
Reed-Solomon codewords are exact; fiducial corners (float64 polygon fits of
the same contours) to 1e-6 px; the sampled cell means exact (the port's
array form of the reference's sampling loop); poses (float64 GN polish) to
1e-9; the QR homography (float64 DLT) to 1e-9 relative.
"""

import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.geo import epipolar as jepi
from boofcv_tpu.recognition import fiducial_square as jfid
from boofcv_tpu.recognition.qr import code as jqr
from boofcv_tpu.recognition.qr import detector as jdet
from boofcv_tpu.recognition.qr.reed_solomon import ReedSolomon as JRS
from boofcv_tpu_torch.recognition import fiducial_square as tfid
from boofcv_tpu_torch.recognition import homographies
from boofcv_tpu_torch.recognition.qr import code as tqr
from boofcv_tpu_torch.recognition.qr import detector as tdet
from boofcv_tpu_torch.recognition.qr.reed_solomon import ReedSolomon as TRS

torch.set_num_threads(1)
CPU = "cpu"


def _same_detections(got, want, ncc=False):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["id"] == w["id"] and g["rotation"] == w["rotation"]
        np.testing.assert_allclose(g["corners"], w["corners"], rtol=0,
                                   atol=1e-6)
        if ncc:
            np.testing.assert_allclose(g["ncc"], w["ncc"], rtol=1e-12)


# ---------------------------------------------------------------- fiducials

def test_encode_marker_and_max_id():
    assert tfid.max_marker_id() == jfid.max_marker_id()
    for mid, px in ((0, 16), (777, 10), (jfid.max_marker_id(), 12)):
        np.testing.assert_array_equal(tfid.encode_marker(mid, px),
                                      jfid.encode_marker(mid, px))


@pytest.mark.parametrize("mid", [0, 5, 1234, 4095])
def test_marker_roundtrip_all_rotations(mid):
    img = jfid.encode_marker(mid)
    for k in range(4):
        rot = np.rot90(img, k).copy()
        got = tfid.detect(rot, device=CPU)
        _same_detections(got, jfid.detect(rot))
        assert len(got) == 1 and got[0]["id"] == mid


def _noisy_scene():
    rng = np.random.default_rng(0)
    img = jfid.encode_marker(321, cells_px=10)
    scene = np.full((300, 400), 180.0, np.float32)
    scene[40:40 + img.shape[0], 60:60 + img.shape[1]] = img
    return scene + rng.normal(0, 4, scene.shape).astype(np.float32)


def test_marker_in_scene_with_noise():
    scene = _noisy_scene()
    got = tfid.detect(scene, device=CPU)
    _same_detections(got, jfid.detect(scene))
    assert [d["id"] for d in got] == [321]


def test_sample_cells_is_the_reference_loop():
    """The array form picks the loop's pixels and sums in its order."""
    scene = _noisy_scene()
    c = tfid.detect(scene, device=CPU)[0]["corners"]
    for corners in (c, c + np.array([0.37, -0.21]), c[::-1].copy()):
        H = homographies(tfid._UNIT_SQUARE, corners, CPU)
        want = jfid._sample_cells(scene, corners, 1)
        np.testing.assert_array_equal(tfid._sample_cells(scene, H, 1), want)
        assert tfid._decode_cells(want, 1) == jfid._decode_cells(want, 1)


def test_marker_pose():
    img = jfid.encode_marker(42, cells_px=12)
    c = tfid.detect(img, device=CPU)[0]["corners"]
    f = 300.0
    K = np.array([[f, 0, img.shape[1] / 2], [0, f, img.shape[0] / 2],
                  [0, 0, 1.0]])
    R, t = tfid.estimate_pose(c, marker_size=0.1, K=K, device=CPU)
    Rj, tj = jfid.estimate_pose(c, marker_size=0.1, K=K)
    np.testing.assert_allclose(R, Rj, atol=1e-9)
    np.testing.assert_allclose(t, tj, atol=1e-9)
    s = 0.05
    world = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0.0]])
    pc = world @ R.T + t
    proj = (pc / pc[:, 2:]) @ K.T
    assert np.abs(proj[:, :2] - c).max() < 1.0 and t[2] > 0


def _image_fiducial_scene():
    rng = np.random.default_rng(4)

    def smooth(a):
        k = np.array([0.25, 0.5, 0.25])
        for ax in (0, 1):
            a = np.apply_along_axis(
                lambda r: np.convolve(r, k, "same"), ax, a)
        return a
    patterns = [smooth(smooth(rng.uniform(0, 255, (24, 24))))
                .astype(np.float32) for _ in range(2)]
    img = np.full((160, 200), 220.0, np.float32)
    x0, y0, sz = 60, 40, 64
    img[y0:y0 + sz, x0:x0 + sz] = 0.0
    b = int(sz * 0.25)
    yi = ((np.arange(sz - 2 * b) + 0.5) / (sz - 2 * b) * 24).astype(int)
    img[y0 + b:y0 + sz - b, x0 + b:x0 + sz - b] = \
        patterns[1][yi[:, None], yi[None, :]]
    return img, patterns


@pytest.mark.parametrize("k", [0, 1, 3])
def test_image_fiducial_matches_jax(k):
    img, patterns = _image_fiducial_scene()
    img = np.rot90(img, k).copy()
    got = tfid.detect_image(img, patterns, device=CPU)
    _same_detections(got, jfid.detect_image(img, patterns), ncc=True)
    assert len(got) == 1 and got[0]["id"] == 1 and got[0]["ncc"] > 0.7


def test_image_fiducial_example_scene():
    """The example's scene: two patterns, one turned, in noise."""
    from boofcv_tpu_torch.examples import fiducial_image
    assert fiducial_image.main(["--device", "cpu"]) == 0


# ----------------------------------------------------------------------- QR

def test_reed_solomon_corrects_to_capacity():
    rs_t, rs_j = TRS(16), JRS(16)
    assert rs_t.generator == rs_j.generator
    rng = random.Random(0)
    for _ in range(30):
        msg = [rng.randrange(256) for _ in range(30)]
        c = msg + rs_t.encode(msg)
        assert c[30:] == rs_j.encode(msg)
        for p in rng.sample(range(len(c)), rng.randrange(0, 9)):
            c[p] ^= rng.randrange(1, 256)
        got, want = rs_t.decode(c), rs_j.decode(c)
        assert got == want and got[0] is not None and got[0][:30] == msg


def test_reed_solomon_rejects_overload():
    msg = list(range(20))
    c = msg + TRS(8).encode(msg)
    for p in range(6):
        c[p] ^= 0xAA
    got = TRS(8).decode(c)
    assert got == JRS(8).decode(c)
    assert got[0] is None or got[0][:20] != msg


@pytest.mark.parametrize("level", ["L", "M", "Q", "H"])
def test_encode_bit_equal_every_version(level):
    for version in range(1, 41):
        cap = jqr.data_capacity_bytes(version, level)
        assert tqr.data_capacity_bytes(version, level) == cap
        text = ("boofcv port / " * 300)[:max(cap - 5, 1)]
        mask = (version + ord(level)) % 8
        got = tqr.encode(text, version, level, mask)
        np.testing.assert_array_equal(got, jqr.encode(text, version, level,
                                                      mask))
        if version >= 7:
            assert tqr.read_version_info(got) == version


@pytest.mark.parametrize("text,kw", [
    ("01234567899876543210" * 3, {}), ("HELLO WORLD 123 $%*+-./:",
                                       {"level": "Q"}),
    ("漢字テスト", {}), ("hi", {}), ("penalty-based mask",
                                    {"version": 2, "level": "M"}),
    ("x" * 300, {"level": "L"})])
def test_encode_modes_and_auto_choices_bit_equal(text, kw):
    got = tqr.encode(text, **kw)
    np.testing.assert_array_equal(got, jqr.encode(text, **kw))
    assert tqr.select_mode(text) == jqr.select_mode(text)
    assert tqr.mask_penalty(got) == jqr.mask_penalty(got)
    out, info = tqr.decode(got)
    assert out.decode("utf8") == text


def _damaged(fraction, seed=0):
    """``tests/test_qr.py``'s damage: ``fraction`` of n^2 random flips
    inside the central data block (repeats allowed)."""
    mat = jqr.encode("damage tolerance test", version=3, level="H", mask=2)
    rng = np.random.default_rng(seed)
    m = mat.copy()
    n = m.shape[0]
    for _ in range(int(n * n * fraction)):
        r, c = rng.integers(9, n - 9, 2)
        m[r, c] = ~m[r, c]
    return m


def _too_damaged(seed=0):
    """15 % of every module outside the finders, timing and format rows
    flipped: past level H's correction."""
    mat = jqr.encode("damage tolerance test", version=3, level="H", mask=2)
    n = mat.shape[0]
    flip = np.random.default_rng(seed).random((n, n)) < 0.15
    flip[:9, :9] = flip[:9, -8:] = flip[-8:, :9] = False
    flip[6, :] = flip[:, 6] = flip[8, :] = flip[:, 8] = False
    return mat ^ flip


@pytest.mark.parametrize("case", ["clean", "damaged", "damaged_more",
                                  "too_damaged"])
def test_decode_equal_damaged_and_too_damaged(case):
    m = {"clean": lambda: _damaged(0.0), "damaged": lambda: _damaged(0.04),
         "damaged_more": lambda: _damaged(0.08),
         "too_damaged": _too_damaged}[case]()
    got, want = tqr.decode(m), jqr.decode(m)
    assert got == want
    if case == "damaged":
        assert got[0].decode() == "damage tolerance test"
        assert got[1]["errors_corrected"] > 0
    if case == "too_damaged":
        assert got[0] is None and got[1] == {"error": "ecc"}


def _qr_scene(name):
    if name == "plain":
        mat = jqr.encode("image localization", version=2, level="M", mask=1)
        return jdet.render(mat, module_px=5), "image localization"
    if name == "noise_offset":
        rng = np.random.default_rng(1)
        img = jdet.render(jqr.encode("noisy", version=1, level="Q", mask=5),
                          module_px=6)
        big = np.full((img.shape[0] + 40, img.shape[1] + 60), 255.0,
                      np.float32)
        big[17:17 + img.shape[0], 23:23 + img.shape[1]] = img
        return big + rng.normal(0, 6, big.shape).astype(np.float32), "noisy"
    if name == "version12":
        text = "version estimation from finder geometry " * 3
        mat = jqr.encode(text, version=12, level="M")
        return jdet.render(mat, module_px=4), text
    if name == "damaged_image":
        img = jdet.render(_damaged(0.04), module_px=5)
        return img, "damage tolerance test"
    return jdet.render(_too_damaged(), module_px=5), None


@pytest.mark.parametrize("name", ["plain", "noise_offset", "version12",
                                  "damaged_image", "too_damaged"])
def test_detect_and_decode_matches_jax(name):
    img, text = _qr_scene(name)
    got, info = tdet.detect_and_decode(img, device=CPU)
    want, info_j = jdet.detect_and_decode(img)
    assert got == want
    if text is None:
        assert got is None and info == info_j
        return
    assert got.decode() == text
    np.testing.assert_allclose(info.pop("homography"),
                               info_j.pop("homography"), rtol=1e-9,
                               atol=1e-9)
    assert info == info_j


def test_position_patterns_and_render():
    img, _ = _qr_scene("version12")
    got = tdet.find_position_patterns(img, device=CPU)
    want = jdet.find_position_patterns(img)
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-9)
    assert tdet._order_finders(got)[0][0].tolist() == \
        jdet._order_finders(want)[0][0].tolist()
    mat = jqr.encode("x", 2, "M", 0)
    np.testing.assert_array_equal(tdet.render(mat, 3, 2),
                                  jdet.render(mat, 3, 2))


def test_homographies_helper_matches_jax_dlt():
    rng = np.random.default_rng(5)
    src = rng.uniform(0, 10, (3, 6, 2))
    dst = rng.uniform(0, 400, (3, 6, 2))
    want = np.asarray(jepi.homography_dlt(jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_allclose(homographies(src, dst, CPU), want, rtol=1e-9,
                               atol=1e-9)


def test_qr_document_example():
    from boofcv_tpu_torch.examples import create_qr_document
    assert create_qr_document.main(["--device", "cpu"]) == 0
