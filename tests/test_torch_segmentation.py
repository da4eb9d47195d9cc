"""Segmentation: SLIC, the mean-shift filter and merge, watershed, the
FH04 edge weights and the native FH04 binding, and the union-find
numbering; the port against the JAX package on the same seeded numpy
inputs, on the CPU.

Tolerances: labels are exact (SLIC on integer-valued images, whose centre
sums are exact in float32 in any order; the merges; watershed; FH04 on
the same edge weights); the mean-shift filter (an exp a neighbour, XLA's
and PyTorch's exp differ in the last bit) to 1e-5 relative; the FH04 edge
weights (the separable blur as shifted adds against XLA's convolution) to
1e-4 absolute on 0-255 images.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu import native as jnative
from boofcv_tpu.feature import segmentation as jseg
from boofcv_tpu.utils import unionfind as juf
from boofcv_tpu_torch import native as tnative
from boofcv_tpu_torch.feature import segmentation as tseg
from boofcv_tpu_torch.utils import unionfind as tuf

torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _regions(seed=0, h=40, w=56, colour=False, noise=3.0):
    """Piecewise-constant regions with integer noise (integer-valued)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    region = (xx * 3 // w) + 3 * (yy * 2 // h)
    levels = rng.uniform(20, 235, (6, 3 if colour else 1))
    img = levels[region] + rng.normal(0, noise, (h, w, levels.shape[1]))
    img = np.clip(np.round(img), 0, 255).astype(np.float32)
    return (img if colour else img[..., 0]), region


# ------------------------------------------------------------ union-find

def test_union_find_numbers_sets_by_root_as_the_reference():
    rng = np.random.default_rng(0)
    pairs = rng.integers(0, 60, (45, 2))
    a, b = tuf.UnionFind(60), juf.UnionFind(60)
    for i, j in pairs:
        assert a.union(int(i), int(j)) == b.union(int(i), int(j))
    np.testing.assert_array_equal(a.roots(), b.roots())
    np.testing.assert_array_equal(a.labels(), b.labels())
    # union(a, b) points b's root at a's: roots are not the smallest ids
    uf = tuf.UnionFind(4)
    uf.union(3, 1)
    assert uf.find(1) == 3
    np.testing.assert_array_equal(uf.labels(), [0, 2, 1, 2])


# ------------------------------------------------------------------ SLIC

@pytest.mark.parametrize("colour", [False, True])
def test_slic_labels_equal_jax(colour, monkeypatch):
    img, _ = _regions(1, colour=colour)
    want = _np(jseg.slic(jnp.asarray(img), num_segments=20,
                         compactness=10.0, iterations=4))
    got = tseg.slic(_t(img), num_segments=20, iterations=4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    # the same labels through many pixel chunks
    monkeypatch.setattr(tseg, "SLIC_CHUNK", 333)
    np.testing.assert_array_equal(
        _np(tseg.slic(_t(img), num_segments=20, iterations=4)), want)


def test_slic_respects_a_strong_boundary():
    img = np.zeros((48, 48), np.float32)
    img[:, :24] = 50
    img[:, 24:] = 200
    lab = _np(tseg.slic(_t(img), num_segments=16))
    assert not (set(np.unique(lab[:, :22])) & set(np.unique(lab[:, 26:])))


# ------------------------------------------------------------ mean shift

def test_mean_shift_filter_matches_jax():
    img, _ = _regions(2, noise=6.0)
    got = tseg.mean_shift_filter(_t(img), 2, 15.0, iterations=3)
    want = _np(jseg.mean_shift_filter(img, 2, 15.0, iterations=3))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", [3, 4])
def test_segment_mean_shift_labels_equal_jax(seed):
    img, _ = _regions(seed, noise=2.0)
    want, filtered = jseg.segment_mean_shift(img)
    got, tfilt = tseg.segment_mean_shift(_t(img))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(_np(tfilt), filtered, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", range(4))
def test_native_merge_numbers_as_the_reference_loop(seed):
    """The native merge's labels equal the reference's union-find loop's on
    the reference's own filtered image (many merges, arms that join from
    either side)."""
    rng = np.random.default_rng(10 + seed)
    filtered = np.round(rng.uniform(0, 40, (23, 31)) / 9.0).astype(
        np.float32) * 9.0
    from boofcv_tpu.utils.unionfind import UnionFind
    h, w = filtered.shape
    uf = UnionFind(h * w)
    flat = filtered.ravel()
    for y in range(h):
        for x in range(w):
            i = y * w + x
            if x + 1 < w and abs(flat[i] - flat[i + 1]) < 8.0:
                uf.union(i, i + 1)
            if y + 1 < h and abs(flat[i] - flat[i + w]) < 8.0:
                uf.union(i, i + w)
    want = uf.labels().reshape(h, w)
    right, down = tseg._similar(filtered, 8.0)
    np.testing.assert_array_equal(
        tseg._labels_from_roots(tnative.mean_shift_merge(right, down)), want)
    np.testing.assert_array_equal(tseg._merge_regions_python(filtered, 8.0),
                                  want)


def test_segment_mean_shift_two_regions():
    img = np.zeros((30, 30), np.float32)
    img[:, 15:] = 120
    labels, _ = tseg.segment_mean_shift(_t(img))
    assert len(np.unique(labels)) == 2


# ------------------------------------------------------------- watershed

def _two_valleys():
    yy, xx = np.mgrid[0:40, 0:60]
    height = -np.minimum(np.abs(xx - 15), np.abs(xx - 45)).astype(np.float32)
    height = height - height.min()
    markers = np.zeros((40, 60), np.int32)
    markers[20, 15] = 1
    markers[20, 45] = 2
    return height, markers


def test_watershed_equals_jax_on_two_basins():
    height, markers = _two_valleys()
    lab = tseg.watershed(_t(height), _t(markers))
    np.testing.assert_array_equal(_np(lab),
                                  _np(jseg.watershed(height, markers)))
    assert (_np(lab)[:, :28] == 1).mean() > 0.95


@pytest.mark.parametrize("every", [1, 3])
def test_watershed_equals_jax_on_a_rough_surface(every, monkeypatch):
    rng = np.random.default_rng(5)
    height = np.round(rng.uniform(0, 50, (36, 44))).astype(np.float32)
    markers = np.zeros((36, 44), np.int32)
    for k, (y, x) in enumerate(rng.integers(0, 36, (7, 2)) * [1, 1.2]):
        markers[int(y), int(x)] = k + 1
    want = _np(jseg.watershed(height, markers))
    monkeypatch.setattr(tseg, "WATERSHED_CHECK_EVERY", every)
    lab, trips, run, reads = tseg._watershed(_t(height), _t(markers))
    np.testing.assert_array_equal(_np(lab), want)
    assert run >= trips and reads == -(-run // every)
    # the reference's trip count does not depend on how often the flag is
    # read
    monkeypatch.setattr(tseg, "WATERSHED_CHECK_EVERY", 1)
    assert tseg._watershed(_t(height), _t(markers))[1] == trips


# ------------------------------------------------------------------ FH04

def test_fh04_edge_weights_match_jax():
    for colour in (False, True):
        img, _ = _regions(6, colour=colour)
        got = tseg.fh04_edge_weights(_t(img))
        want = jseg.fh04_edge_weights(jnp.asarray(img))
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-4)
    four = tseg.fh04_edge_weights(_t(img), eight=False)
    assert four[2] is None and four[3] is None


@pytest.mark.parametrize("eight", [True, False])
def test_fh04_binding_equals_numpy_and_the_reference(eight):
    img = np.random.default_rng(7).uniform(0, 255, (24, 32)).astype(
        np.float32)
    ws = [None if w is None else np.asarray(w)
          for w in jseg.fh04_edge_weights(jnp.asarray(img), eight=eight)]
    lab, n = tnative.fh04_merge(*ws, k=200.0, min_size=5)
    assert lab.dtype == np.int32
    ref_lab, ref_n = jnative.fh04_merge(*ws, k=200.0, min_size=5)
    np_lab, np_n = tseg._fh04_merge_numpy(*ws, 200.0, 5)
    jnp_lab, jnp_n = jseg._fh04_merge_numpy(*ws, 200.0, 5)
    assert n == ref_n == np_n == jnp_n
    for other in (ref_lab, np_lab, jnp_lab):
        np.testing.assert_array_equal(lab, other)


def test_segment_fh04_matches_jax_on_three_bands():
    rng = np.random.default_rng(0)
    img = np.zeros((40, 60), np.float32)
    img[:, :20] = 40.0
    img[:, 20:40] = 120.0
    img[:, 40:] = 210.0
    img += rng.normal(0, 2.0, img.shape).astype(np.float32)
    lab, n = tseg.segment_fh04(_t(img), k=150.0, min_size=100)
    want, jn = jseg.segment_fh04(jnp.asarray(img), k=150.0, min_size=100)
    assert n == jn == 3
    np.testing.assert_array_equal(lab, np.asarray(want))


def test_fh04_diagonals_come_in_pairs():
    w = np.zeros((4, 5), np.float32)
    with pytest.raises(ValueError, match="both diagonal"):
        tnative.fh04_merge(w, w, w, None)


def test_segment_fh04_raises_without_the_native_library(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "ccl.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(tnative, "_lib", None)
    img, _ = _regions(8)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tseg.segment_fh04(_t(img))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tseg.segment_mean_shift(_t(img))


@pytest.mark.parametrize("name", ["segment_superpixels",
                                  "segment_graph_fh04",
                                  "watershed_with_seeds"])
def test_example_passes_on_the_cpu(name):
    import importlib
    mod = importlib.import_module(f"boofcv_tpu_torch.examples.{name}")
    assert mod.main(["--device", "cpu"]) == 0
