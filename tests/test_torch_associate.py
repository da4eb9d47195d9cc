"""Descriptor association: the port against the JAX package on the same
numpy inputs, on the CPU.  Indices and valid masks are exact; float scores
to 1e-5 of the largest entry; Hamming scores exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.feature import associate as ja
from boofcv_tpu_torch.feature import associate as ta

torch.set_num_threads(1)


def _descriptors(seed, na=300, nb=300, d=64, noise=0.05):
    """Unit descriptors and a noisy, shuffled copy with some strangers."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (na, d)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b = a[rng.permutation(na)[:nb]] if nb <= na else np.concatenate(
        [a, rng.normal(0, 0.2, (nb - na, d)).astype(np.float32)])
    b = b + rng.normal(0, noise, b.shape).astype(np.float32)
    b[::17] = rng.normal(0, 0.2, b[::17].shape)
    return a, b.astype(np.float32)


def _same_matches(ref, out, score_tol=1e-5):
    assert out.src.dtype == torch.int32 and out.dst.dtype == torch.int32
    assert out.score.dtype == torch.float32 and out.valid.dtype == torch.bool
    np.testing.assert_array_equal(out.src.numpy(), np.asarray(ref.src))
    np.testing.assert_array_equal(out.dst.numpy(), np.asarray(ref.dst))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    rs = np.asarray(ref.score)
    np.testing.assert_allclose(out.score.numpy(), rs, rtol=0,
                               atol=score_tol * max(float(np.abs(rs).max()),
                                                    1e-30))


@pytest.mark.parametrize("name", ["score_euclidean_sq", "score_sad",
                                  "score_ncc"])
def test_float_scores(name):
    a, b = _descriptors(0, 300, 280)
    ref = np.asarray(getattr(ja, name)(jnp.asarray(a), jnp.asarray(b)))
    out = getattr(ta, name)(torch.from_numpy(a), torch.from_numpy(b))
    assert out.shape == (300, 280) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


def test_score_hamming_exact():
    """Packed words with bit 31 set, all ones and all zeros."""
    rng = np.random.default_rng(1)
    a = rng.integers(-2**31, 2**31, (90, 4), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, (70, 4), dtype=np.int64).astype(np.int32)
    a[0], a[1], a[2] = 0, -1, -2**31
    b[0], b[1], b[2] = -1, 0, 2**31 - 1
    ref = np.asarray(ja.score_hamming(jnp.asarray(a), jnp.asarray(b)))
    out = ta.score_hamming(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out[0, 0] == 128 and out[1, 1] == 128 and out[2, 2] == 128
    bits = lambda x: np.unpackbits(x.view(np.uint8), axis=-1)
    want = (bits(a)[:, None, :] != bits(b)[None, :, :]).sum(-1)
    np.testing.assert_array_equal(out.numpy(), want)


def _scores(seed, na=300, nb=300):
    a, b = _descriptors(seed, na, nb)
    s = np.array(ja.score_euclidean_sq(jnp.asarray(a), jnp.asarray(b)))
    return a, b, s


@pytest.mark.parametrize("kw", [{}, {"max_error": 0.3}, {"masks": True}])
def test_associate_mutual(kw):
    _, _, s = _scores(2, 300, 260)
    rng = np.random.default_rng(2)
    jkw, tkw = dict(kw), dict(kw)
    if jkw.pop("masks", False):
        tkw.pop("masks")
        va, vb = rng.uniform(size=300) < 0.8, rng.uniform(size=260) < 0.8
        jkw.update(valid_a=jnp.asarray(va), valid_b=jnp.asarray(vb))
        tkw.update(valid_a=torch.from_numpy(va), valid_b=torch.from_numpy(vb))
    ref = ja.associate_mutual(jnp.asarray(s), **jkw)
    out = ta.associate_mutual(torch.from_numpy(s), **tkw)
    assert 50 < int(out.valid.sum()) < 300
    _same_matches(ref, out, 0)


def test_associate_mutual_ties_take_the_first():
    """Integer scores with whole rows and columns of equal minima."""
    s = np.random.default_rng(3).integers(0, 5, (60, 50)).astype(np.float32)
    s[10] = 1.0
    s[:, 7] = 0.0
    ref = ja.associate_mutual(jnp.asarray(s))
    out = ta.associate_mutual(torch.from_numpy(s))
    _same_matches(ref, out, 0)


@pytest.mark.parametrize("backwards", [True, False])
def test_associate_greedy(backwards):
    _, _, s = _scores(4)
    ref = ja.associate_greedy(jnp.asarray(s), max_error=0.4,
                              backwards=backwards)
    out = ta.associate_greedy(torch.from_numpy(s), max_error=0.4,
                              backwards=backwards)
    _same_matches(ref, out, 0)


def test_associate_ratio_test():
    _, _, s = _scores(5)
    ref = ja.associate_ratio_test(jnp.asarray(s), ratio=0.7, max_error=0.5)
    out = ta.associate_ratio_test(torch.from_numpy(s), ratio=0.7,
                                  max_error=0.5)
    assert 50 < int(out.valid.sum()) < 300
    _same_matches(ref, out, 0)


def test_associate_mutual_2d():
    _, _, s = _scores(6)
    rng = np.random.default_rng(6)
    xa = rng.uniform(0, 100, (300, 2)).astype(np.float32)
    xb = (xa[rng.permutation(300)] + rng.normal(0, 3, (300, 2))).astype(
        np.float32)
    ref = ja.associate_mutual_2d(jnp.asarray(s), jnp.asarray(xa),
                                 jnp.asarray(xb), 25.0)
    out = ta.associate_mutual_2d(torch.from_numpy(s), torch.from_numpy(xa),
                                 torch.from_numpy(xb), 25.0)
    assert 5 < int(out.valid.sum()) < 300
    _same_matches(ref, out, 0)


@pytest.mark.parametrize("tile,nb,masks", [(128, 300, False), (64, 257, True),
                                           (512, 300, False)])
def test_associate_mutual_tiled(tile, nb, masks):
    """Against the reference's tiled scan, and equal to the port's
    full-matrix association (a tile's block of the product has the full
    product's bits on the CPU)."""
    a, b = _descriptors(7, 300, nb)
    rng = np.random.default_rng(7)
    jkw, tkw = {}, {}
    if masks:
        va, vb = rng.uniform(size=300) < 0.8, rng.uniform(size=nb) < 0.8
        jkw = dict(valid_a=jnp.asarray(va), valid_b=jnp.asarray(vb))
        tkw = dict(valid_a=torch.from_numpy(va), valid_b=torch.from_numpy(vb))
    ref = ja.associate_mutual_tiled(jnp.asarray(a), jnp.asarray(b), tile=tile,
                                    max_error=0.5, **jkw)
    out = ta.associate_mutual_tiled(torch.from_numpy(a), torch.from_numpy(b),
                                    tile=tile, max_error=0.5, **tkw)
    _same_matches(ref, out)
    full = ta.associate_mutual(
        ta.score_euclidean_sq(torch.from_numpy(a), torch.from_numpy(b)),
        max_error=0.5, **tkw)
    assert torch.equal(out.dst[out.valid], full.dst[full.valid])
    assert torch.equal(out.valid, full.valid)
    np.testing.assert_allclose(out.score.numpy(), full.score.numpy(),
                               atol=1e-6)


def test_associate_three_by_pairs():
    a, b = _descriptors(8, 200, 200, noise=0.03)
    c = (b[np.random.default_rng(8).permutation(200)]
         + np.random.default_rng(9).normal(0, 0.03, b.shape)).astype(
        np.float32)
    ref = ja.associate_three_by_pairs(*(jnp.asarray(x) for x in (a, b, c)),
                                      max_error=0.5)
    out = ta.associate_three_by_pairs(*(torch.from_numpy(x)
                                        for x in (a, b, c)), max_error=0.5)
    assert 20 < int(out[3].sum()) <= 200
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("mutual", [True, False])
def test_associate_nearest_neighbor_kdtree(mutual):
    a, b = _descriptors(10, 150, 150)
    ref = ja.associate_nearest_neighbor_kdtree(a, b, max_error=0.5,
                                               mutual=mutual)
    out = ta.associate_nearest_neighbor_kdtree(
        torch.from_numpy(a), torch.from_numpy(b), max_error=0.5,
        mutual=mutual)
    _same_matches(ref, out, 0)
    again = ta.associate_nearest_neighbor_kdtree(a, b, max_error=0.5,
                                                 mutual=mutual, device="cpu")
    assert torch.equal(again.dst, out.dst) and again.dst.device.type == "cpu"
    # numpy descriptors and no device: the card, never the CPU by default
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ta.associate_nearest_neighbor_kdtree(a, b, mutual=mutual)
