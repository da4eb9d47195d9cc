"""Horn-Schunck dense flow: the port against the JAX package on the same
numpy inputs, on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.feature import flow as jf
from boofcv_tpu_torch.feature import flow as tf

torch.set_num_threads(1)


def _pair(seed, h=48, w=64, shift=(1, 2)):
    """Integer-valued smooth texture and the same moved by ``shift`` px."""
    rng = np.random.default_rng(seed)
    big = rng.normal(0, 1, (h + 16, w + 16))
    k = np.hanning(9)
    k /= k.sum()
    big = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, big)
    big = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, big)
    big = np.round(120 + 60 * big / big.std()).astype(np.float32)
    dy, dx = shift
    return (big[8:8 + h, 8:8 + w].copy(),
            big[8 - dy:8 - dy + h, 8 - dx:8 - dx + w].copy())


def _close(ref, out, atol):
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("dy,dx", [(0, 1), (1, 0), (-1, -1), (1, -1)])
def test_shift_edge_exact(dy, dx):
    f = _pair(0)[0]
    np.testing.assert_array_equal(
        tf._shift_edge(torch.from_numpy(f), dy, dx).numpy(),
        np.asarray(jf._shift_edge(jnp.asarray(f), dy, dx)))


def test_gradients_and_average():
    """Differences and sums of integers in the reference's order: 1e-5
    (exact up to the products by 0.5, 1/6 and 1/12)."""
    i1, i2 = _pair(1)
    ref = jf._gradients_hs(jnp.asarray(i1), jnp.asarray(i2))
    out = tf._gradients_hs(torch.from_numpy(i1), torch.from_numpy(i2))
    for r, o in zip(ref, out):
        _close(r, o, 1e-5)
    _close(jf._laplacian_avg(jnp.asarray(i1)),
           tf._laplacian_avg(torch.from_numpy(i1)), 1e-4)


@pytest.mark.parametrize("alpha", [20.0, 5.0])
def test_horn_schunck_20_iterations(alpha):
    """Flow after 20 iterations to 1e-4 px."""
    i1, i2 = _pair(2, 96, 128)
    ru, rv = jf.horn_schunck(jnp.asarray(i1), jnp.asarray(i2), alpha=alpha,
                             iterations=20)
    tu, tv = tf.horn_schunck(torch.from_numpy(i1), torch.from_numpy(i2),
                             alpha=alpha, iterations=20)
    assert float(np.abs(np.asarray(ru)).max()) > 0.05
    _close(ru, tu, 1e-4)
    _close(rv, tv, 1e-4)


def test_horn_schunck_init_flow_and_integer_images():
    i1, i2 = _pair(3)
    u0 = np.full(i1.shape, 0.5, np.float32)
    v0 = np.full(i1.shape, -0.25, np.float32)
    ru, rv = jf.horn_schunck(jnp.asarray(i1.astype(np.uint8)),
                             jnp.asarray(i2.astype(np.uint8)), iterations=5,
                             init_flow=(jnp.asarray(u0), jnp.asarray(v0)))
    tu, tv = tf.horn_schunck(torch.from_numpy(i1.astype(np.uint8)),
                             torch.from_numpy(i2.astype(np.uint8)),
                             iterations=5, init_flow=(torch.from_numpy(u0),
                                                      torch.from_numpy(v0)))
    _close(ru, tu, 1e-4)
    _close(rv, tv, 1e-4)


def test_warp_image():
    i1, _ = _pair(4)
    rng = np.random.default_rng(4)
    u = rng.uniform(-3, 3, i1.shape).astype(np.float32)
    v = rng.uniform(-3, 3, i1.shape).astype(np.float32)
    _close(jf._warp_image(*(jnp.asarray(a) for a in (i1, u, v))),
           tf._warp_image(*(torch.from_numpy(a) for a in (i1, u, v))), 1e-4)


@pytest.mark.parametrize("h,w,scales", [(96, 128, (1, 2, 4)),
                                        (50, 70, (1, 2))])
def test_horn_schunck_pyramid(h, w, scales):
    """Coarse to fine with warping, to 1e-3 px; the flow found is the
    shift."""
    i1, i2 = _pair(5, h, w, shift=(2, 3))
    ru, rv = jf.horn_schunck_pyramid(jnp.asarray(i1), jnp.asarray(i2),
                                     iterations=15, scales=scales)
    tu, tv = tf.horn_schunck_pyramid(torch.from_numpy(i1),
                                     torch.from_numpy(i2), iterations=15,
                                     scales=scales)
    _close(ru, tu, 1e-3)
    _close(rv, tv, 1e-3)
    c = np.s_[12:-12, 12:-12]
    assert abs(float(tu.numpy()[c].mean()) - 3.0) < 1.5
    assert abs(float(tv.numpy()[c].mean()) - 2.0) < 1.5


# ---------------------------------------------------------------------------
# The rest of the module: gradients, box sums, Brox warping, dense KLT,
# block flow (f32 flow to 1e-4 px unless stated)
# ---------------------------------------------------------------------------

def test_image_grad_and_box_filter():
    i1, _ = _pair(6)
    for r, o in zip(jf._image_grad(jnp.asarray(i1)),
                    tf._image_grad(torch.from_numpy(i1))):
        _close(r, o, 0)
    f = np.round(np.random.default_rng(6).uniform(0, 50, (40, 56))).astype(
        np.float32)
    for rad in (1, 3):          # integer sums below 2^24: exact
        _close(jf._box_filter(jnp.asarray(f), rad),
               tf._box_filter(torch.from_numpy(f), rad), 0)


def test_brox_warping():
    """Two levels, 2 outer x 10 inner iterations: 1e-4 px.  The smoothness
    term wraps at the borders in both (``roll``), so the whole field
    agrees, borders too."""
    i1, i2 = _pair(7, 64, 96, shift=(1, 2))
    kw = dict(scales=(1, 2), outer_iterations=2, inner_iterations=10)
    ru, rv = jf.brox_warping(jnp.asarray(i1), jnp.asarray(i2), **kw)
    tu, tv = tf.brox_warping(torch.from_numpy(i1), torch.from_numpy(i2), **kw)
    _close(ru, tu, 1e-4)
    _close(rv, tv, 1e-4)
    c = np.s_[10:-10, 10:-10]
    assert abs(float(tu.numpy()[c].mean()) - 2.0) < 0.5


def test_dense_klt():
    """Per-pixel GN with the stop rules: 1e-4 px where both say valid, the
    valid masks equal."""
    i1, i2 = _pair(8, 64, 96, shift=(2, -1))
    ru, rv, rok = jf.dense_klt(jnp.asarray(i1), jnp.asarray(i2),
                               scales=(1, 2), iterations=6)
    tu, tv, tok = tf.dense_klt(torch.from_numpy(i1), torch.from_numpy(i2),
                               scales=(1, 2), iterations=6)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(rok))
    _close(ru, tu, 1e-4)
    _close(rv, tv, 1e-4)
    c = np.s_[10:-10, 10:-10]
    assert abs(float(np.median(tu.numpy()[c])) + 1.0) < 0.1


def test_block_flow():
    """Integer images: SADs are whole numbers, exact where no 1e6 sentinel
    is in the window (the f32 prefix sums beside it round with the order of
    the scan), and the flow equal there."""
    i1, i2 = _pair(9, 48, 64, shift=(1, -2))
    ru, rv, rs = jf.block_flow(jnp.asarray(i1), jnp.asarray(i2),
                               search_radius=3, region_radius=2)
    tu, tv, ts = tf.block_flow(torch.from_numpy(i1), torch.from_numpy(i2),
                               search_radius=3, region_radius=2)
    m = 3 + 2                    # search radius + region radius
    c = np.s_[m:-m, m:-m]
    np.testing.assert_array_equal(ts.numpy()[c], np.asarray(rs)[c])
    np.testing.assert_array_equal(tu.numpy()[c], np.asarray(ru)[c])
    np.testing.assert_array_equal(tv.numpy()[c], np.asarray(rv)[c])
    assert (tu.numpy()[c] == -2).mean() > 0.9
