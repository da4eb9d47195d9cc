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
