"""Window gather: the port's plain version against the JAX package's
``gather_windows`` (its XLA path on the CPU), bit for bit, inside the JAX
kernel's documented contract; and the CUDA entry's refusal to run without
a card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.kernels import window_gather as jwg
from boofcv_tpu_torch.kernels import window_gather as twg

torch.set_num_threads(1)


def _image(rng, h, w):
    return rng.uniform(0, 255, (h, w)).astype(np.float32)


@pytest.mark.parametrize("h,w", [(37, 53), (120, 160), (15, 20), (60, 80)])
def test_klt_shape_matches_jax(h, w):
    rng = np.random.default_rng(h * 1000 + w)
    img = _image(rng, h, w)
    n = 128
    # centres across the image, some near or past the borders
    cy = rng.uniform(-4, h + 4, n).astype(np.float32)
    cx = rng.uniform(-4, w + 4, n).astype(np.float32)
    oy, ox, py0, px0 = jwg.aligned_window_origin(
        jnp.asarray(cy), jnp.asarray(cx), 3, h, w, 24, 16)
    toy, tox, tpy0, tpx0 = twg.aligned_window_origin(
        torch.from_numpy(cy), torch.from_numpy(cx), 3, h, w, 24, 16)
    assert np.array_equal(np.asarray(oy), toy.numpy())
    assert np.array_equal(np.asarray(ox), tox.numpy())
    assert np.array_equal(np.asarray(py0), tpy0.numpy())
    assert np.array_equal(np.asarray(px0), tpx0.numpy())
    ref = np.asarray(jwg.gather_windows(jnp.asarray(img), oy, ox, 24, 16))
    out = twg.gather_windows(torch.from_numpy(img), toy, tox, 24, 16)
    assert out.shape == (n, 24, 16)
    assert np.array_equal(ref, out.numpy())          # bit-equal


@pytest.mark.parametrize("h,w,n_disp,rx", [(37, 53, 32, 3), (120, 160, 48, 3),
                                           (120, 160, 96, 3), (61, 97, 16, 2)])
def test_sad_shapes_match_jax(h, w, n_disp, rx):
    """Right strip (wx = n_disp + 2rx) and left patch (wx = 2rx + 1) with
    ox down to -pad_left and rows past h up to pad_bottom."""
    rng = np.random.default_rng(7 + h + n_disp)
    img = _image(rng, h, w)
    n = 96
    for wx, pad_left in ((n_disp + 2 * rx, n_disp + 2 * rx), (2 * rx + 1,
                                                              rx + 1)):
        oy = (rng.integers(0, h, n) // 8 * 8).astype(np.int32)
        ox = rng.integers(-pad_left, max(w - wx, 1), n).astype(np.int32)
        ox[:4] = -pad_left                           # the extremes
        oy[:4] = (h - 1) // 8 * 8
        ref = np.asarray(jwg.gather_windows(
            jnp.asarray(img), jnp.asarray(oy), jnp.asarray(ox), wy=16, wx=wx,
            pad_left=pad_left, pad_bottom=16))
        out = twg.gather_windows(torch.from_numpy(img), torch.from_numpy(oy),
                                 torch.from_numpy(ox), 16, wx)
        assert np.array_equal(ref, out.numpy())      # bit-equal


def test_cpu_tensor_takes_plain_version_without_counting():
    img = torch.arange(12.0).reshape(3, 4)
    oy = torch.tensor([-1, 2], dtype=torch.int32)
    ox = torch.tensor([-2, 3], dtype=torch.int32)
    before = twg.launch_count()
    out = twg.gather_windows(img, oy, ox, 2, 3)
    assert twg.launch_count() == before
    expect = torch.tensor([[[0., 0., 0.], [0., 0., 0.]],
                           [[11., 11., 11.], [11., 11., 11.]]])
    assert torch.equal(out, expect)


def test_cuda_entry_refuses_cpu_tensors():
    """No silent CPU fallback: the kernel's entry raises off the card."""
    img = torch.zeros((8, 8))
    o = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        twg.gather_windows_cuda(img, o, o, 4, 4)
