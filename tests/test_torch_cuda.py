"""Tests that need the card.  They skip without a CUDA device; on the card,
where JAX is absent, run them without the JAX conftest:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.feature import klt
from boofcv_tpu_torch.io import simulate
from boofcv_tpu_torch.ip import pyramid_ops
from boofcv_tpu_torch.kernels import window_gather as wg

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_kernel_matches_plain_version(cuda):
    """The CUDA kernel equals the plain version bit for bit, at the KLT and
    sparse-SAD shapes and with origins far outside the image."""
    g = torch.Generator().manual_seed(0)
    for h, w, n, wy, wx in ((480, 640, 512, 24, 16), (37, 53, 100, 7, 102),
                            (15, 20, 64, 24, 16), (480, 640, 512, 7, 7)):
        img = torch.rand((h, w), generator=g).to(cuda)
        oy = torch.randint(-110, h + 10, (n,), generator=g,
                           dtype=torch.int32).to(cuda)
        ox = torch.randint(-110, w + 10, (n,), generator=g,
                           dtype=torch.int32).to(cuda)
        before = wg.launch_count()
        out = wg.gather_windows(img, oy, ox, wy, wx)
        torch.cuda.synchronize()
        assert wg.launch_count() == before + 1
        assert torch.equal(out, wg.gather_windows_reference(img, oy, ox,
                                                             wy, wx))


def test_kernel_rejects_bad_inputs(cuda):
    img = torch.zeros((8, 8), device=cuda)
    o32 = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        wg.gather_windows(img, o32.long(), o32, 4, 4)
    with pytest.raises(ValueError):
        wg.gather_windows(img.double(), o32, o32, 4, 4)
    with pytest.raises(ValueError):
        wg.gather_windows(img.t(), o32, o32, 4, 4)
    with pytest.raises(ValueError):
        wg.gather_windows(img, o32.cpu(), o32, 4, 4)


def test_klt_on_card_matches_cpu(cuda):
    """The same KLT pass on the card (through the kernel) and on the CPU
    (through the plain version): positions to 1e-3 px, faults equal."""
    tex = simulate.noise_texture(np.random.default_rng(3), size=256)
    f0 = torch.from_numpy(tex[40:168, 50:210].copy())
    f1 = torch.from_numpy(tex[42:170, 47:207].copy())
    rng = np.random.default_rng(1)
    ys = torch.from_numpy(rng.uniform(2, 125, 256).astype(np.float32))
    xs = torch.from_numpy(rng.uniform(2, 157, 256).astype(np.float32))
    scales = (1, 2, 4)
    out = {}
    for dev in ("cpu", cuda):
        p0 = pyramid_ops.pyramid_average(f0.to(dev), PyramidConfig(scales))
        p1 = pyramid_ops.pyramid_average(f1.to(dev), PyramidConfig(scales))
        tm = klt.sample_templates(p0, pyramid_ops.gradient(p0), ys.to(dev),
                                  xs.to(dev), scales, 3)
        out[str(dev)] = [t.cpu() for t in klt.track_pyramid(
            p1, tm, ys.to(dev), xs.to(dev), scales, klt.KltConfig())]
    (cy, cx, cf), (gy, gx, gf) = out["cpu"], out[str(cuda)]
    assert torch.equal(cf, gf)
    assert float((cy - gy).abs().max()) < 1e-3
    assert float((cx - gx).abs().max()) < 1e-3
