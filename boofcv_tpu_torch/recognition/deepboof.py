"""CNN image classifiers, DeepBoof's (port of
``boofcv_tpu/recognition/deepboof.py``).

Reference analog: boofcv-recognition deepboof/ImageClassifierVggCifar10.java
and ImageClassifierNiNImageNet.java: inference wrappers around a VGG-like
CIFAR-10 network and a Network-in-Network ImageNet network, with fixed
preprocessing (mean / std normalization).

Images are NHWC, as in the reference; the forward passes run
``F.conv2d`` / ``F.max_pool2d`` in NCHW inside (TF32 off, as the package
sets it) and flatten VGG's features in NHWC order, so the parameters keep
the reference's meaning.  A parameter dict holds the reference's keys;
convolution weights are OIHW here (the reference's are HWIO: ``save_params``
writes and ``params_from_numpy`` / ``load_params`` read that layout), fully
connected ones [in, out] in both.  Padding is TensorFlow's "SAME":
``ceil(n / stride)`` outputs, the odd pixel of padding after (NIN's 11x11
stride-4 convolution pads 3 before and 4 after at 224 and at 64 px).
Gradients come from autograd.  No pretrained weights exist here: the
networks run on random parameters.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from boofcv_tpu_torch._config import as_tensor, resolve_device

# conv3x3(64)x2-pool conv3x3(128)x2-pool conv3x3(256)x2-pool -> fc
VGG_CIFAR10_CHANNELS: Tuple[Tuple[int, ...], ...] = ((64, 64), (128, 128),
                                                     (256, 256))
CIFAR10_CLASSES = ("airplane", "automobile", "bird", "cat", "deer",
                   "dog", "frog", "horse", "ship", "truck")
_NIN_SIZES = (11, 5, 3)
_NIN_STRIDES = (4, 1, 1)


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) of TensorFlow's SAME padding along an axis of n."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          stride: int = 1) -> torch.Tensor:
    """SAME convolution of NCHW ``x`` with OIHW ``w``, plus the bias."""
    kh, kw = w.shape[-2:]
    (pt, pb), (pl, pr) = (_same_pads(x.shape[-2], kh, stride),
                          _same_pads(x.shape[-1], kw, stride))
    if pt == pb and pl == pr:
        return F.conv2d(x, w, b, stride=stride, padding=(pt, pl))
    return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, b, stride=stride)


def _nchw(images: torch.Tensor) -> torch.Tensor:
    """NHWC images as a contiguous float32 NCHW tensor.  (A permuted view
    would run the layers in channels-last memory, where the CPU's
    ``max_pool2d`` backward routes the gradient of tied windows otherwise
    than the reference: errors of 1e-2 seen in early layers' gradients.)"""
    return images.to(torch.float32).permute(0, 3, 1, 2).contiguous()


def _he_normal(generator, shape, fan_in, device) -> torch.Tensor:
    std = float(np.sqrt(2.0 / fan_in))
    return (torch.randn(shape, generator=generator,
                        device=generator.device) * std).to(device)


def _hwio_draw(generator, kh, kw, cin, cout, device) -> torch.Tensor:
    """He-normal weights drawn in the reference's HWIO shape, as OIHW."""
    w = _he_normal(generator, (kh, kw, cin, cout), kh * kw * cin, device)
    return w.permute(3, 2, 0, 1).contiguous()


def init_vgg_cifar10(generator: torch.Generator, num_classes: int = 10,
                     image_size: int = 32,
                     device=None) -> Dict[str, torch.Tensor]:
    """He-normal parameters drawn from ``generator`` (a stand-in until
    real weights are loaded with :func:`load_params`)."""
    dev = resolve_device(device)
    params = {}
    cin = 3
    for bi, block in enumerate(VGG_CIFAR10_CHANNELS):
        for ci, cout in enumerate(block):
            params[f"conv{bi}_{ci}_w"] = _hwio_draw(generator, 3, 3, cin,
                                                    cout, dev)
            params[f"conv{bi}_{ci}_b"] = torch.zeros(cout, device=dev)
            cin = cout
    feat = image_size // (2 ** len(VGG_CIFAR10_CHANNELS))
    fdim = feat * feat * cin
    params["fc0_w"] = _he_normal(generator, (fdim, 512), fdim, dev)
    params["fc0_b"] = torch.zeros(512, device=dev)
    params["fc1_w"] = _he_normal(generator, (512, num_classes), 512, dev)
    params["fc1_b"] = torch.zeros(num_classes, device=dev)
    return params


def vgg_cifar10_forward(params: Dict[str, torch.Tensor],
                        images: torch.Tensor) -> torch.Tensor:
    """Batched forward: images [N, H, W, 3] in [0, 1] -> logits [N, C]."""
    x = _nchw(images)
    for bi, block in enumerate(VGG_CIFAR10_CHANNELS):
        for ci, _ in enumerate(block):
            x = F.relu(_conv(x, params[f"conv{bi}_{ci}_w"],
                             params[f"conv{bi}_{ci}_b"]))
        x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)     # NHWC order
    x = F.relu(x @ params["fc0_w"] + params["fc0_b"])
    return x @ params["fc1_w"] + params["fc1_b"]


def init_nin(generator: torch.Generator, num_classes: int = 1000,
             channels: Sequence[int] = (96, 256, 384),
             device=None) -> Dict[str, torch.Tensor]:
    """Network-in-Network parameters (mlpconv blocks, global average
    pooling; ImageClassifierNiNImageNet's topology scaled by
    ``channels``), He-normal from ``generator``."""
    dev = resolve_device(device)
    params = {}
    cin = 3
    for bi, (cout, ks) in enumerate(zip(channels, _NIN_SIZES)):
        for ci, kk in enumerate((ks, 1, 1)):
            params[f"nin{bi}_{ci}_w"] = _hwio_draw(generator, kk, kk, cin,
                                                   cout, dev)
            params[f"nin{bi}_{ci}_b"] = torch.zeros(cout, device=dev)
            cin = cout
    params["head_w"] = _hwio_draw(generator, 1, 1, cin, num_classes, dev)
    params["head_b"] = torch.zeros(num_classes, device=dev)
    return params


def nin_forward(params: Dict[str, torch.Tensor], images: torch.Tensor,
                channels: Sequence[int] = (96, 256, 384)) -> torch.Tensor:
    """images [N, H, W, 3] -> logits through the mlpconv blocks (2x2 max
    pooling between them, VALID) and a global average pool."""
    x = _nchw(images)
    for bi, _ in enumerate(channels):
        for ci in range(3):
            st = _NIN_STRIDES[bi] if ci == 0 else 1
            x = F.relu(_conv(x, params[f"nin{bi}_{ci}_w"],
                             params[f"nin{bi}_{ci}_b"], st))
        if bi < len(channels) - 1:
            x = F.max_pool2d(x, 2, 2)
    x = _conv(x, params["head_w"], params["head_b"])
    return torch.mean(x, dim=(2, 3))


def params_from_numpy(d, device=None) -> Dict[str, torch.Tensor]:
    """Parameters from the reference's layout (a mapping of numpy or JAX
    arrays, or an ``np.load`` of its npz): HWIO convolution weights ->
    OIHW."""
    dev = resolve_device(device)
    out = {}
    for k in d.keys():
        a = torch.from_numpy(np.array(d[k], np.float32))
        out[k] = (a.permute(3, 2, 0, 1) if a.dim() == 4
                  else a).contiguous().to(dev)
    return out


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    """Write the reference's npz (its keys, HWIO convolution weights)."""
    out = {}
    for k, v in params.items():
        a = v.detach().cpu()
        out[k] = np.ascontiguousarray(
            (a.permute(2, 3, 1, 0) if a.dim() == 4 else a).numpy())
    np.savez_compressed(path, **out)


def load_params(path: str, device=None) -> Dict[str, torch.Tensor]:
    with np.load(path) as z:
        return params_from_numpy(z, device)


class ImageClassifierVggCifar10:
    """Host wrapper (ImageClassifierVggCifar10.java): parameters, per-channel
    normalization, ``classify`` -> the best class."""

    def __init__(self, params: Dict[str, torch.Tensor] | None = None,
                 mean=(0.4914, 0.4822, 0.4465),
                 std=(0.247, 0.243, 0.262), seed: int = 0, device=None):
        if params is None:
            params = init_vgg_cifar10(torch.Generator().manual_seed(seed),
                                      device=device)
        self.params = params
        dev = next(iter(params.values())).device
        self.mean = torch.tensor(mean, dtype=torch.float32, device=dev)
        self.std = torch.tensor(std, dtype=torch.float32, device=dev)

    def scores(self, image) -> np.ndarray:
        """Softmax scores [N, 10] of an image [32, 32, 3] (or a batch
        [N, 32, 32, 3]) in [0, 255] or [0, 1]: a maximum above 2 means
        [0, 255]."""
        x = as_tensor(image, torch.float32, self.mean.device)
        if x.dim() == 3:
            x = x[None]
        if float(torch.max(x)) > 2.0:
            x = x / 255.0
        x = (x - self.mean) / self.std
        with torch.no_grad():
            logits = vgg_cifar10_forward(self.params, x)
        return torch.softmax(logits, -1).cpu().numpy()

    def classify(self, image) -> int:
        return int(np.argmax(self.scores(image)[0]))
