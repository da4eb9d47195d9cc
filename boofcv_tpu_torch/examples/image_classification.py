"""CNN image classification with the DeepBoof VGG-CIFAR10 wrapper (port of
``boofcv_tpu/examples/image_classification.py``).

Reference analog: examples/recognition/ExampleImageClassification.java.
No pretrained weights exist here, so the oracle is the classic sanity
check (the JAX example's): overfit the network by 150 SGD steps (autograd)
on 8 random images of 4 classes, then classify them back 100 % right, and
the wrapper must classify image 2 (in 0-255) as its label.

    python -m boofcv_tpu_torch.examples.image_classification [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.recognition import deepboof


def overfit(params, x, y, steps: int = 150, lr: float = 0.003):
    """``steps`` plain SGD steps on the mean cross-entropy of the VGG
    logits; returns (params, the last step's loss)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    for _ in range(steps):
        logits = deepboof.vgg_cifar10_forward(params, x)
        loss = torch.nn.functional.cross_entropy(logits, y)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p -= lr * g
    return {k: v.detach() for k, v in params.items()}, loss.detach()


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    rng = np.random.default_rng(0)
    n_cls = 4
    imgs = rng.uniform(0, 1, (n_cls * 2, 32, 32, 3)).astype(np.float32)
    labels = np.arange(n_cls * 2) % n_cls

    params = deepboof.init_vgg_cifar10(torch.Generator().manual_seed(0),
                                       num_classes=n_cls, device=dev)
    x = torch.as_tensor(imgs, device=dev)
    y = torch.as_tensor(labels, device=dev)
    params, loss = overfit(params, x, y)
    with torch.no_grad():
        pred = torch.argmax(deepboof.vgg_cifar10_forward(params, x),
                            -1).cpu().numpy()
    acc = (pred == labels).mean()
    print(f"device: {dev}")
    print(f"VGG-CIFAR10 overfit: loss {float(loss):.3f}, train acc "
          f"{acc:.0%} on {len(labels)} images / {n_cls} classes")

    clf = deepboof.ImageClassifierVggCifar10(params)
    one = clf.classify(imgs[2] * 255.0)
    print(f"wrapper classify(image 2) = {one} (label {labels[2]})")
    ok = acc == 1.0 and one == labels[2]
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
