"""Scene classification with a bag of visual words and a kNN classifier
(port of ``boofcv_tpu/examples/classify_scene_knn.py``).

Reference analog: examples/recognition/ExampleClassifySceneKnn.java —
dense features -> k-means vocabulary -> word histograms -> kNN.  Three
synthetic texture classes (smooth, stripes, checkers) are learned from 18
training images; 12 held-out views must be classified at least 80 % right
(the JAX example's oracle).  The k-means starts from rows drawn by a
seeded ``torch.Generator``.

    python -m boofcv_tpu_torch.examples.classify_scene_knn [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import dense
from boofcv_tpu_torch.recognition import scene


def texture(rng, kind, n=64):
    """A smooth gradient (0), stripes (1) or checkers (2), n x n."""
    yy, xx = np.mgrid[0:n, 0:n]
    if kind == 0:
        img = 0.8 * xx + 0.4 * yy + rng.normal(0, 2, (n, n))
    elif kind == 1:
        img = 120 + 90 * np.sin(xx * (0.5 + 0.1 * rng.random()))
    else:
        s = rng.integers(6, 9)
        img = 120 + 90 * (((yy // s) + (xx // s)) % 2) \
            + rng.normal(0, 3, (n, n))
    return img.astype(np.float32)


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    rng = np.random.default_rng(19)

    def feats(img):
        return dense.dense_sift(img, cell=8, step=8, device=dev)[2]

    train_sets, train_labels = [], []
    for kind in range(3):
        for _ in range(6):
            train_sets.append(feats(texture(rng, kind)))
            train_labels.append(kind)
    clf = scene.train_bow(torch.Generator().manual_seed(0), train_sets,
                          train_labels, vocab_size=24, device=dev)

    correct = total = 0
    for kind in range(3):
        for _ in range(4):
            pred = scene.classify_bow(clf, feats(texture(rng, kind)))
            correct += int(pred == kind)
            total += 1
    print(f"device: {dev}")
    print(f"held-out accuracy: {correct}/{total}")
    ok = correct >= int(0.8 * total)
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
