"""Bag-of-visual-words scene classification (port of
``boofcv_tpu/recognition/scene.py``).

Reference analog: boofcv-recognition alg/scene/ —
ClassifierKNearestNeighborsBow.java, FeatureToWordHistogram_F64.java, with
k-means from boofcv-learning (alg/bow/ClusterVisualWords).

k-means assigns with one [N, K] distance matmul (float32, TF32 off) and
updates with a one-hot matmul, as the reference does; histograms count
with an integer-valued ``index_add_`` (exact in any order, no host sync).
The reference seeds k-means with ``jax.random.choice``, which the port
cannot reproduce: ``kmeans`` and ``train_bow`` take the initial indices
(``init_idx``) for parity, or draw them from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from boofcv_tpu_torch._config import as_tensor, resolve_device


def _sq_distances(f: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[N, K] ||f - v||^2 as ||f||^2 - 2 f.v + ||v||^2."""
    return (torch.sum(f * f, 1)[:, None] - 2.0 * f @ v.T
            + torch.sum(v * v, 1)[None, :])


def kmeans(generator: Optional[torch.Generator], points, k: int,
           iterations: int = 25, init_idx=None, device=None) -> torch.Tensor:
    """Plain k-means (ClusterVisualWords analog) of points [N, D]: the
    centres start at ``init_idx`` [k] (distinct rows of ``points``) or at
    k distinct rows drawn by ``generator``; ``iterations`` fixed steps; a
    centre that loses every point stays.  Returns [k, D] float32."""
    pts = as_tensor(points, torch.float32, device)
    n = pts.shape[0]
    if init_idx is None:
        if generator is None:
            raise ValueError("kmeans needs init_idx or a torch.Generator")
        init_idx = torch.randperm(n, generator=generator,
                                  device=generator.device)[:k]
    if not isinstance(init_idx, torch.Tensor):
        init_idx = torch.from_numpy(np.array(init_idx, np.int64))
    idx = init_idx.to(device=pts.device, dtype=torch.long)
    centers = pts[idx]
    for _ in range(iterations):
        lab = torch.argmin(_sq_distances(pts, centers), dim=1)
        onehot = torch.nn.functional.one_hot(lab, k).to(torch.float32)
        sums = onehot.T @ pts
        counts = torch.sum(onehot, 0)[:, None]
        centers = torch.where(counts > 0,
                              sums / torch.clamp(counts, min=1.0), centers)
    return centers


def assign_words(features, vocabulary) -> torch.Tensor:
    """[N] nearest word of each feature (one matmul); ties go to the lower
    index."""
    v = as_tensor(vocabulary, torch.float32)
    f = as_tensor(features, torch.float32, v.device)
    return torch.argmin(_sq_distances(f, v), dim=1)


def word_histogram(features, vocabulary, normalize: bool = True):
    """BOW histogram (FeatureToWordHistogram) of one image's features."""
    v = as_tensor(vocabulary, torch.float32)
    words = assign_words(features, v)
    hist = torch.zeros(v.shape[0], dtype=torch.float32, device=v.device)
    hist.index_add_(0, words, torch.ones_like(words, dtype=torch.float32))
    if normalize:
        hist = hist / torch.clamp(torch.sum(hist), min=1.0)
    return hist


class BowClassifier(NamedTuple):
    """kNN over training histograms (ClassifierKNearestNeighborsBow)."""
    vocabulary: torch.Tensor     # [K, D]
    train_hists: torch.Tensor    # [M, K]
    train_labels: torch.Tensor   # [M] int32
    num_neighbors: int


def train_bow(generator: Optional[torch.Generator], feature_sets, labels,
              vocab_size: int = 64, num_neighbors: int = 5, init_idx=None,
              device=None) -> BowClassifier:
    """A vocabulary by k-means over every image's descriptors
    (``feature_sets``: a list of [Ni, D], one an image), then one histogram
    an image.  ``init_idx`` / ``generator`` seed the k-means as in
    :func:`kmeans`."""
    dev = resolve_device(device)
    sets = [as_tensor(f, torch.float32, dev) for f in feature_sets]
    vocab = kmeans(generator, torch.cat(sets, 0), vocab_size,
                   init_idx=init_idx)
    hists = torch.stack([word_histogram(f, vocab) for f in sets])
    return BowClassifier(vocab, hists, torch.as_tensor(
        labels, dtype=torch.int32).to(dev), num_neighbors)


def classify_bow(clf: BowClassifier, features) -> int:
    """The label of one image's descriptor set: a vote of the
    ``num_neighbors`` nearest training histograms (a stable sort, so equal
    distances keep the training order; a tied vote goes to the lower
    label)."""
    h = word_histogram(features, clf.vocabulary)
    d = torch.sum((clf.train_hists - h[None, :]) ** 2, dim=1)
    nn = torch.argsort(d, stable=True)[:clf.num_neighbors]
    votes = clf.train_labels[nn].long()
    n_labels = int(torch.max(clf.train_labels)) + 1
    counts = torch.zeros(n_labels, dtype=torch.float32, device=d.device)
    counts.index_add_(0, votes, torch.ones_like(votes, dtype=torch.float32))
    return int(torch.argmax(counts))


def classifier_from_numpy(d, device=None) -> BowClassifier:
    """A classifier from another's arrays: ``d`` maps ``vocabulary``,
    ``train_hists``, ``train_labels`` and ``num_neighbors`` (the
    reference's ``BowClassifier._asdict()`` gives such a mapping)."""
    dev = resolve_device(device)
    arr = lambda k, dt: torch.as_tensor(np.array(d[k]), dtype=dt,
                                        device=dev)
    return BowClassifier(arr("vocabulary", torch.float32),
                         arr("train_hists", torch.float32),
                         arr("train_labels", torch.int32),
                         int(d["num_neighbors"]))
