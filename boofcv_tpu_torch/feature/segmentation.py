"""Image segmentation: SLIC superpixels, mean-shift, watershed and the
Felzenszwalb-Huttenlocher graph merge (port of
``boofcv_tpu/feature/segmentation.py``).

Reference analog: boofcv-feature alg/segmentation/ — slic/SegmentSlic.java,
fh04/SegmentFelzenszwalbHuttenlocher04.java,
watershed/WatershedVincentSoille1991.java, ms/SegmentMeanShift*.

SLIC and the mean-shift filter run on the device.  SLIC's pixel-to-centre
distances go through the pixels ``SLIC_CHUNK`` at a time, one colour or
coordinate component at a time, in the reference's order, so no
[HW, K, C+2] tensor is formed.  Watershed's relaxation fixpoint reads its
"changed" flag every ``WATERSHED_CHECK_EVERY`` trips of 8 relaxations.
The union-find merges run on the host in the native library
(``native.mean_shift_merge``, ``native.fh04_merge``), which raises when it
cannot be built or loaded; ``_merge_regions_python`` and
``_fh04_merge_numpy`` are the plain versions they are held against.
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch import native
from boofcv_tpu_torch._config import as_tensor
from boofcv_tpu_torch.ip import blur
from boofcv_tpu_torch.utils.unionfind import UnionFind

SLIC_CHUNK = 65536          # pixels a distance block
WATERSHED_CHECK_EVERY = 4   # trips (of 8 relaxations) between flag reads


def _slic_labels(fs, cs, chunk: int) -> list:
    """argmin over the centres of the scaled squared distance, for each
    chunk of pixels; the components summed in order."""
    labs = []
    for s in range(0, fs.shape[0], chunk):
        f = fs[s:s + chunk]
        dist = None
        for c in range(fs.shape[1]):
            d = f[:, c, None] - cs[None, :, c]
            dist = d * d if dist is None else dist + d * d
        labs.append(torch.argmin(dist, dim=1))
    return labs


def slic(image, num_segments: int = 100, compactness: float = 10.0,
         iterations: int = 10, device=None) -> torch.Tensor:
    """SLIC superpixels (SegmentSlic.java) of an [H, W] gray or [H, W, 3]
    colour image: int32 labels [H, W] in [0, num_segments).  Every pixel
    is compared with every centre (no 2S window), as in the reference; the
    centre update is the one-hot product ``onehot.T @ feats``."""
    img = as_tensor(image, torch.float32, device)
    if img.dim() == 2:
        img = img[..., None]
    h, w, c = img.shape
    dev = img.device
    s = int(np.sqrt(h * w / num_segments))
    cy, cx = torch.meshgrid(torch.arange(s // 2, h, s, device=dev),
                            torch.arange(s // 2, w, s, device=dev),
                            indexing="ij")
    cy = cy.reshape(-1)[:num_segments]
    cx = cx.reshape(-1)[:num_segments]
    k = cy.shape[0]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    feats = torch.cat([img.reshape(-1, c), ys.reshape(-1, 1),
                       xs.reshape(-1, 1)], dim=1)
    ratio = compactness / s
    centers = torch.cat([img[cy, cx].reshape(k, c),
                         torch.stack([cy.to(torch.float32),
                                      cx.to(torch.float32)], dim=1)], dim=1)
    scale = torch.cat([torch.ones(c, device=dev),
                       torch.full((2,), ratio, device=dev)])
    fs = feats * scale
    cluster = torch.arange(k, device=dev)
    for _ in range(iterations):
        labs = _slic_labels(fs, centers * scale, SLIC_CHUNK)
        sums = torch.zeros((k, c + 2), device=dev)
        counts = torch.zeros((k, 1), device=dev)
        for i, lab in enumerate(labs):
            onehot = (lab[:, None] == cluster).to(torch.float32)
            sums = sums + onehot.T @ feats[i * SLIC_CHUNK:
                                           i * SLIC_CHUNK + lab.shape[0]]
            counts = counts + torch.sum(onehot, dim=0)[:, None]
        centers = torch.where(counts > 0,
                              sums / torch.clamp(counts, min=1), centers)
    lab = torch.cat(_slic_labels(fs, centers * scale, SLIC_CHUNK))
    return lab.reshape(h, w).to(torch.int32)


def mean_shift_filter(image, spatial_radius: int = 3,
                      range_sigma: float = 15.0, iterations: int = 5,
                      device=None) -> torch.Tensor:
    """Edge-preserving mean-shift filtering (the smoothing stage of
    SegmentMeanShiftSearchGray): each pixel moves to the range-weighted
    mean of its (2r+1)^2 neighbours, which wrap at the border as the
    reference's ``jnp.roll`` does; a fixed count of iterations."""
    cur = as_tensor(image, torch.float32, device)
    r = spatial_radius
    for _ in range(iterations):
        num = torch.zeros_like(cur)
        den = torch.zeros_like(cur)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                nb = torch.roll(torch.roll(cur, dy, 0), dx, 1)
                wgt = torch.exp(-0.5 * ((nb - cur) / range_sigma) ** 2)
                num = num + wgt * nb
                den = den + wgt
        cur = num / den
    return cur


def _similar(flat: np.ndarray, merge_threshold: float):
    """The merge's similarity masks, float32 as the reference's loop
    compares: right[y, x] joins (y, x)-(y, x+1), down[y, x] (y, x)-(y+1, x)
    (the last column and row are never read)."""
    h, w = flat.shape
    right = np.zeros((h, w), bool)
    down = np.zeros((h, w), bool)
    right[:, :-1] = np.abs(flat[:, :-1] - flat[:, 1:]) < merge_threshold
    down[:-1, :] = np.abs(flat[:-1, :] - flat[1:, :]) < merge_threshold
    return right, down


def _labels_from_roots(roots: np.ndarray) -> np.ndarray:
    _, lab = np.unique(roots.ravel(), return_inverse=True)
    return lab.reshape(roots.shape).astype(np.int32)


def _merge_regions_python(filtered: np.ndarray,
                          merge_threshold: float) -> np.ndarray:
    """The plain version of the merge: the reference's Python loop over
    every pixel with :class:`UnionFind`."""
    h, w = filtered.shape
    right, down = _similar(filtered, merge_threshold)
    uf = UnionFind(h * w)
    for y in range(h):
        for x in range(w):
            i = y * w + x
            if x + 1 < w and right[y, x]:
                uf.union(i, i + 1)
            if y + 1 < h and down[y, x]:
                uf.union(i, i + w)
    return uf.labels().reshape(h, w).astype(np.int32)


def segment_mean_shift(image, spatial_radius: int = 3,
                       range_sigma: float = 15.0,
                       merge_threshold: float = 8.0,
                       min_region: int = 20, device=None):
    """Mean-shift segmentation (the SegmentMeanShift pipeline): the filter
    on the device, then the union-find merge of similar 4-neighbours on
    the host (native).  Returns (labels int32 [H, W] numpy, numbered as the
    reference numbers them, filtered image tensor)."""
    filtered = mean_shift_filter(image, spatial_radius, range_sigma,
                                 device=device)
    right, down = _similar(filtered.cpu().numpy(), merge_threshold)
    return (_labels_from_roots(native.mean_shift_merge(right, down)),
            filtered)


def _relax(lab, reach, img, lab0, reach0, big: float):
    """One relaxation of the minimax-path flood: every pixel takes a
    4-neighbour's label where the pass height through it is lower; the
    four directions in order, each on the result of the last."""
    best_lab, best_reach = lab, reach
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        nl = torch.roll(best_lab, (dy, dx), (0, 1))
        nr = torch.roll(best_reach, (dy, dx), (0, 1))
        # the lane that wrapped round the border never wins
        if dy == 1:
            nr[0, :] = big
        if dy == -1:
            nr[-1, :] = big
        if dx == 1:
            nr[:, 0] = big
        if dx == -1:
            nr[:, -1] = big
        cand = torch.maximum(nr, img)
        better = (nl > 0) & (cand < best_reach)
        best_lab = torch.where(better, nl, best_lab)
        best_reach = torch.where(better, cand, best_reach)
    seed = lab0 > 0
    best_lab = torch.where(seed, lab0, best_lab)
    best_reach = torch.where(seed, reach0, best_reach)
    return best_lab, best_reach, (best_lab != lab) | (best_reach != reach)


def _watershed(image, markers, device=None):
    """:func:`watershed` with its counts: (labels, the reference's trips of
    8 relaxations, the trips run, host reads of the flag)."""
    img = as_tensor(image, torch.float32, device)
    lab0 = as_tensor(markers, torch.int32, device).to(img.device)
    big = 3.4e38
    reach0 = torch.where(lab0 > 0, img, big)
    lab, reach = lab0, reach0
    run, reads = 0, 0
    while True:
        flags = []
        for _ in range(WATERSHED_CHECK_EVERY):
            changed = torch.zeros_like(lab0, dtype=torch.bool)
            for _ in range(8):
                lab, reach, ch = _relax(lab, reach, img, lab0, reach0, big)
                changed = changed | ch
            flags.append(torch.any(changed))
        flags = torch.stack(flags).tolist()
        reads += 1
        if not all(flags):
            # the reference stops after the first trip that changed nothing
            return lab, run + flags.index(False) + 1, run + len(flags), reads
        run += len(flags)


def watershed(image, markers, device=None) -> torch.Tensor:
    """Marker-controlled watershed (WatershedVincentSoille1991 analog):
    each pixel joins the seed reachable over the lowest pass height (the
    minimax-path flood, a fixpoint of parallel relaxations).  ``image``
    [H, W] heights, ``markers`` int32 [H, W] with 0 unlabeled.  Trips past
    the fixpoint change nothing, so the labels are the reference's."""
    return _watershed(image, markers, device)[0]


def fh04_edge_weights(image, sigma: float = 0.8, eight: bool = True,
                      device=None):
    """FH04 edge weights on the device: differences of the Gaussian-smoothed
    intensity (or colour, per channel) to the right / down (/ diagonal)
    neighbours, which wrap at the border as the reference's ``jnp.roll``.
    Returns (wr, wd, wdr, wdl) float32 [H, W] (wdr / wdl None for
    4-connectivity)."""
    img = as_tensor(image, torch.float32, device)
    if img.dim() == 2:
        img = img[..., None]
    sm = torch.stack([blur.gaussian(img[..., c], sigma=sigma)
                      for c in range(img.shape[-1])], dim=-1)

    def diff(shift_y, shift_x):
        rolled = torch.roll(sm, (-shift_y, -shift_x), (0, 1))
        return torch.sqrt(torch.sum((sm - rolled) ** 2, dim=-1))

    wr, wd = diff(0, 1), diff(1, 0)
    if not eight:
        return wr, wd, None, None
    return wr, wd, diff(1, 1), diff(1, -1)


def segment_fh04(image, k: float = 300.0, min_size: int = 20,
                 sigma: float = 0.8, eight: bool = True, device=None):
    """Felzenszwalb-Huttenlocher 2004 graph segmentation
    (SegmentFelzenszwalbHuttenlocher04.java:81): edge weights on the
    device, the sorted-edge union-find merge in the native library on the
    host.  Returns (labels int32 [H, W] numpy, count).  Raises when the
    native library cannot be built or loaded; nothing falls back."""
    ws = fh04_edge_weights(image, sigma=sigma, eight=eight, device=device)
    host = torch.stack([t for t in ws if t is not None]).cpu().numpy()
    wr, wd, wdr, wdl = list(host) + [None] * (4 - len(host))
    return native.fh04_merge(wr, wd, wdr, wdl, k=k, min_size=min_size)


def _fh04_merge_numpy(wr, wd, wdr, wdl, k, min_size):
    """The plain version of the native FH04 merge, in NumPy (the
    reference's fallback, which the port does not take)."""
    h, w = wr.shape
    n = h * w
    idx = np.arange(n).reshape(h, w)
    ea = [idx[:, :-1].ravel(), idx[:-1, :].ravel()]
    eb = [idx[:, 1:].ravel(), idx[1:, :].ravel()]
    ew = [wr[:, :-1].ravel(), wd[:-1, :].ravel()]
    if wdr is not None:
        ea += [idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()]
        eb += [idx[1:, 1:].ravel(), idx[1:, :-1].ravel()]
        ew += [wdr[:-1, :-1].ravel(), wdl[:-1, 1:].ravel()]
    ea = np.concatenate(ea)
    eb = np.concatenate(eb)
    ew = np.concatenate(ew)
    order = np.argsort(ew, kind="stable")
    uf = UnionFind(n)
    parent = uf.parent          # FH04 keeps its own size/threshold unions
    find = uf.find
    size = np.ones(n, np.int64)
    thresh = np.full(n, k, np.float64)
    for e in order:
        a, b, wgt = find(ea[e]), find(eb[e]), ew[e]
        if a == b:
            continue
        if wgt <= thresh[a] and wgt <= thresh[b]:
            if size[a] < size[b]:
                a, b = b, a
            parent[b] = a
            size[a] += size[b]
            thresh[a] = wgt + k / size[a]
    if min_size > 1:
        for e in order:
            a, b = find(ea[e]), find(eb[e])
            if a != b and (size[a] < min_size or size[b] < min_size):
                if size[a] < size[b]:
                    a, b = b, a
                parent[b] = a
                size[a] += size[b]
    labels = uf.labels()
    # renumber in raster order of first occurrence
    first = {}
    out = np.empty(n, np.int32)
    nxt = 0
    for i, r in enumerate(labels):
        if r not in first:
            first[r] = nxt
            nxt += 1
        out[i] = first[r]
    return out.reshape(h, w), nxt
