"""Canny edge detection (port of ``boofcv_tpu/feature/canny.py``, whole).

Reference analog: boofcv-feature alg/feature/detect/edge/CannyEdge.java:45
(blur -> gradient -> direction-discretized non-max -> hysteresis),
GradientToEdgeFeatures.java, HysteresisEdgeTraceMark.java:37 and
HysteresisEdgeTracePoints.java.

Hysteresis keeps the reference's fixpoint: strong seeds dilate through the
weak mask, 8 sweeps a trip, until a trip changes nothing.  The reference's
``lax.while_loop`` on ``any(cur != prev)`` becomes a Python loop whose
condition is read on the host: one host sync a trip (and one for the test
that ends it).  A sweep is a 3x3 max-pool of the 0/1 mask and a product
with the weak mask.  Edge chains (``edge_contours``) are a host finisher in
numpy and ``scipy.ndimage.label``, as in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from boofcv_tpu_torch._config import as_tensor
from boofcv_tpu_torch.ip import blur as ip_blur
from boofcv_tpu_torch.ip import derivative

HYSTERESIS_SWEEPS = 8          # dilation sweeps between two host tests


def discretize_direction4(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """GradientToEdgeFeatures.discretizeDirection4: the gradient angle
    folded to [0, pi) in 4 sectors: 0 horizontal gradient, 1 45 deg, 2
    vertical, 3 135 deg."""
    theta = torch.arctan2(dy, dx)
    theta = torch.where(theta < 0, theta + math.pi, theta)
    sector = torch.floor((theta + math.pi / 8) / (math.pi / 4)).to(
        torch.int32)
    return torch.remainder(sector, 4)


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img at (y+dy, x+dx), zero outside (off-image neighbours read 0)."""
    h, w = img.shape
    p = F.pad(img, (1, 1, 1, 1))
    return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def nonmax_direction4(intensity: torch.Tensor,
                      direction: torch.Tensor) -> torch.Tensor:
    """Non-maximum suppression along the discretized gradient direction: a
    pixel survives iff it is > its negative-direction neighbour and >= its
    positive one (the strict side keeps a symmetric step one pixel thin)."""
    pairs = [((0, -1), (0, 1)),    # sector 0: horizontal gradient
             ((-1, -1), (1, 1)),   # sector 1: 45 deg, the NW/SE diagonal
             ((-1, 0), (1, 0)),    # sector 2: vertical
             ((-1, 1), (1, -1))]   # sector 3: 135 deg, the NE/SW diagonal
    keep = torch.zeros(intensity.shape, dtype=torch.bool,
                       device=intensity.device)
    for s, (a, b) in enumerate(pairs):
        ok = (intensity > _shift(intensity, *a)) & (intensity
                                                    >= _shift(intensity, *b))
        keep = torch.where(direction == s, ok, keep)
    return torch.where(keep, intensity, 0.0)


def _dilate8_masked(mask: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """One 8-connected dilation of a 0/1 float mask, kept inside ``weak``
    (0/1 float)."""
    grown = F.max_pool2d(mask[None, None], 3, stride=1, padding=1)[0, 0]
    return grown * weak


def _hysteresis(nms: torch.Tensor, low, high):
    """(the hysteresis mask [H, W] uint8, trips of the fixpoint loop)."""
    weak = (nms >= low).to(torch.float32)
    strong = (nms >= high).to(torch.float32)
    cur = torch.maximum(_dilate8_masked(strong, weak), strong)
    prev = strong
    trips = 0
    while bool(torch.any(cur != prev)):        # one host sync a test
        prev = cur
        for _ in range(HYSTERESIS_SWEEPS):
            cur = _dilate8_masked(cur, weak)
        trips += 1
    return cur.to(torch.uint8), trips


def hysteresis(nms: torch.Tensor, low, high) -> torch.Tensor:
    """Double threshold + connectivity: pixels >= high seed; pixels >= low
    are kept iff 8-connected through other weak pixels to a seed.  A
    sequential flood fill in the reference's Java; here the fixpoint of
    masked dilation.  Returns the [H, W] uint8 mask."""
    return _hysteresis(nms, low, high)[0]


def _nms(image, sigma: float, radius: int) -> torch.Tensor:
    blurred = ip_blur.gaussian(image.to(torch.float32), sigma=sigma,
                               radius=radius)
    dx, dy = derivative.sobel(blurred)
    return nonmax_direction4(torch.hypot(dx, dy),
                             discretize_direction4(dx, dy))


def canny(image, low: float, high: float, sigma: float = -1.0,
          radius: int = 2, relative: bool = False,
          device=None) -> torch.Tensor:
    """CannyEdge.process: the binary edge mask [H, W] uint8.  Intensity is
    the Euclidean gradient norm (GradientToEdgeFeatures.intensityE).
    ``relative``: low and high are fractions of the largest edge intensity,
    floored at 1e-4 of the image range so that a featureless frame gives an
    empty mask rather than noise (tensors: no host sync).  A numpy image
    goes to ``device`` (default the card)."""
    image = as_tensor(image, torch.float32, device)
    nms = _nms(image, sigma, radius)
    if relative:
        floor = 1e-4 * (1.0 + torch.amax(torch.abs(image)))
        m = torch.amax(nms)
        low, high = (torch.maximum(low * m, floor),
                     torch.maximum(high * m, floor))
    return hysteresis(nms, low, high)


def edge_contours(mask) -> list[np.ndarray]:
    """HysteresisEdgeTracePoints analog on the host: the edge mask grouped
    into 8-connected chains, each ordered by walking from an endpoint.

    Every round seeds one walker per 8-connected component of the pixels
    not yet claimed (an endpoint preferred) and advances all walkers one
    step per numpy iteration, each claiming its first unvisited neighbour
    (4-connected directions first, as the sequential tracer).  Leftover
    pixels (branches past junctions, loops) seed further rounds.

    Returns a list of [K, 2] (x, y) int32 arrays covering every edge pixel
    once, consecutive entries 8-adjacent."""
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    m = np.asarray(mask) > 0
    h, w = m.shape
    ys, xs = np.nonzero(m)
    n = len(ys)
    if n == 0:
        return []
    idx = np.full((h, w), -1, np.int32)
    idx[ys, xs] = np.arange(n, dtype=np.int32)
    offs = [(0, -1), (0, 1), (-1, 0), (1, 0),
            (-1, -1), (-1, 1), (1, -1), (1, 1)]
    p = np.full((h + 2, w + 2), -1, np.int32)
    p[1:-1, 1:-1] = idx
    nbr = np.stack([p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w][ys, xs]
                    for dy, dx in offs], axis=1)            # [N, 8]

    visited = np.zeros(n, bool)
    chain_of = np.empty(n, np.int64)
    step_of = np.empty(n, np.int64)
    next_chain = 0

    def run_walkers(starts):
        nonlocal next_chain
        cur = starts
        cid = next_chain + np.arange(len(starts))
        next_chain += len(starts)
        visited[cur] = True
        chain_of[cur] = cid
        step_of[cur] = 0
        step = 1
        while len(cur):
            cand = nbr[cur]                                  # [A, 8]
            ok = (cand >= 0) & ~visited[np.clip(cand, 0, n - 1)]
            any_ok = ok.any(1)
            cur, cid = cur[any_ok], cid[any_ok]
            if not len(cur):
                break
            pick = ok[any_ok].argmax(1)
            # one walker per component: two can never claim one pixel
            cur = cand[any_ok, pick]
            visited[cur] = True
            chain_of[cur] = cid
            step_of[cur] = step
            step += 1

    from scipy import ndimage as ndi
    eight = np.ones((3, 3), bool)
    while not visited.all():
        rem = np.zeros((h, w), bool)
        rem[ys[~visited], xs[~visited]] = True
        comp, _ = ndi.label(rem, structure=eight)
        comp_of = comp[ys, xs]                               # 0 if visited
        rem_deg = (nbr >= 0) & ~visited[np.clip(nbr, 0, n - 1)]
        rem_deg = rem_deg.sum(1)
        # endpoints of the remaining subgraph first
        cand = np.flatnonzero(~visited)
        rank = np.lexsort((cand, (rem_deg[cand] > 1).astype(np.int8)))
        cand = cand[rank]
        _, first = np.unique(comp_of[cand], return_index=True)
        run_walkers(cand[first])

    order = np.lexsort((step_of, chain_of))
    pts = np.stack([xs, ys], 1).astype(np.int32)[order]
    bounds = np.flatnonzero(np.diff(chain_of[order])) + 1
    return np.split(pts, bounds)


def canny_contours(image, low: float, high: float, sigma: float = -1.0,
                   radius: int = 2, relative: bool = False,
                   device=None) -> list[np.ndarray]:
    """CannyEdge with point-chain output (HysteresisEdgeTracePoints)."""
    return edge_contours(canny(image, low, high, sigma=sigma, radius=radius,
                               relative=relative, device=device))
