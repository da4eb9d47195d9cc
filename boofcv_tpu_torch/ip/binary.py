"""Binary-image operations: morphology, blob labeling, contours (port of
``boofcv_tpu/ip/binary.py``, whole).

Reference analog: boofcv-ip alg/filter/binary/BinaryImageOps.java,
LinearContourLabelChang2004.java.

On the image's device: morphology (min/max stencils), ``thin`` and
``label_blobs``.  On the host: ``relabel_compact``, ``label_blobs_host``,
``contour_external`` and ``contours_with_holes``, through the port's
native library (``boofcv_tpu_torch.native``), which raises when it cannot
be built; the Python Moore tracer (:func:`contours_with_holes_reference`)
is the plain version the tests hold the native tracer against, and no
caller falls back to it.

``thin`` and ``label_blobs`` are the reference's ``lax.while_loop``s on
"anything changed".  Once a pass changes nothing, every later pass changes
nothing, so the port runs ``CHECK_EVERY`` passes between reads of that
flag: one host sync per ``CHECK_EVERY`` passes instead of one a pass, and
the same fixpoint (and, with ``max_iters``, the same capped result).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# passes of thin's / label_blobs' loop between two reads of the "changed"
# flag (each read is a host sync on the card)
CHECK_EVERY = 16


def _neighbor_stack(image: torch.Tensor, eight: bool, pad_value):
    p = F.pad(image, (1, 1, 1, 1), value=pad_value)
    h, w = image.shape
    offs4 = [(0, 1), (1, 0), (1, 2), (2, 1)]
    offs8 = offs4 + [(0, 0), (0, 2), (2, 0), (2, 2)]
    offs = offs8 if eight else offs4
    return torch.stack([p[dy:dy + h, dx:dx + w] for dy, dx in offs], dim=0)


def _u8(image: torch.Tensor) -> torch.Tensor:
    return image.to(torch.uint8)


def erode4(image: torch.Tensor) -> torch.Tensor:
    """BinaryImageOps.erode4: pixel survives iff all 4-neighbors are 1."""
    n = _neighbor_stack(image, False, 0)
    return _u8(image) & _u8(torch.amin(n, dim=0) > 0)


def erode8(image: torch.Tensor) -> torch.Tensor:
    n = _neighbor_stack(image, True, 0)
    return _u8(image) & _u8(torch.amin(n, dim=0) > 0)


def dilate4(image: torch.Tensor) -> torch.Tensor:
    n = _neighbor_stack(image, False, 0)
    return _u8((image > 0) | (torch.amax(n, dim=0) > 0))


def dilate8(image: torch.Tensor) -> torch.Tensor:
    n = _neighbor_stack(image, True, 0)
    return _u8((image > 0) | (torch.amax(n, dim=0) > 0))


def edge4(image: torch.Tensor, outside_zero: bool = True) -> torch.Tensor:
    """BinaryImageOps.edge4: 1-pixels with at least one 0 4-neighbor."""
    n = _neighbor_stack(image, False, 0 if outside_zero else 1)
    return _u8((image > 0) & (torch.amin(n, dim=0) == 0))


def edge8(image: torch.Tensor, outside_zero: bool = True) -> torch.Tensor:
    n = _neighbor_stack(image, True, 0 if outside_zero else 1)
    return _u8((image > 0) & (torch.amin(n, dim=0) == 0))


def remove_point_noise(image: torch.Tensor) -> torch.Tensor:
    """BinaryImageOps.removePointNoise: majority vote of 8-neighbors."""
    n = _neighbor_stack(image, True, 0)
    count = torch.sum(n > 0, dim=0)
    return _u8(torch.where(count > 5, 1,
                           torch.where(count < 3, 0, image)))


def opening(image, eight=False, times=1):
    e, d = (erode8, dilate8) if eight else (erode4, dilate4)
    out = image
    for _ in range(times):
        out = e(out)
    for _ in range(times):
        out = d(out)
    return out


def closing(image, eight=False, times=1):
    e, d = (erode8, dilate8) if eight else (erode4, dilate4)
    out = image
    for _ in range(times):
        out = d(out)
    for _ in range(times):
        out = e(out)
    return out


def _to_fixpoint(step, state, done: int, max_iters: int):
    """Apply ``step`` until a pass changes nothing, or until ``max_iters``
    passes (0: no cap) counting the ``done`` passes already made, reading
    the "changed" flag after every ``CHECK_EVERY`` passes.  Passes past the
    fixpoint change nothing, so the result is the one-check-a-pass loop's."""
    while True:
        n = CHECK_EVERY if max_iters <= 0 else min(CHECK_EVERY,
                                                   max_iters - done)
        if n <= 0:
            return state
        for _ in range(n):
            before, state = state, step(state)
        done += n
        if torch.equal(state, before):
            return state


def _zhang_suen_pass(cur: torch.Tensor) -> torch.Tensor:
    """One pass of the two Zhang-Suen subpasses (bool [H, W])."""
    h, w = cur.shape

    def ring(c):
        """8-neighbor ring ordered p2..p9 = N, NE, E, SE, S, SW, W, NW."""
        p = F.pad(c, (1, 1, 1, 1))
        offs = [(-1, 0), (-1, 1), (0, 1), (1, 1),
                (1, 0), (1, -1), (0, -1), (-1, -1)]
        return torch.stack([p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                            for dy, dx in offs])

    def subpass(c, parity):
        n = ring(c)
        b = torch.sum(n, dim=0)
        nxt = torch.roll(n, -1, dims=0)
        a = torch.sum((~n) & nxt, dim=0)         # 0->1 transitions in ring
        p2, p4, p6, p8 = n[0], n[2], n[4], n[6]
        if parity == 0:
            cond = ~(p2 & p4 & p6) & ~(p4 & p6 & p8)
        else:
            cond = ~(p2 & p4 & p8) & ~(p2 & p6 & p8)
        remove = c & (b >= 2) & (b <= 6) & (a == 1) & cond
        return c & ~remove

    return subpass(subpass(cur, 0), 1)


def thin(binary: torch.Tensor, max_iters: int = -1) -> torch.Tensor:
    """Morphological thinning / skeletonization (BinaryThinning.java:45
    analog — the reference applies 8 hit-or-miss masks per pass; here the
    Zhang-Suen two-subpass formulation, whose deletion tests are parallel
    stencils, iterated until the skeleton stops changing or ``max_iters``
    passes are made).  Preserves connectivity and endpoints; output is a
    1-px-wide skeleton."""
    img = binary > 0
    out = _zhang_suen_pass(img)
    if not torch.equal(out, img):
        out = _to_fixpoint(_zhang_suen_pass, out, 1, max(max_iters, 0))
    return _u8(out)


def _min_label_pass(eight: bool, fg: torch.Tensor, big: float):
    """One min-label sweep on the negated labels: every foreground pixel
    takes the largest of -label over itself and its neighbours (out-of-image
    and background taps count as -big)."""
    def step(neg):
        x = neg[None, None]
        if eight:
            best = F.max_pool2d(x, 3, 1, 1)
        else:
            best = torch.maximum(F.max_pool2d(x, (3, 1), 1, (1, 0)),
                                 F.max_pool2d(x, (1, 3), 1, (0, 1)))
        return torch.where(fg, best[0, 0], -big)
    return step


def label_blobs(binary: torch.Tensor, eight: bool = True,
                max_iters: int = 0) -> torch.Tensor:
    """Connected-component labeling by iterative min-label propagation.

    Returns an int32 label image; 0 = background, components numbered by
    the (raster) index of their minimum pixel + 1 (NOT compacted — use
    :func:`relabel_compact` for contiguous ids, as the reference's
    LinearContourLabelChang2004 produces).  Labels live as negated float64
    (exact up to 2^53 pixels) so one ``max_pool2d`` is the whole stencil.
    """
    h, w = binary.shape
    fg = binary > 0
    big = float(h * w + 2)
    idx = torch.arange(1, h * w + 1, dtype=torch.float64,
                       device=binary.device).reshape(h, w)
    init = torch.where(fg, -idx, -big)
    step = _min_label_pass(eight, fg, big)
    neg = step(init)
    if not torch.equal(neg, init):
        neg = _to_fixpoint(step, neg, 0, max_iters)
    return torch.where(fg, -neg, 0.0).to(torch.int32)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def relabel_compact(labels) -> np.ndarray:
    """Host-side: renumber labels to 1..N in increasing order of the old
    value (background stays 0)."""
    lab = _host(labels)
    if lab.size == 0:
        return lab.copy()
    uniq, inv = np.unique(lab, return_inverse=True)
    new = np.arange(len(uniq), dtype=lab.dtype) + (0 if uniq[0] == 0 else 1)
    return new[inv.reshape(lab.shape)]


def label_blobs_host(binary, eight: bool = True):
    """Host-side union-find CCL (native C++): returns (labels [H, W] int32
    numbered 1..N in raster order, N).  Same output as
    ``relabel_compact(label_blobs(binary))`` but O(H*W) on the host — the
    path for host-driven detectors (fiducials, QR, targets)."""
    from boofcv_tpu_torch import native
    return native.ccl(_host(binary), eight=eight)


def contour_external(binary, label: int | None = None) -> list[np.ndarray]:
    """Host-side external contour tracing (Moore neighborhood, CW), analog
    of LinearExternalContours.java.  Returns a list of [K, 2] (x, y)
    arrays, ONE per blob, ordered by blob label (raster order of first
    pixels).  ``label`` selects a single blob (1-based ``label_blobs`` id).

    Externals are taken from the per-label Chang2004 tracer
    (:func:`contours_with_holes`), which keeps exactly one external contour
    per blob (the raw west-neighbour scan also fires east of every
    interior hole)."""
    res = contours_with_holes(binary)
    ext = [d["external"] for d in res if d["external"] is not None]
    if label is not None:
        idx = label - 1
        if idx < 0 or idx >= len(res) or res[idx]["external"] is None:
            return []
        return [res[idx]["external"]]
    return ext


def contours_with_holes(binary) -> list[dict]:
    """External AND internal contour tracing — the full
    LinearContourLabelChang2004.java:59 behavior, with the native tracer
    (``native/ccl.cpp`` ``boofcv_contours_with_holes``).  Host-side.

    Returns one dict per blob (raster order, matching ``label_blobs_host``
    ids 1..N): ``{"label": i, "external": [K, 2] (x, y), "internal":
    [[K_j, 2], ...]}`` where each internal contour walks the blob pixels
    surrounding one hole."""
    from boofcv_tpu_torch import native
    return native.contours_with_holes(_host(binary))


# Moore neighborhood (dy, dx), clockwise in image coords starting from W
_NBR = [(0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1)]


def _trace_radial(padded, traced, y, x, backtrack):
    """Radial-sweep Moore trace from (y, x) in padded coords, entering
    with the background ``backtrack`` neighbor index; terminates when the
    (pixel, direction) state repeats — visits every boundary pixel
    exactly as the reference's tracer (LinearContourLabelChang2004 uses
    the same walker for external and internal contours, differing only
    in start pixel and initial backtrack)."""
    first = None
    for i in range(1, 9):
        dd = (backtrack + i) % 8
        if padded[y + _NBR[dd][0], x + _NBR[dd][1]]:
            first = dd
            break
    if first is None:  # isolated pixel
        traced[y, x] = True
        return np.array([(x - 1, y - 1)], dtype=np.int32)
    contour = []
    states = set()
    cy, cx, d = y, x, first
    while (cy, cx, d) not in states:
        states.add((cy, cx, d))
        contour.append((cx - 1, cy - 1))
        traced[cy, cx] = True
        cy, cx = cy + _NBR[d][0], cx + _NBR[d][1]
        for i in range(8):
            dd = (d + 6 + i) % 8
            if padded[cy + _NBR[dd][0], cx + _NBR[dd][1]]:
                d = dd
                break
    return np.array(contour, dtype=np.int32)


def contours_with_holes_reference(binary) -> list[dict]:
    """The plain version of :func:`contours_with_holes`: the reference's
    pure-Python Moore walker, kept for the tests and the chip run to hold
    the native tracer against (no caller falls back to it)."""
    img = _host(binary) > 0
    h, w = img.shape
    labels, n = label_blobs_host(img, eight=True)

    padded = np.zeros((h + 2, w + 2), dtype=bool)
    padded[1:-1, 1:-1] = img
    traced = np.zeros_like(padded)

    out = [{"label": i + 1, "external": None, "internal": []}
           for i in range(n)]
    for y in range(1, h + 1):
        for x in range(1, w + 1):
            if not padded[y, x] or traced[y, x] or padded[y, x - 1]:
                continue
            c = _trace_radial(padded, traced, y, x, 0)
            lab = labels[c[0, 1], c[0, 0]]
            if out[lab - 1]["external"] is None:
                out[lab - 1]["external"] = c

    # holes: background components (4-connected, the dual of 8-connected
    # blobs) that do not touch the image border
    bg_labels, n_bg = label_blobs_host(~img, eight=False)
    border = np.zeros(n_bg + 1, bool)
    for edge in (bg_labels[0], bg_labels[-1], bg_labels[:, 0],
                 bg_labels[:, -1]):
        border[np.unique(edge[edge > 0])] = True
    hole_traced = np.zeros_like(padded)
    for hid in range(1, n_bg + 1):
        if border[hid]:
            continue
        ys, xs = np.nonzero(bg_labels == hid)
        k = np.lexsort((xs, ys))[0]          # topmost-leftmost hole pixel
        hy, hx = int(ys[k]) + 1, int(xs[k]) + 1
        # the pixel above it is a blob pixel on the hole's boundary;
        # backtrack points south into the hole (index 6)
        c = _trace_radial(padded, hole_traced, hy - 1, hx, 6)
        lab = labels[c[0, 1], c[0, 0]]
        out[lab - 1]["internal"].append(c)
    return out
