"""QR code localization in images (port of
``boofcv_tpu/recognition/qr/detector.py``).

Reference analog: boofcv-recognition alg/fiducial/qrcode/
QrCodePositionPatternDetector.java (finder-pattern squares),
QrCodeAlignmentPatternLocator, QrCodeDecoderImage.java (grid sampling +
decode).

Pipeline: threshold (device) -> external contours of dark blobs (host,
native tracer) -> 4-sided polygon fits -> nested-square (finder)
verification by sampling the 1:1:3:1:1 profile -> order the three finders
-> perspective grid sampling via a homography -> qr.code.decode.  The
homographies of every candidate version are fitted as one batched DLT on
the device (one host sync, where the reference fits one a version).
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch.feature import shapes
from boofcv_tpu_torch.ip import binary as bin_mod
from boofcv_tpu_torch.ip import threshold as th_mod
from boofcv_tpu_torch.recognition import homographies, image_on_device
from boofcv_tpu_torch.recognition.qr import code as qr_code


def _finder_score(gray, center, half):
    """Check the 1:1:3:1:1 dark/light profile along x and y.

    Sampling spans +-0.9*half: endpoints at exactly +-half sit ON the
    quad boundary and round into the quiet zone, which turns every outer
    7-module quad into a 7-run light/dark profile that never matches."""
    h, w = gray.shape
    samples = np.linspace(-0.9, 0.9, 21)
    ok = 0
    for axis in (0, 1):
        prof = []
        for s in samples:
            y = center[1] + (s * half if axis == 0 else 0)
            x = center[0] + (s * half if axis == 1 else 0)
            yi = int(round(min(max(y, 0), h - 1)))
            xi = int(round(min(max(x, 0), w - 1)))
            prof.append(gray[yi, xi])
        prof = np.asarray(prof)
        t = prof.mean()
        bits = prof < t
        # expected: dark, light, dark(core x3), light, dark
        runs = []
        cur, cnt = bits[0], 0
        for b in bits:
            if b == cur:
                cnt += 1
            else:
                runs.append((cur, cnt))
                cur, cnt = b, 1
        runs.append((cur, cnt))
        pattern = [r[0] for r in runs]
        if pattern != [True, False, True, False, True]:
            continue
        # ratio check 1:1:3:1:1 — rejects alignment patterns (1:1:1:1:1)
        lens = np.array([r[1] for r in runs], float)
        unit = (lens[0] + lens[1] + lens[3] + lens[4]) / 4.0
        if 1.8 * unit < lens[2] < 4.5 * unit:
            ok += 1
    return ok == 2


def _position_patterns(img, gray, t: float, min_area: float):
    """``find_position_patterns`` on the device image ``img`` (its host
    copy ``gray``) thresholded at ``t``."""
    bw = th_mod.threshold(img, t, down=True).cpu().numpy()
    quads = []
    for cont in bin_mod.contour_external(bw):
        if len(cont) < 16:
            continue
        corners = shapes.fit_polygon(cont, num_sides=4, tolerance=3.0)
        if len(corners) != 4 or not shapes.polygon_is_convex(corners):
            continue
        area = 0.5 * abs(sum(
            corners[i][0] * corners[(i + 1) % 4][1]
            - corners[(i + 1) % 4][0] * corners[i][1] for i in range(4)))
        if area < min_area:
            continue
        center = corners.mean(0)
        half = np.sqrt(area) / 2.0
        if _finder_score(gray, center, half):
            quads.append(np.asarray(corners, np.float64))
    return quads


def find_position_patterns(image, min_area: float = 60.0, device=None):
    """Candidate finder patterns: list of [4, 2] corner quads (x, y)."""
    img, gray = image_on_device(image, device)
    return _position_patterns(img, gray, float(th_mod.compute_otsu(img)),
                              min_area)


def _order_finders(quads):
    """Identify the corner (top-left) finder and return ordered centers
    (tl, tr, bl) plus their quads."""
    if len(quads) != 3:
        return None
    cs = [q.mean(0) for q in quads]
    # the TL finder sees the largest angle (~90 deg) between the others
    best, besti = -1, 0
    for i in range(3):
        a = cs[(i + 1) % 3] - cs[i]
        b = cs[(i + 2) % 3] - cs[i]
        cosang = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
        score = 1 - cosang
        if score > best:
            best, besti = score, i
    tl = besti
    o1, o2 = (tl + 1) % 3, (tl + 2) % 3
    # right-handed: cross(tr-tl, bl-tl) > 0 (y down)
    a = cs[o1] - cs[tl]
    b = cs[o2] - cs[tl]
    if a[0] * b[1] - a[1] * b[0] < 0:
        o1, o2 = o2, o1
    return (cs[tl], cs[o1], cs[o2]), (quads[tl], quads[o1], quads[o2])


def detect_and_decode(image, versions=None, device=None):
    """Find one QR code and decode it.  Returns (bytes, info) or
    (None, reason).

    versions=None estimates the version from the finder-pattern geometry
    (module size from the quad side, grid span from center spacing —
    QrCodeDecoderImage's approach) and tries the estimate +/- 1; pass an
    iterable to override.
    """
    img, gray = image_on_device(image, device)
    t = float(th_mod.compute_otsu(img))
    quads = _position_patterns(img, gray, t, 60.0)
    if len(quads) > 3:  # keep the 3 largest (alignment patterns are smaller)
        areas = [0.5 * abs((q[2] - q[0])[0] * (q[3] - q[1])[1]
                           - (q[2] - q[0])[1] * (q[3] - q[1])[0])
                 for q in quads]
        quads = [quads[i] for i in np.argsort(areas)[-3:]]
    ordered = _order_finders(quads)
    if ordered is None:
        return None, {"error": f"found {len(quads)} finder patterns"}
    (ctl, ctr, cbl), oquads = ordered
    # estimate version from finder spacing: centers are 3.5 modules from
    # the corner; distance tl->tr = (n - 7) modules
    dist = (np.linalg.norm(ctr - ctl) + np.linalg.norm(cbl - ctl)) / 2.0

    if versions is None:
        # module size from the quad side.  The contour fit may have locked
        # onto the outer ring (7 modules), the inner white hole (5) or the
        # core (3) of the finder, so try each interpretation, best first.
        side = np.mean([np.mean([np.linalg.norm(q[i] - q[(i + 1) % 4])
                                 for i in range(4)]) for q in oquads])
        versions = []
        for modules_across in (5.0, 7.0, 3.0):
            n_est = dist / (side / modules_across) + 7.0
            v_est = int(round((n_est - 17.0) / 4.0))
            for v in (v_est, v_est - 1, v_est + 1):
                if 1 <= v <= qr_code.MAX_VERSION and v not in versions:
                    versions.append(v)
    versions = list(versions)
    if not versions:
        return None, {"error": "no version decoded"}

    # homography from module coords (center-of-module) to pixels using
    # the 3 finder centers + inferred 4th point (parallelogram)
    cbr = ctr + (cbl - ctl)
    dst = np.stack([ctl, ctr, cbl, cbr])
    ns = [4 * v + 17 for v in versions]
    src = np.stack([np.array([[3.5, 3.5], [n - 3.5, 3.5], [3.5, n - 3.5],
                              [n - 3.5, n - 3.5]]) for n in ns])
    Hs = homographies(src, dst, img.device)
    h, w = gray.shape
    for n, H in zip(ns, Hs):
        # sample every module center
        gy, gx = np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5,
                             indexing="ij")
        pts = np.stack([gx.ravel(), gy.ravel(), np.ones(n * n)], 1) @ H.T
        px = pts[:, 0] / pts[:, 2]
        py = pts[:, 1] / pts[:, 2]
        xi = np.clip(np.round(px).astype(int), 0, w - 1)
        yi = np.clip(np.round(py).astype(int), 0, h - 1)
        mat = (gray[yi, xi] < t).reshape(n, n)
        out, info = qr_code.decode(mat)
        if out is not None:
            info["homography"] = H
            return out, info
    return None, {"error": "no version decoded"}


def render(mat, module_px: int = 4, quiet: int = 4, dark=0.0, light=255.0):
    """Rasterize a module matrix to a grayscale image (QrCodeGeneratorImage)."""
    mat = np.asarray(mat, bool)
    n = mat.shape[0]
    img = np.full(((n + 2 * quiet) * module_px, (n + 2 * quiet) * module_px),
                  light, np.float32)
    for r in range(n):
        for c in range(n):
            if mat[r, c]:
                y0 = (r + quiet) * module_px
                x0 = (c + quiet) * module_px
                img[y0:y0 + module_px, x0:x0 + module_px] = dark
    return img
