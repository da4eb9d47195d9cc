"""TLD long-term object tracker (tracking-learning-detection); port of
``boofcv_tpu/recognition/tld.py``.

Reference analog: boofcv-recognition alg/tracker/tld/ — TldTracker.java
orchestrating TldRegionTracker (KLT of a grid inside the box),
TldVarianceFilter (integral-image variance gate), TldFernClassifier /
TldFernManager (random-fern bit tests), TldTemplateMatching (NCC
confirmation), TldDetection and TldLearning (P/N updates).

The split is the reference's.  On the device: both frames' pyramids and
gradients, the KLT templates, the forward and backward
``klt.track_pyramid`` (one ``klt_track`` launch each on a CUDA tensor) and
the bilinear patches.  On the host, in numpy: the variance gate, the fern
codes and posteriors, the NCC scores against the template lists and the P/N
learning.  The generator is ``np.random.default_rng(seed)``, so fern pairs
and jitters are the reference's, draw for draw.

The detector samples all of a frame's NCC candidates in one ``bilinear``
call and reads them back once; every sample is independent, and each patch
is normalized on its own on the host, so the values are those of one call
a patch.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.feature import klt
from boofcv_tpu_torch.ip import pyramid_ops
from boofcv_tpu_torch.ip.interpolate import bilinear
from boofcv_tpu_torch.recognition import image_on_device


@dataclass
class TldConfig:
    num_ferns: int = 10
    fern_size: int = 8           # bits per fern
    variance_frac: float = 0.5   # min variance vs initial patch
    ncc_confirm: float = 0.6
    track_confirm: float = 0.5   # min fused confidence to stay "found"
    template_size: int = 15
    max_templates: int = 50
    scale_steps: tuple = (0.8, 1.0, 1.25)
    grid_stride: float = 0.1     # window stride as fraction of size
    # the detection pyramid: scales 1.2^k of the INITIAL box size, k in
    # [-octaves, +octaves] (TldDetection scans every level, so the detector
    # can reacquire after large scale changes)
    pyramid_octaves: int = 5
    max_ncc_candidates: int = 64  # fern survivors scored by NCC per frame


# median flow: a 5x5 grid of tracks, pyramid 1/2, 7x7 templates, 15 steps
_FLOW_GRID = 5
_FLOW_SCALES = (1, 2)
_FLOW_KLT = klt.KltConfig(template_radius=3, max_iterations=15)


def _fma(x: float, y: float, z: float) -> float:
    """x * y + z rounded once (Python's int true division rounds
    correctly; every float is an integer over a power of two)."""
    nx, dx = x.as_integer_ratio()
    ny, dy = y.as_integer_ratio()
    nz, dz = z.as_integer_ratio()
    return (nx * ny * dz + nz * dx * dy) / (dx * dy * dz)


def linspace_xla(a: float, b: float, n: int) -> np.ndarray:
    """``jnp.linspace(a, b, n)`` in float64 as XLA on the CPU computes it,
    bit for bit (the reference's ``_patch`` coordinates).

    ``jnp.linspace`` is a jitted ``a * (1 - i/d) + b * (i/d)``, d = n - 1.
    XLA rewrites ``i/d`` as ``i * (1/d)`` and ``b * (i * c)`` as
    ``i * (b * c)``; LLVM folds the constant iota and contracts each sum
    into one fused multiply-add: ``fma(a, 1 - c, b * c)`` where i = 1,
    ``fma(i, b * c, a * (1 - i c))`` where i > 1; the ends are a and b."""
    d = n - 1
    if d < 1:
        return np.array([a], np.float64)[:n]
    c = 1.0 / d
    bc = b * c
    mid = [_fma(a, 1.0 - c, bc)] if d > 1 else []
    mid += [_fma(float(i), bc, a * (1.0 - i * c)) for i in range(2, d)]
    return np.array([a] + mid + [b], np.float64)


@dataclass
class TldTracker:
    cfg: TldConfig
    rng: np.random.Generator
    device: torch.device = None
    fern_pairs: np.ndarray = None      # [F, B, 2, 2] relative sample pts
    posteriors_p: np.ndarray = None    # [F, 2^B] positive counts
    posteriors_n: np.ndarray = None
    pos_templates: list = field(default_factory=list)
    neg_templates: list = field(default_factory=list)
    box: tuple = None                  # (cy, cx, h, w)
    init_var: float = 0.0
    init_size: tuple = None            # (h, w) at initialize (pyramid base)
    _prev_image: torch.Tensor = None   # float32 [H, W] on the device

    # -- patch utilities ---------------------------------------------------
    def _patches(self, image: torch.Tensor, boxes) -> list:
        """Zero-mean unit-norm n x n bilinear patches of the device image
        over each (cy, cx, h, w) of ``boxes``: one ``bilinear`` call and
        one read back, then each patch normalized on its own in numpy."""
        if not boxes:
            return []
        n = self.cfg.template_size
        yy, xx = [], []
        for cy, cx, h, w in boxes:
            ys = linspace_xla(cy - h / 2, cy + h / 2, n)
            xs = linspace_xla(cx - w / 2, cx + w / 2, n)
            gy, gx = np.meshgrid(ys, xs, indexing="ij")
            yy.append(gy)
            xx.append(gx)
        coords = torch.from_numpy(np.stack([np.stack(yy), np.stack(xx)]))
        coords = coords.to(image.device)
        ps = bilinear(image, coords[0], coords[1]).cpu().numpy()
        out = []
        for p in ps:
            p = p - p.mean()
            out.append(p / (np.linalg.norm(p) + 1e-9))
        return out

    def _patch(self, image: torch.Tensor, cy, cx, h, w) -> np.ndarray:
        return self._patches(image, [(cy, cx, h, w)])[0]

    def _ncc_best(self, patch, templates):
        """Best similarity s = (NCC+1)/2 in [0, 1] (canonical TLD)."""
        if not templates:
            return 0.0
        t = np.stack(templates)
        return float((np.max(np.tensordot(t, patch, axes=2)) + 1.0) / 2.0)

    def _confidence(self, patch):
        sp = self._ncc_best(patch, self.pos_templates)
        sn = self._ncc_best(patch, self.neg_templates)
        return sp / (sp + sn + 1e-9)

    def _fern_codes(self, img: np.ndarray, cy, cx, h, w):
        """[F] integer fern codes for one window of the host image."""
        H, W = img.shape
        codes = np.zeros(self.cfg.num_ferns, np.int64)
        for f in range(self.cfg.num_ferns):
            code = 0
            for b in range(self.cfg.fern_size):
                (ay, ax), (by, bx) = self.fern_pairs[f, b]
                y1 = int(np.clip(cy + ay * h, 0, H - 1))
                x1 = int(np.clip(cx + ax * w, 0, W - 1))
                y2 = int(np.clip(cy + by * h, 0, H - 1))
                x2 = int(np.clip(cx + bx * w, 0, W - 1))
                code = (code << 1) | int(img[y1, x1] > img[y2, x2])
            codes[f] = code
        return codes

    def _learn(self, img, image, cy, cx, h, w, positive: bool,
               patch=None):
        """P/N update at one window: the fern posteriors (host image
        ``img``) and, while the list has room, the template (device image
        ``image``, or ``patch`` when it is already sampled)."""
        codes = self._fern_codes(img, cy, cx, h, w)
        tgt = self.posteriors_p if positive else self.posteriors_n
        tgt[np.arange(self.cfg.num_ferns), codes] += 1
        lst = self.pos_templates if positive else self.neg_templates
        if len(lst) < self.cfg.max_templates:
            lst.append(patch if patch is not None
                       else self._patch(image, cy, cx, h, w))

    # -- public ------------------------------------------------------------
    def initialize(self, image, cy, cx, h, w):
        """Learn the target in the box (cy, cx, h, w) of ``image`` (numpy
        or a tensor, [H, W]): fern pairs, 8 jittered positives, negatives
        away from the target."""
        c = self.cfg
        dev_img, img = image_on_device(image, self.device)
        self.fern_pairs = self.rng.uniform(-0.5, 0.5,
                                           (c.num_ferns, c.fern_size, 2, 2))
        self.posteriors_p = np.zeros((c.num_ferns, 2 ** c.fern_size))
        self.posteriors_n = np.zeros((c.num_ferns, 2 ** c.fern_size))
        self.box = (float(cy), float(cx), float(h), float(w))
        self.init_size = (float(h), float(w))
        y0, y1 = int(cy - h / 2), int(cy + h / 2)
        x0, x1 = int(cx - w / 2), int(cx + w / 2)
        self.init_var = float(img[y0:y1, x0:x1].var())
        # the draws come first, in the reference's order; then one
        # bilinear call for every template
        pos = []
        for _ in range(8):
            jy = cy + self.rng.uniform(-0.1, 0.1) * h
            jx = cx + self.rng.uniform(-0.1, 0.1) * w
            js = 1.0 + self.rng.uniform(-0.1, 0.1)
            pos.append((jy, jx, h * js, w * js))
        H, W = img.shape
        neg = []
        for _ in range(10):
            ny = self.rng.uniform(h / 2, H - h / 2)
            nx = self.rng.uniform(w / 2, W - w / 2)
            if abs(ny - cy) > h or abs(nx - cx) > w:
                neg.append((ny, nx, h, w))
        patches = self._patches(dev_img, pos + neg)
        for i, bx in enumerate(pos + neg):
            self._learn(img, dev_img, *bx, i < len(pos), patch=patches[i])
        self._prev_image = dev_img        # median flow needs a key frame

    def _fern_codes_batch(self, img, cys, cxs, h, w):
        """[M, F] fern codes for M windows of size (h, w), by fancy-index
        sampling of the host image."""
        H, W = img.shape
        fp = self.fern_pairs                                  # [F, B, 2, 2]
        y1 = np.clip(cys[:, None, None] + fp[None, :, :, 0, 0] * h,
                     0, H - 1).astype(np.intp)
        x1 = np.clip(cxs[:, None, None] + fp[None, :, :, 0, 1] * w,
                     0, W - 1).astype(np.intp)
        y2 = np.clip(cys[:, None, None] + fp[None, :, :, 1, 0] * h,
                     0, H - 1).astype(np.intp)
        x2 = np.clip(cxs[:, None, None] + fp[None, :, :, 1, 1] * w,
                     0, W - 1).astype(np.intp)
        bits = img[y1, x1] > img[y2, x2]                      # [M, F, B]
        weights = (1 << np.arange(self.cfg.fern_size - 1, -1, -1,
                                  dtype=np.int64))
        return bits @ weights                                  # [M, F]

    def _detect(self, img: np.ndarray, image: torch.Tensor):
        """Sliding-window cascade over the full scale pyramid (TldDetection
        analog): variance -> ferns on the host image ``img``, then NCC of
        the strongest fern survivors, sampled from the device image.
        Returns (conf, cy, cx, h, w) of the best confirmed window, or
        None."""
        H, W = img.shape
        h0, w0 = self.init_size
        ii = np.zeros((H + 1, W + 1))
        ii[1:, 1:] = img.cumsum(0).cumsum(1)
        ii2 = np.zeros((H + 1, W + 1))
        ii2[1:, 1:] = (img.astype(np.float64) ** 2).cumsum(0).cumsum(1)

        cand = []                          # (fern_prob, cy, cx, hs, ws)
        ko = self.cfg.pyramid_octaves
        for s in 1.2 ** np.arange(-ko, ko + 1):
            hs, ws = h0 * s, w0 * s
            if hs > H or ws > W or hs < 8 or ws < 8:
                continue
            sy = max(int(hs * self.cfg.grid_stride), 2)
            sx = max(int(ws * self.cfg.grid_stride), 2)
            cys = np.arange(hs / 2, H - hs / 2, sy)
            cxs = np.arange(ws / 2, W - ws / 2, sx)
            if len(cys) == 0 or len(cxs) == 0:
                continue
            gy, gx = np.meshgrid(cys, cxs, indexing="ij")
            gy = gy.ravel()
            gx = gx.ravel()
            y0 = (gy - hs / 2).astype(np.intp)
            x0 = (gx - ws / 2).astype(np.intp)
            y1 = (gy + hs / 2).astype(np.intp)
            x1 = (gx + ws / 2).astype(np.intp)
            area = (y1 - y0) * (x1 - x0)
            sm = ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]
            sm2 = ii2[y1, x1] - ii2[y0, x1] - ii2[y1, x0] + ii2[y0, x0]
            var = sm2 / area - (sm / area) ** 2
            keep = var >= self.cfg.variance_frac * self.init_var
            if not keep.any():
                continue
            gy, gx = gy[keep], gx[keep]
            codes = self._fern_codes_batch(img, gy, gx, hs, ws)  # [M, F]
            fr = np.arange(self.cfg.num_ferns)
            p = self.posteriors_p[fr[None, :], codes]
            n = self.posteriors_n[fr[None, :], codes]
            prob = ((p + 1.0) / (p + n + 2.0)).mean(axis=1)
            ok = prob >= 0.5
            for i in np.nonzero(ok)[0]:
                cand.append((float(prob[i]), float(gy[i]), float(gx[i]),
                             hs, ws))
        if not cand:
            return None
        cand.sort(reverse=True)
        top = [c[1:] for c in cand[:self.cfg.max_ncc_candidates]]
        best = None
        for (cy, cx, hs, ws), patch in zip(top, self._patches(image, top)):
            conf = self._confidence(patch)
            if conf > self.cfg.ncc_confirm and (
                    best is None or conf > best[0]):
                best = (conf, cy, cx, hs, ws)
        return best

    def _track(self, img: np.ndarray, image: torch.Tensor):
        """Median-flow region tracking with forward-backward validation
        (TldRegionTracker / TldAdjustRegion analog): KLT a 5x5 grid inside
        the box forward, track the results backward, keep the half with
        the lowest FB error, move the box by the median displacement and
        rescale by the median pairwise-distance ratio.  Both frames'
        pyramids are built anew.  Returns (cy, cx, h, w, confidence) or
        None."""
        if self._prev_image is None:
            return None
        cy, cx, h, w = self.box
        g = _FLOW_GRID
        gy = np.linspace(cy - 0.4 * h, cy + 0.4 * h, g)
        gx = np.linspace(cx - 0.4 * w, cx + 0.4 * w, g)
        yy, xx = np.meshgrid(gy, gx, indexing="ij")
        ys0_h = yy.ravel().astype(np.float32)
        xs0_h = xx.ravel().astype(np.float32)
        ys0 = torch.from_numpy(ys0_h).to(image.device)
        xs0 = torch.from_numpy(xs0_h).to(image.device)

        scales = _FLOW_SCALES
        pcfg = PyramidConfig(scales=scales)
        pyr_p = pyramid_ops.pyramid_average(self._prev_image, pcfg)
        pyr_c = pyramid_ops.pyramid_average(image, pcfg)
        grads_p = pyramid_ops.gradient(pyr_p)
        grads_c = pyramid_ops.gradient(pyr_c)

        tmpl = klt.sample_templates(pyr_p, grads_p, ys0, xs0, scales, 3)
        fy, fx, ff = klt.track_pyramid(pyr_c, tmpl, ys0, xs0, scales,
                                       _FLOW_KLT)
        tmpl_b = klt.sample_templates(pyr_c, grads_c, fy, fx, scales, 3)
        by, bx, bf = klt.track_pyramid(pyr_p, tmpl_b, fy, fx, scales,
                                       _FLOW_KLT)
        # one read back: positions (float32) and fault codes
        host = torch.stack([fy, fx, by, bx, ff.to(torch.float32),
                            bf.to(torch.float32)]).cpu().numpy()
        fy, fx, by, bx = host[:4]

        ok = (host[4] == klt.TRACK_OK) & (host[5] == klt.TRACK_OK)
        fb = np.hypot(by - ys0_h, bx - xs0_h)
        if ok.sum() < 6:
            return None
        fb_ok = fb <= np.median(fb[ok])
        keep = ok & fb_ok
        if keep.sum() < 4:
            return None
        y0k, x0k = yy.ravel()[keep], xx.ravel()[keep]
        y1k = fy[keep]
        x1k = fx[keep]
        dy = float(np.median(y1k - y0k))
        dx = float(np.median(x1k - x0k))
        # scale: median of pairwise-distance ratios (MedianFlow)
        if keep.sum() >= 2:
            d0 = np.hypot(y0k[:, None] - y0k[None, :],
                          x0k[:, None] - x0k[None, :])
            d1 = np.hypot(y1k[:, None] - y1k[None, :],
                          x1k[:, None] - x1k[None, :])
            iu = np.triu_indices(len(y0k), 1)
            r0, r1 = d0[iu], d1[iu]
            good = r0 > 2.0
            s = float(np.median(r1[good] / r0[good])) if good.any() else 1.0
            s = float(np.clip(s, min(self.cfg.scale_steps),
                              max(self.cfg.scale_steps)))
        else:
            s = 1.0
        ncy, ncx = cy + dy, cx + dx
        nh, nw = h * s, w * s
        H, W = img.shape
        if not (nh / 2 < ncy < H - nh / 2 and nw / 2 < ncx < W - nw / 2):
            return None
        conf = self._confidence(self._patch(image, ncy, ncx, nh, nw))
        return ncy, ncx, nh, nw, conf

    def process(self, image):
        """One frame of TldTracker.process: TRACK (median flow + FB) and
        DETECT (variance -> fern -> NCC cascade) hypotheses are fused — a
        strong detection away from a weak track reacquires the target —
        then P/N learning updates the models.  ``image``: numpy or a
        tensor, [H, W].  Returns (found, box)."""
        dev_img, img = image_on_device(image, self.device)
        trk = self._track(img, dev_img)
        det = self._detect(img, dev_img)
        cfg = self.cfg

        chosen = None
        if trk is not None:
            ncy, ncx, nh, nw, conf_t = trk
            chosen = (conf_t, ncy, ncx, nh, nw)
        if det is not None:
            conf_d, dcy, dcx, dh, dw = det
            far = chosen is None or (
                abs(dcy - chosen[1]) > 0.5 * chosen[3]
                or abs(dcx - chosen[2]) > 0.5 * chosen[4])
            if chosen is None or (far and conf_d > chosen[0] + 0.05) \
                    or (not far and conf_d > chosen[0]):
                chosen = (conf_d, dcy, dcx, dh, dw)

        self._prev_image = dev_img
        if chosen is None:
            return False, self.box
        conf, cy, cx, h, w = chosen
        # low-confidence hypotheses (occlusion, drift) are neither trusted
        # nor learned from
        if conf < cfg.track_confirm:
            return False, self.box
        self.box = (float(cy), float(cx), float(h), float(w))
        # P/N learning: a positive at the fused box when the confidence is
        # strong; a negative at a detection far from it (N-expert)
        if conf >= cfg.ncc_confirm:
            self._learn(img, dev_img, cy, cx, h, w, True)
        if det is not None:
            _, dcy, dcx, dh, dw = det
            if abs(dcy - cy) > h or abs(dcx - cx) > w:
                self._learn(img, dev_img, dcy, dcx, dh, dw, False)
        return True, self.box


def make_tracker(cfg: TldConfig | None = None, seed: int = 0,
                 device=None) -> TldTracker:
    """A tracker drawing from ``np.random.default_rng(seed)``, on
    ``device`` (None: the card)."""
    return TldTracker(cfg or TldConfig(), np.random.default_rng(seed),
                      resolve_device(device))


_STATE = ("fern_pairs", "posteriors_p", "posteriors_n", "pos_templates",
          "neg_templates", "box", "init_var", "init_size", "_prev_image")


def tracker_from_numpy(d, device=None) -> TldTracker:
    """A tracker that continues another's state: ``d`` maps the names of
    :data:`_STATE` (numpy arrays and lists; ``_prev_image`` the last frame
    as [H, W]) and optionally ``cfg`` (a config or a mapping of its
    fields) and ``rng`` (a ``np.random.Generator``).  The reference
    tracker's attributes give such a mapping."""
    cfg = d.get("cfg")
    if cfg is None:
        cfg = TldConfig()
    elif not isinstance(cfg, TldConfig):
        names = {f.name for f in fields(TldConfig)}
        cfg = TldConfig(**{k: v for k, v in dict(cfg).items()
                           if k in names})
    dev = resolve_device(device)
    t = TldTracker(cfg, d.get("rng") or np.random.default_rng(0), dev)
    t.fern_pairs = np.array(d["fern_pairs"], np.float64)
    t.posteriors_p = np.array(d["posteriors_p"], np.float64)
    t.posteriors_n = np.array(d["posteriors_n"], np.float64)
    t.pos_templates = [np.array(p, np.float32) for p in d["pos_templates"]]
    t.neg_templates = [np.array(p, np.float32) for p in d["neg_templates"]]
    t.box = tuple(float(v) for v in d["box"])
    t.init_var = float(d["init_var"])
    t.init_size = tuple(float(v) for v in d["init_size"])
    prev = d["_prev_image"]
    t._prev_image = (None if prev is None else torch.as_tensor(
        np.asarray(prev, np.float32), device=dev))
    return t
