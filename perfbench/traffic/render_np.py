"""Frozen numpy copy of ``render.py`` (itself a rewrite of the port's
``boofcv_tpu_torch/io/simulate.py``): the plain version the tests hold the
device renderer to, on the same random grids."""

from __future__ import annotations

import numpy as np


def noise_texture(grids, size: int) -> np.ndarray:
    tex = np.zeros((size, size))
    for o, small in enumerate(grids):
        step = 2 ** o
        yy, xx = np.mgrid[0:size, 0:size] / step
        y0 = yy.astype(int)
        x0 = xx.astype(int)
        fy = yy - y0
        fx = xx - x0
        up = (small[y0, x0] * (1 - fy) * (1 - fx)
              + small[y0, x0 + 1] * (1 - fy) * fx
              + small[y0 + 1, x0] * fy * (1 - fx)
              + small[y0 + 1, x0 + 1] * fy * fx)
        tex += up * (2.0 ** o)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return (tex * 235.0 + 10.0).astype(np.float32)


def _bilinear(img, ys, xs):
    h, w = img.shape
    y0f = np.floor(ys)
    x0f = np.floor(xs)
    fy = (ys - y0f).astype(np.float32)
    fx = (xs - x0f).astype(np.float32)
    y0 = np.clip(y0f.astype(np.int64), 0, h - 1)
    x0 = np.clip(x0f.astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, None, h - 1)
    x1 = np.clip(x0 + 1, None, w - 1)
    return ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x1])
            + fy * ((1 - fx) * img[y1, x0] + fx * img[y1, x1]))


def render_plane(texture, K, R, t, height, width, plane_origin, plane_x,
                 plane_y, texture_scale, background=0.0):
    K = np.asarray(K, np.float64)
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    o = np.asarray(plane_origin, np.float64)
    ex = np.asarray(plane_x, np.float64)
    ey = np.asarray(plane_y, np.float64)
    n = np.cross(ex, ey)
    n = n / np.linalg.norm(n)
    ys, xs = np.meshgrid(np.arange(height, dtype=np.float64),
                         np.arange(width, dtype=np.float64), indexing="ij")
    rays_c = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    c0 = -(R.T @ t)
    d_w = rays_c @ R
    denom = d_w @ n
    s = ((o - c0) @ n) / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    X = c0 + s[..., None] * d_w
    rel = X - o
    g11, g12, g22 = ex @ ex, ex @ ey, ey @ ey
    b1 = rel @ ex
    b2 = rel @ ey
    det = g11 * g22 - g12 * g12
    u = (g22 * b1 - g12 * b2) / det
    v = (g11 * b2 - g12 * b1) / det
    th, tw = texture.shape
    tu = u * texture_scale + tw / 2.0
    tv = v * texture_scale + th / 2.0
    img = _bilinear(np.asarray(texture, np.float32), tv.astype(np.float32),
                    tu.astype(np.float32))
    visible = (s > 0) & (tu >= 0) & (tu < tw - 1) & (tv >= 0) & (tv < th - 1)
    return np.where(visible, img, np.float32(background)).astype(np.float32)


def quantise(img):
    return np.clip(np.round(img), 0, 255).astype(np.uint8)
