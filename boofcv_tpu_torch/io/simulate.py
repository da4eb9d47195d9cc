"""Synthetic stereo rendering (port of ``boofcv_tpu/io/simulate.py``:
``noise_texture``, ``render_plane``, ``render_stereo_sequence``).

Runs on the host (numpy, and the port's bilinear sampler on CPU tensors),
so it works where JAX is absent: it is the oracle renderer of the chip
smoke run.  Exact inverse mapping: each pixel's ray meets a textured world
plane, and the texture is sampled bilinearly in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch.ip.interpolate import bilinear


def noise_texture(rng, size: int = 512, octaves: int = 4) -> np.ndarray:
    """Non-periodic multi-octave noise texture (alias-free for stereo block
    matching and KLT).  Same numpy draws as the reference."""
    tex = np.zeros((size, size))
    for o in range(octaves):
        step = 2 ** o
        small = rng.uniform(0, 1, (size // step + 2, size // step + 2))
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


def render_plane(texture, K, R, t, height: int, width: int,
                 plane_origin=(0.0, 0.0, 6.0),
                 plane_x=(1.0, 0.0, 0.0), plane_y=(0.0, 1.0, -0.15),
                 texture_scale: float = 40.0,
                 background: float = 0.0) -> np.ndarray:
    """Render the textured plane X(u, v) = origin + u ex + v ey seen by the
    camera (R, t) (world->camera).  Returns an [H, W] float32 image."""
    K = np.asarray(K, np.float64)
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    texture = np.asarray(texture, np.float32)
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
    img = bilinear(torch.from_numpy(texture),
                   torch.from_numpy(tv.astype(np.float32)),
                   torch.from_numpy(tu.astype(np.float32))).numpy()
    visible = (s > 0) & (tu >= 0) & (tu < tw - 1) & (tv >= 0) & (tv < th - 1)
    return np.where(visible, img, np.float32(background)).astype(np.float32)


def render_stereo_sequence(rng, K, baseline: float, poses, height, width,
                           **plane_kw):
    """(left, right) float32 images for each world->left pose (R, t).
    The right camera sits at +baseline along x: t_r = t_l - (b, 0, 0)."""
    tex = noise_texture(rng)
    offset = np.asarray([baseline, 0.0, 0.0])
    frames = []
    for R, t in poses:
        t = np.asarray(t, np.float64)
        left = render_plane(tex, K, R, t, height, width, **plane_kw)
        right = render_plane(tex, K, R, t - offset, height, width,
                             **plane_kw)
        frames.append((left, right))
    return frames
