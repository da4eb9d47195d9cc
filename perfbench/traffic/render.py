"""The stereo replay scene, rendered on the device from a seed.

A frozen torch rewrite of the port's host renderer
(``boofcv_tpu_torch/io/simulate.py``: ``noise_texture``, ``render_plane``,
``render_stereo_sequence``) and of the scene of ``chip_smoke._scene``: a
textured plane seen by a rig that creeps forward and yaws slowly.  It
imports nothing of the port.  ``render_np.py`` is the plain numpy copy that
the tests hold it to.

Everything the scene needs comes from the configuration's ``scene`` and
``camera`` groups and from the seed: the texture's random grids are drawn
with a ``torch.Generator`` on the device, so one seed gives one sequence.
Frames are quantised to 8 bits, as a camera delivers them.
"""

from __future__ import annotations

import math

import torch


def texture_grids(seed: int, size: int, octaves: int, device) -> list:
    """The random grids of the noise texture: one [size/2^o + 2]^2 uniform
    grid an octave, drawn on ``device`` from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return [torch.rand((size // 2 ** o + 2, size // 2 ** o + 2),
                       generator=g, device=device, dtype=torch.float64)
            for o in range(octaves)]


def noise_texture(grids, size: int) -> torch.Tensor:
    """Multi-octave value noise from ``grids``, scaled to [10, 245]
    (float32 [size, size])."""
    dev = grids[0].device
    tex = torch.zeros((size, size), dtype=torch.float64, device=dev)
    ar = torch.arange(size, dtype=torch.float64, device=dev)
    for o, small in enumerate(grids):
        step = 2 ** o
        yy = (ar / step)[:, None].expand(size, size)
        xx = (ar / step)[None, :].expand(size, size)
        y0 = yy.long()
        x0 = xx.long()
        fy = yy - y0
        fx = xx - x0
        up = (small[y0, x0] * (1 - fy) * (1 - fx)
              + small[y0, x0 + 1] * (1 - fy) * fx
              + small[y0 + 1, x0] * fy * (1 - fx)
              + small[y0 + 1, x0 + 1] * fy * fx)
        tex = tex + up * (2.0 ** o)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return (tex * 235.0 + 10.0).to(torch.float32)


def _bilinear(img: torch.Tensor, ys: torch.Tensor,
              xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``img`` at float32 (ys, xs), taps clamped into
    the image."""
    h, w = img.shape
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    fy = ys - y0f
    fx = xs - x0f
    y0 = y0f.long().clamp(0, h - 1)
    x0 = x0f.long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    return ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x1])
            + fy * ((1 - fx) * img[y1, x0] + fx * img[y1, x1]))


def render_plane(texture: torch.Tensor, K, R, t, height: int, width: int,
                 plane_origin, plane_x, plane_y, texture_scale: float,
                 background: float = 0.0) -> torch.Tensor:
    """The textured plane X(u, v) = origin + u ex + v ey seen by the
    world->camera pose (R, t): float32 [height, width], ``background``
    where the ray misses the texture."""
    dev = texture.device
    f64 = dict(dtype=torch.float64, device=dev)
    K = torch.as_tensor(K, **f64)
    R = torch.as_tensor(R, **f64)
    t = torch.as_tensor(t, **f64)
    o = torch.as_tensor(plane_origin, **f64)
    ex = torch.as_tensor(plane_x, **f64)
    ey = torch.as_tensor(plane_y, **f64)
    n = torch.linalg.cross(ex, ey)
    n = n / torch.linalg.norm(n)
    ys, xs = torch.meshgrid(torch.arange(height, **f64),
                            torch.arange(width, **f64), indexing="ij")
    rays_c = torch.stack([xs, ys, torch.ones_like(xs)], -1) @ \
        torch.linalg.inv(K).T
    c0 = -(R.T @ t)
    d_w = rays_c @ R
    denom = d_w @ n
    s = ((o - c0) @ n) / torch.where(denom.abs() < 1e-12, 1e-12, denom)
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
    img = _bilinear(texture, tv.to(torch.float32), tu.to(torch.float32))
    visible = (s > 0) & (tu >= 0) & (tu < tw - 1) & (tv >= 0) & (tv < th - 1)
    return torch.where(visible, img, background).to(torch.float32)


def rig_pose(i: int, scene: dict):
    """World->left-camera (R, t) of frame ``i``: yaw about y by
    ``yaw_per_frame`` a frame, centre moved by ``creep_per_frame``."""
    a = scene["yaw_per_frame"] * i
    R = [[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
         [-math.sin(a), 0.0, math.cos(a)]]
    c = [v * i for v in scene["creep_per_frame"]]
    t = [-sum(R[r][k] * c[k] for k in range(3)) for r in range(3)]
    return R, t


def camera_matrix(camera: dict):
    return [[camera["fx"], 0.0, camera["cx"]], [0.0, camera["fy"], camera["cy"]],
            [0.0, 0.0, 1.0]]


def quantise(img: torch.Tensor) -> torch.Tensor:
    """8-bit frame: round to nearest, clamp to [0, 255]."""
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def render_sequence(seed: int, camera: dict, scene: dict, n_frames: int,
                    device) -> tuple:
    """(lefts, rights): uint8 [n_frames, H, W] on ``device``.  The right
    camera sits ``baseline`` to the right: t_r = t_l - (b, 0, 0)."""
    grids = texture_grids(seed, scene["texture_size"], scene["octaves"],
                          device)
    tex = noise_texture(grids, scene["texture_size"])
    K = camera_matrix(camera)
    h, w = camera["height"], camera["width"]
    plane = dict(plane_origin=scene["plane_origin"],
                 plane_x=scene["plane_x"], plane_y=scene["plane_y"],
                 texture_scale=scene["texture_scale"])
    lefts, rights = [], []
    for i in range(n_frames):
        R, t = rig_pose(i, scene)
        tr = [t[0] - camera["baseline"], t[1], t[2]]
        lefts.append(quantise(render_plane(tex, K, R, t, h, w, **plane)))
        rights.append(quantise(render_plane(tex, K, R, tr, h, w, **plane)))
    return torch.stack(lefts), torch.stack(rights)
