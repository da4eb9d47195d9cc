"""Debug visualization, matplotlib imported inside the functions (port of
``boofcv_tpu/io/visualize.py``).

Reference analog: boofcv-io visualize/PointCloudViewer.java and the
boofcv-swing feature/disparity/d3 render helpers — here reduced to
save-to-PNG functions so headless jobs can emit artifacts; the library
core never imports matplotlib.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def save_features(path: str, image, ys, xs, valid=None, radius: int = 3):
    """Image + detected feature overlay (VisualizeFeatures analog)."""
    plt = _plt()
    img = np.asarray(image)
    fig, ax = plt.subplots(figsize=(img.shape[1] / 80, img.shape[0] / 80))
    ax.imshow(img, cmap="gray")
    ys = np.asarray(ys)
    xs = np.asarray(xs)
    if valid is not None:
        v = np.asarray(valid)
        ys, xs = ys[v], xs[v]
    ax.scatter(xs, ys, s=radius ** 2 * 3, facecolors="none",
               edgecolors="red", linewidths=0.8)
    ax.set_axis_off()
    fig.savefig(path, bbox_inches="tight", dpi=80)
    plt.close(fig)


def save_disparity(path: str, disparity, max_disparity=None):
    """Color-mapped disparity image (VisualizeImageData.disparity)."""
    plt = _plt()
    d = np.asarray(disparity, np.float64)
    if max_disparity is None:
        max_disparity = max(float(np.nanmax(d)), 1.0)
    fig, ax = plt.subplots(figsize=(d.shape[1] / 80, d.shape[0] / 80))
    im = ax.imshow(d, cmap="turbo", vmin=0, vmax=max_disparity)
    fig.colorbar(im, ax=ax, shrink=0.7)
    ax.set_axis_off()
    fig.savefig(path, bbox_inches="tight", dpi=80)
    plt.close(fig)


def save_point_cloud(path: str, points, colors=None, elev: float = -70.0,
                     azim: float = -90.0, size: float = 1.0):
    """3D scatter of a point cloud (PointCloudViewer analog)."""
    plt = _plt()
    p = np.asarray(points)
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    c = None if colors is None else np.asarray(colors)
    ax.scatter(p[:, 0], p[:, 2], p[:, 1], s=size, c=c)
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("y")
    fig.savefig(path, bbox_inches="tight", dpi=80)
    plt.close(fig)


def save_trajectory(path: str, centers, gt_centers=None):
    """Top-down (x, z) trajectory plot."""
    plt = _plt()
    c = np.asarray(centers)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(c[:, 0], c[:, 2], "b.-", label="estimate")
    if gt_centers is not None:
        g = np.asarray(gt_centers)
        ax.plot(g[:, 0], g[:, 2], "g.--", label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    fig.savefig(path, bbox_inches="tight", dpi=100)
    plt.close(fig)
