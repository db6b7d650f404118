"""Point-cloud visualisation to files (``geot_tpu/utils/vis3d.py``):
coloured PLY files (one colour per tooth class), side-by-side clouds, a
point's neighbours, and OBJ vertex lines with colours. The files are
byte-equal to ``geot_tpu``'s.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

# a qualitative 17-colour palette for the tooth classes
_PALETTE = np.array([
    [180, 180, 180], [230, 25, 75], [60, 180, 75], [255, 225, 25],
    [0, 130, 200], [245, 130, 48], [145, 30, 180], [70, 240, 240],
    [240, 50, 230], [210, 245, 60], [250, 190, 212], [0, 128, 128],
    [220, 190, 255], [170, 110, 40], [255, 250, 200], [128, 0, 0],
    [170, 255, 195]], dtype=np.uint8)


def _label_colors(labels: np.ndarray) -> np.ndarray:
    return _PALETTE[np.asarray(labels).astype(int) % len(_PALETTE)]


def save_ply(path: str, points: np.ndarray,
             colors: Optional[np.ndarray] = None,
             labels: Optional[np.ndarray] = None) -> str:
    """Write an ascii PLY of ``points`` (5 decimals); the vertex colours are
    ``colors`` or, without them, the palette's colour of each label."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    if colors is None and labels is not None:
        colors = _label_colors(labels)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if colors is not None:
            colors = np.asarray(colors).reshape(-1, 3).astype(np.uint8)
            for p, c in zip(points, colors):
                f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} "
                        f"{c[0]} {c[1]} {c[2]}\n")
        else:
            for p in points:
                f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
    return path


def vis_points(points, labels=None, colors=None, out: str = "points.ply"):
    """One cloud to a PLY file (``geot_tpu/utils/vis3d.py:50``)."""
    return save_ply(out, points, colors=colors, labels=labels)


def vis_multi_points(point_list: Sequence, colors=None, labels=None,
                     out_dir: str = "vis", prefix: str = "cloud",
                     save_fig: bool = False, save_name: str = "example",
                     point_size: float = 1.0, **_):
    """Clouds side by side (``:56``): a PLY file a cloud in ``out_dir``
    and, with ``save_fig``, a PNG of matplotlib 3-D scatter panels
    (matplotlib is imported there only)."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(point_list)
    colors = list(colors) if colors is not None else [None] * n
    labels = list(labels) if labels is not None else [None] * n
    paths = []
    for i, pts in enumerate(point_list):
        pts = np.asarray(pts)
        if pts.ndim == 3:
            pts = pts[0]
        paths.append(save_ply(os.path.join(out_dir, f"{prefix}_{i}.ply"),
                              pts, colors=colors[i], labels=labels[i]))
    if save_fig:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(4 * n, 4))
        for i, pts in enumerate(point_list):
            pts = np.asarray(pts)
            if pts.ndim == 3:
                pts = pts[0]
            ax = fig.add_subplot(1, n, i + 1, projection="3d")
            c = colors[i]
            if c is None and labels[i] is not None:
                c = _label_colors(labels[i]) / 255.0
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=point_size, c=c)
            ax.set_axis_off()
        png = os.path.join(out_dir, f"{save_name}.png")
        fig.savefig(png, dpi=120, bbox_inches="tight")
        plt.close(fig)
        paths.append(png)
    return paths


def vis_neighbors(points, neighbor_points, point_index,
                  out_dir: str = "vis", save_name: str = "neighbors"):
    """One point and its neighbours to a PLY file (``:99``): the cloud
    grey, the neighbours red, the point blue."""
    points = np.asarray(points).reshape(-1, 3)
    neigh = np.asarray(neighbor_points).reshape(-1, 3)
    colors = np.full((len(points), 3), 180, np.uint8)
    cloud = np.concatenate([points, neigh,
                            points[point_index:point_index + 1]])
    col = np.concatenate([colors,
                          np.tile([[230, 25, 75]], (len(neigh), 1)),
                          np.asarray([[0, 130, 200]])]).astype(np.uint8)
    os.makedirs(out_dir, exist_ok=True)
    return save_ply(os.path.join(out_dir, f"{save_name}.ply"), cloud,
                    colors=col)


def write_obj(points, colors, out_filename: str):
    """(N, 3) points and (N, 3) colours -> OBJ ``v x y z r g b`` lines
    (``:115``)."""
    points = np.asarray(points)
    colors = np.asarray(colors)
    with open(out_filename, "w") as f:
        for p, c in zip(points, colors):
            f.write(f"v {p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
    return out_filename


def read_obj(filename: str):
    """OBJ ``v`` lines -> (points (N, 3), colours (N, 3)) float32; a line
    without colours gets grey 0.5 (``:126``)."""
    pts, cols = [], []
    with open(filename) as f:
        for line in f:
            parts = line.strip().split()
            if parts and parts[0] == "v":
                vals = [float(x) for x in parts[1:]]
                pts.append(vals[:3])
                cols.append(vals[3:6] if len(vals) >= 6 else [0.5, 0.5, 0.5])
    return np.asarray(pts, np.float32), np.asarray(cols, np.float32)
