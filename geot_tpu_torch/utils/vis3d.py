"""Point clouds to coloured PLY files (``geot_tpu/utils/vis3d.py:14-47``):
one colour per tooth class."""
from __future__ import annotations

from typing import Optional

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
