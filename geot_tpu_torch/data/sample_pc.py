"""Meshes to point clouds for the ShapeNet pretraining dataset
(``geot_tpu/data/sample_pc.py``): each ``.off`` mesh of
``<data_dir>/<split>`` is sampled on its surface, area-weighted, at
``init_factor`` times ``num_points`` points in numpy, thinned to
``num_points`` by farthest-point sampling (``ops.fps``: the custom op
``geot::fps``, the cluster kernel on a CUDA device, ``fps_ref`` on the
CPU), and written as a binary PLY to
``<data_dir>/pointclouds/<split>/<name>.ply``, the tree ``data.ShapeNet``
reads. The draws and the FPS indices are ``geot_tpu``'s, so the files are
byte-equal to the ones it writes. ``geot_tpu``'s optional open3d branch is
not taken.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.config import resolve_device


def read_off(path: str):
    """An OFF mesh -> (verts (V, 3) float32, faces (F, 3) int64): the
    counts on the header line (``OFF n m 0``) or on the next, polygons
    fan-triangulated."""
    with open(path, "r") as f:
        first = f.readline().strip()
        if first.startswith("OFF") and len(first) > 3:
            counts = first[3:].split()
        else:
            counts = f.readline().split()
        nv, nf = int(counts[0]), int(counts[1])
        verts = np.array([list(map(float, f.readline().split()))
                          for _ in range(nv)], dtype=np.float32)
        faces = []
        for _ in range(nf):
            row = list(map(int, f.readline().split()))
            for k in range(2, row[0]):
                faces.append((row[1], row[k], row[k + 1]))
    return verts, np.asarray(faces, dtype=np.int64)


def sample_mesh_poisson(verts: np.ndarray, faces: np.ndarray,
                        num_points: int, init_factor: int = 4,
                        rng: Optional[np.random.Generator] = None,
                        device: "str | torch.device" = "cuda"
                        ) -> np.ndarray:
    """``num_points * init_factor`` area-weighted uniform surface samples
    drawn from ``rng`` (``default_rng(0)`` without one), thinned to
    ``num_points`` by FPS on ``device`` (start at sample 0, ties to the
    smallest index) -> (num_points, 3) float32."""
    device = resolve_device(device)
    dense = dense_surface_samples(verts, faces, num_points * init_factor,
                                  rng or np.random.default_rng(0))

    from ..ops import fps

    idx = fps(torch.from_numpy(dense[None]).to(device), num_points)
    return dense[idx[0].cpu().numpy()]


def dense_surface_samples(verts: np.ndarray, faces: np.ndarray,
                          n_dense: int,
                          rng: np.random.Generator) -> np.ndarray:
    """``n_dense`` uniform samples of the surface (a face drawn by its
    area, then a point in it) -> (n_dense, 3) float32: what
    ``sample_mesh_poisson`` thins."""
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    prob = area / max(area.sum(), 1e-12)
    tri = rng.choice(len(faces), n_dense, p=prob)
    r1 = np.sqrt(rng.uniform(size=(n_dense, 1)))
    r2 = rng.uniform(size=(n_dense, 1))
    return ((1 - r1) * v0[tri] + r1 * (1 - r2) * v1[tri]
            + r1 * r2 * v2[tri]).astype(np.float32)


def _write_ply_xyz(path: str, pts: np.ndarray):
    """A binary little-endian PLY of float32 x, y, z vertices."""
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(pts)}\nproperty float x\n"
                 f"property float y\nproperty float z\nend_header\n")
                .encode("ascii"))
        f.write(np.ascontiguousarray(pts, dtype="<f4").tobytes())


def sample_pc(data_dir: str, num_points: int,
              splits=("train", "val", "test"),
              device: "str | torch.device" = "cuda"):
    """For each ``.off`` in ``<data_dir>/<split>`` (in name order), write
    ``<data_dir>/pointclouds/<split>/<name>.ply`` of ``num_points``
    points sampled on ``device``; a missing split directory is skipped."""
    device = resolve_device(device)
    save_dir = os.path.join(data_dir, "pointclouds")
    for split in splits:
        split_dir = os.path.join(data_dir, split)
        if not os.path.isdir(split_dir):
            continue
        out_dir = os.path.join(save_dir, split)
        os.makedirs(out_dir, exist_ok=True)
        for sample in sorted(os.listdir(split_dir)):
            if "off" not in sample:
                continue
            src = os.path.join(split_dir, sample)
            dst = os.path.join(out_dir, sample.replace("off", "ply"))
            verts, faces = read_off(src)
            pts = sample_mesh_poisson(verts, faces, num_points,
                                      device=device)
            _write_ply_xyz(dst, pts)
