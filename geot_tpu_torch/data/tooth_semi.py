"""Teeth3DS helpers that serving needs: the FDI label map, unit-sphere
normalisation and the deterministic synthetic scan.

Copies of ``geot_tpu/data/tooth_semi.py:26-62`` (numpy only), kept here so
the port does not import the JAX package.
"""
from __future__ import annotations

import numpy as np

# FDI two-digit tooth codes -> 17 contiguous classes (gum = 0)
FDI_LABEL_MAP = {0: 0}
for q, base in ((11, 1), (21, 9), (31, 1), (41, 9)):
    for i in range(8):
        FDI_LABEL_MAP[q + i] = base + i


def pc_norm(pc: np.ndarray):
    """Unit-sphere normalisation returning (pc, centroid, scale)."""
    centroid = pc.mean(axis=0)
    pc = pc - centroid
    m = np.sqrt((pc ** 2).sum(axis=1)).max()
    return pc / m, centroid, m


def _synthetic_scan(seed: int, n_points: int = 40000):
    """Deterministic tooth-arch-like cloud with 17-class labels: gum band +
    16 tooth blobs along a parabolic arch."""
    rng = np.random.default_rng(seed)
    n_gum = n_points // 2
    t = rng.uniform(-1, 1, n_gum)
    gum = np.stack([t, 0.4 * t ** 2 + rng.normal(0, 0.05, n_gum),
                    rng.normal(0, 0.03, n_gum)], axis=1)
    labels = [np.zeros(n_gum, dtype=np.int32)]
    clouds = [gum]
    per_tooth = (n_points - n_gum) // 16
    for k in range(16):
        tc = -0.9 + (k + 0.5) * (1.8 / 16)
        center = np.array([tc, 0.4 * tc ** 2, 0.12])
        pts = center + rng.normal(0, 0.035, (per_tooth, 3))
        clouds.append(pts)
        labels.append(np.full(per_tooth, k + 1, dtype=np.int32))
    rest = n_points - n_gum - per_tooth * 16
    if rest > 0:
        clouds.append(rng.normal(0, 0.2, (rest, 3)))
        labels.append(np.zeros(rest, dtype=np.int32))
    return (np.concatenate(clouds).astype(np.float32), np.concatenate(labels))
