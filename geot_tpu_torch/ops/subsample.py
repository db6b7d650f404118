"""Host-side subsampling (``geot_tpu/ops/subsample.py`` and
``geot_tpu/native/__init__.py:89``).

``grid_subsample`` is voxel-grid pooling in numpy: the barycentre of the
points of each occupied voxel, their mean features and their majority
label, voxels in the order of their linearised coordinate, sums in
float64. ``grid_subsample_native`` is the same pooling in C++
(``csrc/grid_subsample.cpp``, a copy of ``geot_tpu``'s), built by
``_build.native_library()`` with ``g++`` at first use: voxels in the order
of their first point, features as float32, labels out of
``[0, num_classes)`` not counted. A failed build raises; nothing falls back
to numpy. ``random_sample`` draws point indices with numpy.
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import _build


def grid_subsample(points: np.ndarray, features: np.ndarray | None = None,
                   labels: np.ndarray | None = None, sample_dl: float = 0.1,
                   num_classes: int | None = None):
    """points (N, 3) [, features (N, F)][, labels (N,)] -> sub_points
    (V, 3) float32 [, mean features in their dtype][, majority labels
    int32]; a tuple when more than the points are asked for."""
    points = np.asarray(points, dtype=np.float32)
    origin = points.min(axis=0)
    coords = np.floor((points - origin) / sample_dl).astype(np.int64)
    dims = coords.max(axis=0) + 1
    lin = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    uniq, inv, counts = np.unique(lin, return_inverse=True,
                                  return_counts=True)
    V = uniq.shape[0]
    sub_points = np.zeros((V, 3), dtype=np.float64)
    np.add.at(sub_points, inv, points)
    out = [(sub_points / counts[:, None]).astype(np.float32)]
    if features is not None:
        features = np.asarray(features)
        sub_feat = np.zeros((V, features.shape[1]), dtype=np.float64)
        np.add.at(sub_feat, inv, features)
        out.append((sub_feat / counts[:, None]).astype(features.dtype))
    if labels is not None:
        labels = np.asarray(labels).astype(np.int64)
        C = num_classes if num_classes is not None else int(labels.max()) + 1
        hist = np.zeros((V, C), dtype=np.int64)
        np.add.at(hist, (inv, labels), 1)
        out.append(hist.argmax(axis=1).astype(np.int32))
    return out[0] if len(out) == 1 else tuple(out)


def grid_subsample_native(points: np.ndarray, features=None, labels=None,
                          sample_dl: float = 0.1, num_classes: int = 17):
    """``grid_subsample`` by the C++ library; the same outputs as
    ``geot_tpu``'s native path, bit for bit."""
    lib = _build.native_library()
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    points = np.ascontiguousarray(points, dtype=np.float32)
    n = len(points)
    fdim = 0
    if features is not None:
        features = np.ascontiguousarray(features, dtype=np.float32)
        fdim = features.shape[1]
    if labels is not None:
        labels = np.ascontiguousarray(labels, dtype=np.int32)
    out_p = np.empty((n, 3), dtype=np.float32)
    out_f = (np.empty((n, fdim), dtype=np.float32)
             if features is not None else None)
    out_l = np.empty((n,), dtype=np.int32) if labels is not None else None

    def ptr(a, kind):
        return a.ctypes.data_as(kind) if a is not None else kind()

    got = lib.grid_subsample(ptr(points, fp), n, fdim, ptr(features, fp),
                             ptr(labels, ip), num_classes, sample_dl,
                             ptr(out_p, fp), ptr(out_f, fp), ptr(out_l, ip),
                             n)
    if got < 0:
        raise RuntimeError(f"grid_subsample: {-got} voxels for {n} points")
    outs = [out_p[:got]] + [o[:got] for o in (out_f, out_l) if o is not None]
    return outs[0] if len(outs) == 1 else tuple(outs)


def random_sample(num_points: int, npoint: int,
                  rng: np.random.Generator | None = None) -> np.ndarray:
    """``npoint`` indices of ``num_points``, with replacement only when
    there are fewer points than asked for."""
    rng = rng or np.random.default_rng()
    return rng.choice(num_points, npoint, replace=num_points < npoint)
