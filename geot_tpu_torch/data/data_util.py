"""Dataset utilities (``geot_tpu/data/data_util.py``, numpy only, kept here
so the port does not import the JAX package): the per-item generator of
every dataset, feature concatenation, inverse-frequency class weights, the
view rotations of the multi-view pretraining datasets, and the voxel-grid
sampling of the scene pipelines (hashes, ``voxelize``, ``crop_pc``).

Every function draws and computes as ``geot_tpu``'s does, so its results
are bit-equal for the same inputs and generator state. ``download_url`` is
not ported: the port fetches nothing.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class EpochSeededRNG:
    """Per-``(seed, epoch, idx)`` item generator (``:7``): the loader's
    ``set_epoch`` bumps ``epoch``, so augmentations vary by epoch and stay
    deterministic."""

    seed = 0
    epoch = 0

    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self.epoch, idx))


def get_features_by_keys(data, keys: str = "pos,x"):
    """The entries ``keys`` (comma separated) of ``data`` concatenated on
    the last axis (channels last); one key gives its entry as it is. Numpy
    arrays stay numpy, tensors go through ``torch.cat``."""
    key_list = keys.split(",")
    if len(key_list) == 1:
        return data[keys]
    arrays = [data[k] for k in key_list]
    if isinstance(arrays[0], np.ndarray):
        return np.concatenate(arrays, axis=-1)
    return torch.cat(arrays, dim=-1)


def get_class_weights(num_per_class, normalize: bool = False) -> np.ndarray:
    """Inverse-frequency class weights ``1 / (share + 0.02)``, rescaled to
    sum to the class count with ``normalize``; float32."""
    num_per_class = np.asarray(num_per_class, dtype=np.float64)
    weight = num_per_class / num_per_class.sum()
    w = 1.0 / (weight + 0.02)
    if normalize:
        w = w * len(w) / w.sum()
    return w.astype(np.float32)


def rotate_angle_vector(theta: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rodrigues rotation matrices about the axes ``v`` by the angles
    ``theta``: theta (B, 1), v (B, 3) -> (B, 3, 3) float32."""
    cos_a = np.cos(theta)
    sin_a = np.sin(theta)
    x, y, z = v[:, 0:1], v[:, 1:2], v[:, 2:3]
    rows = [
        np.concatenate([cos_a + (1 - cos_a) * x * x,
                        (1 - cos_a) * x * y - sin_a * z,
                        (1 - cos_a) * x * z + sin_a * y], axis=-1),
        np.concatenate([(1 - cos_a) * y * x + sin_a * z,
                        cos_a + (1 - cos_a) * y * y,
                        (1 - cos_a) * y * z - sin_a * x], axis=-1),
        np.concatenate([(1 - cos_a) * z * x - sin_a * y,
                        (1 - cos_a) * z * y + sin_a * x,
                        cos_a + (1 - cos_a) * z * z], axis=-1),
    ]
    return np.stack(rows, axis=1).astype(np.float32)


def rotate_theta_phi(angles: np.ndarray) -> np.ndarray:
    """View rotation matrices: angles (B, 2) = (theta, phi) in radians ->
    (B, 3, 3) float32 inverse view rotations, a turn of -theta about z
    times a turn of -phi about the axis (sin theta, -cos theta, 0)."""
    angles = np.asarray(angles, dtype=np.float64)
    if angles.ndim != 2 or angles.shape[1] != 2:
        raise ValueError(f"angles must be (B, 2), got {angles.shape}")
    B = angles.shape[0]
    theta, phi = angles[:, 0:1], angles[:, 1:2]
    v1 = np.broadcast_to(np.array([[0.0, 0.0, 1.0]]), (B, 3))
    v2 = np.concatenate([np.sin(theta), -np.cos(theta),
                         np.zeros_like(theta)], axis=-1)
    r1_inv = rotate_angle_vector(-theta, v1)
    r2_inv = rotate_angle_vector(-phi, v2)
    return (r1_inv @ r2_inv).astype(np.float32)


def draw_views(rng: np.random.Generator, table: np.ndarray, n_views: int,
               random_view: bool = False):
    """A multi-view item's ``(view_ids, views)``: ``n_views`` distinct rows
    of the view table, or with ``random_view`` one random (theta, phi)
    view (id 0), drawn from ``rng`` as ``geot_tpu``'s datasets draw them."""
    if random_view:
        if n_views != 1:
            raise ValueError("random_view needs n_views == 1")
        angles = np.array([[(rng.random() - 0.5), rng.random() * 2.0]])
        return np.array([0]), rotate_theta_phi(angles * np.pi)
    view_ids = rng.choice(len(table), n_views, replace=False)
    return view_ids, table[view_ids]


def fnv_hash_vec(arr: np.ndarray) -> np.ndarray:
    """FNV64-1A over the integer columns of each row (N, C) -> (N,)
    uint64."""
    if arr.ndim != 2:
        raise ValueError(f"fnv_hash_vec: (N, C) expected, got {arr.shape}")
    arr = arr.copy().astype(np.uint64, copy=False)
    hashed = np.uint64(14695981039346656037) * np.ones(arr.shape[0],
                                                       dtype=np.uint64)
    for j in range(arr.shape[1]):
        hashed *= np.uint64(1099511628211)
        hashed = np.bitwise_xor(hashed, arr[:, j])
    return hashed


def ravel_hash_vec(arr: np.ndarray) -> np.ndarray:
    """The row-major index of each min-shifted integer row in the box of
    the rows' extents (N, C) -> (N,) uint64."""
    if arr.ndim != 2:
        raise ValueError(f"ravel_hash_vec: (N, C) expected, got {arr.shape}")
    arr = arr.copy()
    arr -= arr.min(0)
    arr = arr.astype(np.uint64, copy=False)
    arr_max = arr.max(0).astype(np.uint64) + 1
    keys = np.zeros(arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1] - 1):
        keys += arr[:, j]
        keys *= arr_max[j + 1]
    keys += arr[:, -1]
    return keys


def voxelize(coord: np.ndarray, voxel_size=0.05, hash_type: str = "fnv",
             mode: int = 0, rng: Optional[np.random.Generator] = None):
    """Voxel-grid sampling of ``coord`` (N, 3) on cells of ``voxel_size``,
    hashed by ``fnv_hash_vec`` (or ``ravel_hash_vec`` for ``"ravel"``).

    mode 0: one point a voxel, drawn from ``rng`` -> its indices.
    mode 1: ``(idx_sort, voxel_idx, count)``, the points sorted by voxel,
    each point's voxel and each voxel's count, for round-robin covers."""
    rng = rng or np.random.default_rng()
    discrete = np.floor(coord / np.array(voxel_size))
    key = ravel_hash_vec(discrete) if hash_type == "ravel" \
        else fnv_hash_vec(discrete)
    idx_sort = np.argsort(key)
    key_sort = key[idx_sort]
    _, voxel_idx, count = np.unique(key_sort, return_counts=True,
                                    return_inverse=True)
    if mode == 0:
        starts = np.cumsum(np.insert(count, 0, 0)[:-1])
        idx_select = starts + rng.integers(0, count.max(), count.size) % count
        return idx_sort[idx_select]
    return idx_sort, voxel_idx, count


def crop_pc(coord, feat, label, split: str = "train", voxel_size=0.04,
            voxel_max=None, downsample: bool = True, variable: bool = True,
            shuffle: bool = True, rng: Optional[np.random.Generator] = None):
    """Voxel-downsample (``voxelize`` mode 0), then keep the ``voxel_max``
    points nearest a random point (a split named ``train``) or the middle
    one (others), or, with ``variable`` off, pad a smaller cloud to
    ``voxel_max`` with drawn repeats; shuffle with ``shuffle``; shift the
    cloud's minimum to 0. Returns (coord float32, feat float32 or None,
    label int64 or None)."""
    rng = rng or np.random.default_rng()
    if voxel_size and downsample:
        coord = coord - coord.min(0)
        uniq = voxelize(coord, voxel_size, rng=rng)
        coord = coord[uniq]
        feat = feat[uniq] if feat is not None else None
        label = label[uniq] if label is not None else None
    if voxel_max is not None:
        N = len(coord)
        crop_idx = None
        if N >= voxel_max:
            init_idx = rng.integers(N) if "train" in split else N // 2
            crop_idx = np.argsort(
                np.square(coord - coord[init_idx]).sum(1))[:voxel_max]
        elif not variable:
            pad = rng.choice(N, voxel_max - N)
            crop_idx = np.hstack([np.arange(N), pad])
        if crop_idx is None:
            crop_idx = np.arange(len(coord))
        if shuffle:
            crop_idx = crop_idx[rng.permutation(len(crop_idx))]
        coord = coord[crop_idx]
        feat = feat[crop_idx] if feat is not None else None
        label = label[crop_idx] if label is not None else None
    coord = coord - coord.min(0)
    return (coord.astype(np.float32),
            feat.astype(np.float32) if feat is not None else None,
            label.astype(np.int64) if label is not None else None)


def rotate_point_clouds_batch(pc, rotation_matrix, use_normals: bool = False):
    """``pc`` (B, N, 3) (or (B, N, 6) with normals) turned by each cloud's
    ``rotation_matrix`` (B, 3, 3): ``einsum('bnc,bdc->bnd')`` on the points
    and, with ``use_normals``, on the normals. Numpy in, numpy out; a
    tensor in, a tensor on its device out."""
    if isinstance(pc, np.ndarray):
        einsum, cat = np.einsum, np.concatenate
        R = rotation_matrix.astype(pc.dtype)
    else:
        einsum, cat = torch.einsum, torch.cat
        R = torch.as_tensor(rotation_matrix).to(pc.device, pc.dtype)
    if not use_normals:
        return einsum("bnc,bdc->bnd", pc, R)
    new_pc = einsum("bnc,bdc->bnd", pc[:, :, :3], R)
    new_nrm = einsum("bnc,bdc->bnd", pc[:, :, 3:], R)
    return cat([new_pc, new_nrm], -1)
