"""The multi-view pretraining datasets, ``tooth_6000`` and
``tooth_6000_pca`` (``geot_tpu/data/tooth_pretrain.py:40-279``), and the
finetune and jaw-classification sets, ``TeethSegFinetuneDataset`` and
``TeethClsDataset`` (``:281-349``), on the port's ``_TeethBase`` with the
same numpy draws: an item is bit-equal to ``geot_tpu``'s for the same
``(seed, epoch, idx)``.

An item holds ``pos`` (the unit-sphere normalised cloud sampled to
``num_points``), ``x`` (``tooth_6000``: ``pos`` and the height above the
lowest point along ``gravity_dim``; ``tooth_6000_pca``: ``pos``),
``views`` (``n_views`` (3, 3) view rotations drawn without replacement
from the jaw's table, or one random view with ``random_view``), ``imgs``
((n_views, H, W, 3) renders in [0, 1], channels last), ``cls`` (the jaw)
and, in ``tooth_6000_pca``, ``weight``: the Sobel gradient magnitude of
each render's grey image as the loss's foreground weight.

With a manifest ``<data_root>/<split><manifest_suffix>`` (``pc_data``, the
clouds, read by ``io.IO``; ``rgb_data``, a directory of
``<cloud name>_<view>.png`` renders per cloud, read by ``png.read_png_rgb``;
optional ``filter_upper`` / ``filter_lower`` case ids to drop) the items
come from disk. Without one, the deterministic synthetic scans of
``tooth_semi`` (16 a split, or the Teeth3DS index when ``data_root`` has a
``data.json``) and orthographic depth splats of the view-rotated cloud
(``img_size`` square) stand in for them.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .data_util import rotate_theta_phi
from .io import IO
from .png import read_png_rgb
from .tooth_semi import _TeethBase, pc_norm

_SYN_IMG = 32   # the default synthetic render size


def _splat_render(pts: np.ndarray, view: np.ndarray, s: int) -> np.ndarray:
    """An orthographic depth splat of ``pts @ view.T`` on an ``s`` x ``s``
    white image: rows follow camera x, columns camera y (the generator's
    camera, ``ViewTransformer._scale_bias``), occupied pixels grey by
    their largest normalised depth."""
    rot = pts @ view.T.astype(pts.dtype)
    xy = rot[:, :2]
    mn = xy.min(0)
    extent = float(max((xy.max(0) - mn).max(), 1e-6))
    margin = max(s // 8, 1)
    pix = np.floor((xy - mn) * ((s - 1 - 2 * margin) / extent)).astype(
        np.int64)
    flat = np.clip(pix[:, 0] + margin, 0, s - 1) * s \
        + np.clip(pix[:, 1] + margin, 0, s - 1)
    z = rot[:, 2]
    znorm = ((z - z.min()) / max(float(z.max() - z.min()), 1e-6)).astype(
        np.float32)
    zbuf = np.zeros(s * s, np.float32)
    np.maximum.at(zbuf, flat, znorm + 1e-3)      # > 0 marks occupancy
    img = np.ones((s * s, 3), np.float32)
    occ = zbuf > 0
    img[occ] = (0.15 + 0.7 * (zbuf[occ, None] - 1e-3))
    return img.reshape(s, s, 3)


def _jaw_view_angles(phi_frac: float, total_views: int = 12) -> np.ndarray:
    """(total_views, 2) angles in radians: theta over the circle
    (``linspace(0, 2, V + 1)[:V]`` x pi) at one phi."""
    theta = np.linspace(0.0, 2.0, total_views + 1)[:total_views]
    angles = np.stack([theta, np.full_like(theta, phi_frac)], axis=-1)
    return angles * np.pi


# the PCA-aligned 9-view table
_PCA_THETA = np.array([0, 1, 2, 10, 11, 0, 0, 0, 0], dtype=np.float64) / 6.0
_PCA_PHI = np.array([90, 90, 90, 90, 90, 30, 60, 120, 150],
                    dtype=np.float64) / 180.0
_PCA_ANGLES = np.stack([_PCA_THETA, _PCA_PHI], axis=-1) * np.pi


def _sobel_weight(gray: np.ndarray) -> np.ndarray:
    """The 3 x 3 Sobel gradient magnitude of ``gray`` with reflect-101
    borders (cv2's default), min-max normalised, plus 0.1, capped at 1."""
    g = np.pad(gray.astype(np.float64), 1, mode="reflect")
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float64)
    ky = kx.T
    H, W = gray.shape
    sx = np.zeros((H, W), np.float64)
    sy = np.zeros((H, W), np.float64)
    for di in range(3):
        for dj in range(3):
            win = g[di:di + H, dj:dj + W]
            sx += kx[di, dj] * win
            sy += ky[di, dj] * win
    gm = np.sqrt(sx ** 2 + sy ** 2)
    gm = gm - gm.min()
    rng_ = gm.max() - gm.min()
    gm = gm / rng_ if rng_ > 0 else gm
    return np.clip(gm + 0.1, None, 1.0).astype(np.float32)


class _PretrainBase(_TeethBase):
    """What both datasets share; subclasses set ``total_views`` and the
    view tables."""

    total_views = 12

    def __init__(self, data_dir="", data_root="", n_views: int = 2,
                 num_points=16000, split="train", gravity_dim: int = 2,
                 transform=None, random_view: bool = False,
                 manifest_suffix: str = "_pca_0.5.json",
                 img_size: int = _SYN_IMG, **kwargs):
        # the synthetic render size: the generator's output resolution
        self.syn_img = int(img_size)
        root = data_dir or data_root
        self.manifest = None
        manifest_path = os.path.join(root or "", split + manifest_suffix)
        if root and os.path.isfile(manifest_path):
            with open(manifest_path) as f:
                self.manifest = json.load(f)
        has_semi_index = bool(root) and os.path.isfile(
            os.path.join(root, "data.json"))
        super().__init__(root if (self.manifest is None and has_semi_index)
                         else "", num_points, split, f"full_{split}.txt",
                         synthetic_len=16, **kwargs)
        if self.manifest is not None:
            self.synthetic = False
            self.pc_list = list(self.manifest["pc_data"])
            self.rgb_dir = list(self.manifest.get("rgb_data", []))
            self.cur_list = list(self.manifest.get("cur_data", []))
            self.depth_list = list(self.manifest.get("depth_data", []))
            self._apply_filter()
            self.file_list = [{"location": 0 if "lower" in
                               os.path.basename(p) else 1,
                               "file_path": p, "mesh_id": p}
                              for p in self.pc_list]
        self.n_views = int(n_views)
        self.gravity_dim = int(gravity_dim)
        self.transform = transform
        self.random_view = bool(random_view)
        # the jaw's tables: the lower jaw looks up, the upper down
        self.rot_lower = rotate_theta_phi(
            _jaw_view_angles(-1 / 2 + 1 / 6, self.total_views))
        self.rot_upper = rotate_theta_phi(
            _jaw_view_angles(1 / 2 - 1 / 6, self.total_views))

    def _apply_filter(self):
        """Drop the clouds whose case (``<dir name>[4:]`` as an int) the
        manifest's ``filter_upper`` / ``filter_lower`` list for their
        jaw."""
        if self.manifest is None or "filter_upper" not in self.manifest:
            return
        f_up = set(self.manifest["filter_upper"])
        f_lo = set(self.manifest["filter_lower"])
        keep = []
        for i, p in enumerate(self.pc_list):
            case = os.path.basename(os.path.dirname(p))
            tooth = os.path.basename(p)
            try:
                case_id = int(case[4:])
            except ValueError:
                keep.append(i)
                continue
            if case_id not in (f_up if "upper" in tooth else f_lo):
                keep.append(i)
        self.pc_list = [self.pc_list[i] for i in keep]
        for attr in ("rgb_dir", "cur_list", "depth_list"):
            lst = getattr(self, attr)
            if lst:
                setattr(self, attr, [lst[i] for i in keep])

    def _views_for(self, sample, rng):
        name = os.path.basename(str(sample["file_path"]))
        table = (self.rot_lower if "lower" in name or sample["location"] == 0
                 else self.rot_upper)
        if self.random_view:
            if self.n_views != 1:
                raise ValueError("random_view needs n_views == 1")
            angles = np.array([[(rng.random() - 0.5), rng.random() * 2.0]])
            return np.array([0]), rotate_theta_phi(angles * np.pi)
        view_ids = rng.choice(self.total_views, self.n_views, replace=False)
        return view_ids, table[view_ids]

    def _images(self, idx, sample, view_ids, views, pts):
        if self.manifest is not None and self.rgb_dir:
            name = os.path.basename(str(sample["file_path"]))[:-4]
            return np.stack([
                read_png_rgb(os.path.join(self.rgb_dir[idx],
                                          f"{name}_{v}.png"))
                for v in view_ids])
        return np.stack([_splat_render(pts, v, self.syn_img) for v in views])

    def _point_payload(self, idx, rng):
        sample = self.file_list[idx]
        if self.manifest is not None:
            points = IO.get(sample["file_path"]).astype(np.float32)
        else:
            points, _ = self._load(sample)
        points_norm, _, _ = pc_norm(points)
        n = len(points_norm)
        sel = rng.choice(n, self.num_points, replace=n < self.num_points)
        return sample, points_norm[sel].astype(np.float32)


class Tooth6000(_PretrainBase):
    """12 views a jaw; ``x`` carries the height above the lowest point."""

    total_views = 12

    def __getitem__(self, idx):
        rng = self._rng(idx)
        sample, pts = self._point_payload(idx, rng)
        data = {"pos": pts}
        if self.transform is not None:
            data = self.transform(data, rng)
        g = self.gravity_dim
        height = data["pos"][:, g:g + 1] - data["pos"][:, g:g + 1].min()
        data["x"] = np.concatenate([data["pos"], height], axis=-1)
        view_ids, views = self._views_for(sample, rng)
        data["views"] = views.astype(np.float32)
        data["imgs"] = self._images(idx, sample, view_ids, views,
                                    data["pos"])
        data["cls"] = np.asarray([sample["location"]], dtype=np.int64)
        return data


class Tooth6000PCA(_PretrainBase):
    """The PCA-aligned 9-view table for both jaws, ``x`` = ``pos``, and the
    Sobel ``weight`` maps; manifests ``<split>_pca_cur_0.5.json``."""

    total_views = 9

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("manifest_suffix", "_pca_cur_0.5.json")
        super().__init__(*args, **kwargs)
        table = rotate_theta_phi(_PCA_ANGLES)
        self.rot_lower = table
        self.rot_upper = table

    def __getitem__(self, idx):
        rng = self._rng(idx)
        sample, pts = self._point_payload(idx, rng)
        data = {"pos": pts}
        if self.transform is not None:
            data = self.transform(data, rng)
        data["x"] = data["pos"]
        view_ids, views = self._views_for(sample, rng)
        data["views"] = views.astype(np.float32)
        imgs = self._images(idx, sample, view_ids, views, data["pos"])
        data["imgs"] = imgs
        gray = imgs @ np.array([0.299, 0.587, 0.114], dtype=np.float32)
        data["weight"] = np.stack([_sobel_weight(g_) for g_ in gray])
        data["cls"] = np.asarray([sample["location"]], dtype=np.int64)
        return data


class TeethSegFinetuneDataset(_TeethBase):
    """The fully supervised finetune split
    (``geot_tpu/data/tooth_pretrain.py:281-312``): ``train`` reads the
    10 % label budget ``full_train_finetune_0.1.txt``, ``val`` and
    ``test`` ``full_<split>_finetune.txt``. An item is
    ``TeethSegSemiLDataset``'s: ``pos``, ``x``, ``y``, ``cls`` and
    ``class_weights``, and for ``val`` and ``test`` the full scan with its
    normalisation."""

    def __init__(self, data_root="", num_points=16000, split="train",
                 transform=None, **kwargs):
        list_name = (f"full_{split}_finetune_0.1.txt" if split == "train"
                     else f"full_{split}_finetune.txt")
        super().__init__(data_root, num_points, split, list_name, **kwargs)
        self.transform = transform

    def __getitem__(self, idx):
        sample = self.file_list[idx]
        rng = self._rng(idx)
        points, labels = self._load(sample)
        points_norm, center, scale = pc_norm(points)
        spts, slab = self._sample(points_norm, labels, rng)
        data = {"pos": spts, "x": spts, "y": slab,
                "cls": np.asarray([sample["location"]], dtype=np.int64),
                "class_weights": self._class_weights(slab)}
        if self.split in ("val", "test"):
            data.update(points=points.astype(np.float32),
                        labels=labels.astype(np.int64),
                        center=center.astype(np.float32),
                        scale=np.float32(scale))
        if self.transform is not None:
            data = self.transform(data, rng)
        return data


class TeethClsDataset(_TeethBase):
    """Jaw classification (``geot_tpu/data/tooth_pretrain.py:315-349``):
    ``y`` is the jaw (0 lower, 1 upper); the scan's axes are rolled
    (``points[:, [2, 0, 1]]``, the one tooth dataset that rolls them)
    before the unit-sphere normalisation; ``num_points`` drawn with
    replacement; ``x`` is ``pos`` and its height above the lowest point
    along axis 2. Lists ``full_<split>_finetune.txt``."""

    classes = ["lower", "upper"]
    gravity_dim = 2

    def __init__(self, data_root="", num_points=16000, split="train",
                 transform=None, **kwargs):
        super().__init__(data_root, num_points, split,
                         f"full_{split}_finetune.txt", **kwargs)
        self.num_classes = 2
        self.transform = transform

    def __getitem__(self, idx):
        sample = self.file_list[idx]
        rng = self._rng(idx)
        points, _ = self._load(sample)
        points_norm, _, _ = pc_norm(points[:, [2, 0, 1]])
        sel = rng.choice(len(points_norm), self.num_points, replace=True)
        spts = points_norm[sel].astype(np.float32)
        g = self.gravity_dim
        h = spts[:, g:g + 1] - spts[:, g:g + 1].min()
        data = {"pos": spts,
                "y": np.asarray([sample["location"]], dtype=np.int64),
                "x": np.concatenate([spts, h], axis=1)}
        if self.transform is not None:
            data = self.transform(data, rng)
        return data
