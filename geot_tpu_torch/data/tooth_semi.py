"""Teeth3DS data: the FDI label map, unit-sphere normalisation, the
deterministic synthetic scan, and the semi-supervised datasets.

Copies of ``geot_tpu/data/tooth_semi.py`` and ``data/data_util.py:7``
(numpy only), kept here so the port does not import the JAX package.

When ``data_root`` is a directory, the datasets read Teeth3DS from it as
``geot_tpu/data/tooth_semi.py:75-108`` does: ``data.json`` maps each split
line to its scan (``scans``) and its label file (``gt``), paths opened as
given (a relative one resolves against the working directory, not
``data_root``); the split lists are ``semi_l_<split>_<fraction>.txt``,
``semi_u_<split>_<fraction>.txt`` and, for ``val`` and ``test``,
``testing.txt``; a line ``<mesh_id>_<lower|upper>...`` gives the patient
and the jaw; labels go through ``FDI_LABEL_MAP`` (a code outside it
raises ``KeyError``). Otherwise they produce the deterministic synthetic
scans, and ``.synthetic`` is set.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .data_util import EpochSeededRNG
from .io import IO

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


class _TeethBase(EpochSeededRNG):
    def __init__(self, data_root: str, num_points: int, split: str,
                 list_name: str, synthetic_len: int = 24, seed: int = 0,
                 **kwargs):
        self.data_root = data_root
        self.num_points = num_points
        self.split = split
        self.num_classes = 17
        self.seed = seed
        self.epoch = 0
        self.synthetic = not (data_root and os.path.isdir(data_root))
        if self.synthetic:
            self.file_list = [{"location": i % 2,
                               "mesh_id": f"synthetic{i:04d}",
                               "file_path": f"synthetic{i:04d}",
                               "seed": 1000 + i}
                              for i in range(synthetic_len)]
            return
        with open(os.path.join(data_root, "data.json")) as f:
            index = json.load(f)
        self.pc_path = index["scans"]
        self.gt_path = index["gt"]
        with open(os.path.join(data_root, list_name)) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        self.file_list = []
        for line in lines:
            location = line.split("_")[1].split(".")[0]
            self.file_list.append({
                "location": 0 if location == "lower" else 1,
                "mesh_id": line.split("_")[0],
                "file_path": line,
            })

    def __len__(self):
        return len(self.file_list)

    def _load(self, sample):
        if self.synthetic:
            return _synthetic_scan(sample["seed"])
        points = IO.get(self.pc_path[sample["file_path"]]).astype(np.float32)
        raw = IO.get(self.gt_path[sample["file_path"]])["labels"]
        labels = np.asarray([FDI_LABEL_MAP[l] for l in raw], dtype=np.int32)
        return points, labels

    def _sample(self, points_norm, labels, rng):
        n = len(points_norm)
        sel = rng.choice(n, self.num_points, replace=n < self.num_points)
        return (points_norm[sel].astype(np.float32),
                labels[sel].astype(np.int64))

    @staticmethod
    def _class_weights(labels):
        """Per-sample class histogram fractions."""
        hist = np.bincount(labels, minlength=17)[:17].astype(np.float32)
        total = hist.sum()
        return hist / total if total > 0 else hist


class TeethSegSemiLDataset(_TeethBase):
    """Labelled split (``geot_tpu/data/tooth_semi.py:126``): the lines of
    ``semi_l_<split>_<label_fraction>.txt`` (``testing.txt`` for ``val``
    and ``test``), or 24 synthetic scans. A ``val`` or ``test`` item also carries the full-resolution scan
    (``points``, ``labels``), its normalisation (``center``, ``scale``) and
    its ``patient`` id, as ``geot_tpu/data/tooth_semi.py:148-155`` adds them
    for the three_nn evaluation."""

    def __init__(self, data_root="", num_points=16000, split="train",
                 transform=None, label_fraction: str = "0.2", **kwargs):
        list_name = (f"semi_l_{split}_{label_fraction}.txt"
                     if split == "train" else "testing.txt")
        super().__init__(data_root, num_points, split, list_name, **kwargs)
        self.transform = transform

    def __getitem__(self, idx):
        sample = self.file_list[idx]
        rng = self._rng(idx)
        points, labels = self._load(sample)
        points_norm, center, scale = pc_norm(points)
        spts, slab = self._sample(points_norm, labels, rng)
        data = {"pos": spts,
                "cls": np.asarray([sample["location"]], dtype=np.int64),
                "y": slab}
        data["x"] = data["pos"]
        data["class_weights"] = self._class_weights(slab)
        if self.transform is not None:
            data = self.transform(data, rng)
        if self.split in ("val", "test"):
            data["points"] = points.astype(np.float32)
            data["labels"] = labels.astype(np.int64)
            data["center"] = center.astype(np.float32)
            data["scale"] = np.float32(scale)
            data["patient"] = sample["mesh_id"]
        return data


class TeethSegSemiUDataset(_TeethBase):
    """Unlabelled split (``geot_tpu/data/tooth_semi.py:163``): the lines of
    ``semi_u_<split>_<label_fraction>.txt`` (``testing.txt`` for ``val``
    and ``test``), or 48 synthetic scans; each as a weak (``*_w``) and a strong (``*_s``) view of one
    sample, plus the untransformed ``raw_pos``."""

    def __init__(self, data_root="", num_points=16000, split="train",
                 transform_w=None, transform_s=None,
                 label_fraction: str = "0.2", **kwargs):
        list_name = (f"semi_u_{split}_{label_fraction}.txt"
                     if split == "train" else "testing.txt")
        super().__init__(data_root, num_points, split, list_name,
                         synthetic_len=48, **kwargs)
        self.transform_w = transform_w
        self.transform_s = transform_s

    def __getitem__(self, idx):
        sample = self.file_list[idx]
        rng = self._rng(idx)
        points, labels = self._load(sample)
        points_norm, _, _ = pc_norm(points)
        spts, slab = self._sample(points_norm, labels, rng)
        base = {"pos": spts,
                "cls": np.asarray([sample["location"]], dtype=np.int64),
                "y": slab}
        base["x"] = base["pos"]
        base["class_weights"] = self._class_weights(slab)
        data = dict(base)
        d_w = {k: (v.copy() if isinstance(v, np.ndarray) else v)
               for k, v in base.items()}
        d_s = {k: (v.copy() if isinstance(v, np.ndarray) else v)
               for k, v in base.items()}
        if self.transform_w is not None:
            d_w = self.transform_w(d_w, rng)
        if self.transform_s is not None:
            d_s = self.transform_s(d_s, rng)
        for k, v in d_w.items():
            data[k + "_w"] = v
        for k, v in d_s.items():
            data[k + "_s"] = v
        data["raw_pos"] = spts
        return data
