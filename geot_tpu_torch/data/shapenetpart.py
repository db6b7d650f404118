"""The heritage benchmark datasets (``geot_tpu/data/shapenetpart.py``):
of the classification and part segmentation tasks, ``ShapeNetPart`` (h5;
the category one-hot as every point's features, ``trainval`` translated
and shuffled), ``ShapeNetPartCurve`` (h5; ``pos``, ``cls``, ``y``),
``ShapeNetPartNormal`` (txt with normals; ``class_choice``, ``multihead``
and ``presample``) and ``ScanObjectNN`` (h5; the
objectbg/objectonly/hardest modes, ``x`` = ``pos`` and the height above the
lowest point); of the pretraining stage, ``ShapeNet`` (and its other name
``ShapeNet55``: PLY clouds and multi-view JPG renders, 64 synthetic clouds
with depth-splat renders without a tree).

Each reads its public distribution when ``data_root`` is a directory and
otherwise gives the same deterministic synthetic clouds as ``geot_tpu``
(64 ScanObjectNN and ShapeNet items, 32 ShapeNetPart items). Items draw
from the same ``(seed, epoch, idx)`` generator as there
(``EpochSeededRNG``), so an item is bit-equal to ``geot_tpu``'s. ``h5py``
is imported only to read a real h5 tree; where it is missing such a tree
raises ``ImportError``.

``ShapeNetPartNormal(presample=True)`` samples every shape once to
``num_points`` with FPS (``ops.fps``: the custom op ``geot::fps``, the
cluster kernel on a CUDA device) on ``device`` and caches the result in
``<data_root>/processed/<split>_<num_points>_fps.pkl``, the file
``geot_tpu`` writes.
"""
from __future__ import annotations

import glob
import json
import os
import pickle

import numpy as np

from .data_util import EpochSeededRNG, draw_views, rotate_theta_phi
from .io import IO
from .tooth_pretrain import _splat_render

CLASSES16 = ['airplane', 'bag', 'cap', 'car', 'chair', 'earphone', 'guitar',
             'knife', 'lamp', 'laptop', 'motorbike', 'mug', 'pistol',
             'rocket', 'skateboard', 'table']
SEG_NUM = [4, 2, 2, 4, 4, 3, 3, 2, 4, 2, 6, 2, 3, 3, 3, 3]
PART_START = [0, 4, 6, 8, 12, 16, 19, 22, 24, 28, 30, 36, 38, 41, 44, 47]
SHAPENETPART_CLS2PARTS = [
    [0, 1, 2, 3], [4, 5], [6, 7], [8, 9, 10, 11], [12, 13, 14, 15],
    [16, 17, 18], [19, 20, 21], [22, 23], [24, 25, 26, 27], [28, 29],
    [30, 31, 32, 33, 34, 35], [36, 37], [38, 39, 40], [41, 42, 43],
    [44, 45, 46], [47, 48, 49],
]


def _cls2partembed() -> np.ndarray:
    """(16, 50) float32: row c is 1 at category c's parts."""
    e = np.zeros((16, 50), np.float32)
    for i, parts in enumerate(SHAPENETPART_CLS2PARTS):
        e[i, parts] = 1.0
    return e


def _translate_pointcloud(pc, rng):
    """Anisotropic scale in [2/3, 3/2] and shift in [-0.2, 0.2] per axis."""
    xyz1 = rng.uniform(2.0 / 3.0, 3.0 / 2.0, 3)
    xyz2 = rng.uniform(-0.2, 0.2, 3)
    return (pc * xyz1 + xyz2).astype(np.float32)


def translate_pointcloud(pointcloud, rng=None):
    return _translate_pointcloud(pointcloud, rng or np.random.default_rng())


def jitter_pointcloud(pointcloud, sigma=0.01, clip=0.02, rng=None):
    """Gaussian noise of ``sigma`` clipped to ``clip``."""
    rng = rng or np.random.default_rng()
    n, c = pointcloud.shape
    return pointcloud + np.clip(sigma * rng.standard_normal((n, c)),
                                -clip, clip).astype(pointcloud.dtype)


def rotate_pointcloud(pointcloud, rng=None):
    """A random rotation in the (x, z) plane."""
    rng = rng or np.random.default_rng()
    theta = np.pi * 2 * rng.uniform()
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]], pointcloud.dtype)
    out = pointcloud.copy()
    out[:, [0, 2]] = out[:, [0, 2]] @ rot
    return out


def _synth_part(idx, num_points):
    """The synthetic shape ``idx``: (pos, normals, category, part labels)."""
    g = np.random.default_rng(idx)
    pos = g.standard_normal((num_points, 3)).astype(np.float32)
    normals = g.standard_normal((num_points, 3)).astype(np.float32)
    cls = idx % 16
    y = g.choice(SHAPENETPART_CLS2PARTS[cls], num_points).astype(np.int64)
    return pos, normals, cls, y


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading an h5 dataset tree needs the h5py "
                          "package, which is not installed") from e
    return h5py


def _load_h5_partseg(partition, data_root):
    """The split's h5 shards concatenated in name order (``trainval``: the
    train shards, then the val ones): (data, label, pid)."""
    h5py = _h5py()
    if partition == "trainval":
        files = (glob.glob(os.path.join(data_root, "*train*.h5"))
                 + glob.glob(os.path.join(data_root, "*val*.h5")))
    else:
        files = glob.glob(os.path.join(data_root, f"*{partition}*.h5"))
    data, label, seg = [], [], []
    for name in sorted(files):
        with h5py.File(name, "r") as f:
            data.append(np.asarray(f["data"], dtype=np.float32))
            label.append(np.asarray(f["label"], dtype=np.int64))
            seg.append(np.asarray(f["pid"], dtype=np.int64))
    return (np.concatenate(data), np.concatenate(label), np.concatenate(seg))


class _PartsegH5Base(EpochSeededRNG):
    """What ``ShapeNetPart`` and ``ShapeNetPartCurve`` share: the h5 split
    (or 32 synthetic shapes), ``class_choice`` filtering."""

    def __init__(self, data_root="", num_points=2048, split="train",
                 class_choice=None, shape_classes=16, transform=None,
                 **kwargs):
        self.num_points = num_points
        self.partition = split
        self.transform = transform
        self.seed = int(kwargs.get("seed", 0))
        self.eye = np.eye(shape_classes, dtype=np.float32)
        self.cat2id = {c if c != "motorbike" else "motor": i
                       for i, c in enumerate(CLASSES16)}
        self.seg_num, self.index_start = SEG_NUM, PART_START
        self.synthetic = not (data_root and os.path.isdir(data_root))
        if self.synthetic:
            self.data = self.label = self.seg = None
            self.n = 32
        else:
            self.data, self.label, self.seg = _load_h5_partseg(split,
                                                               data_root)
            if class_choice is not None:
                cid = self.cat2id[class_choice]
                keep = (self.label == cid).squeeze()
                self.data, self.label, self.seg = \
                    self.data[keep], self.label[keep], self.seg[keep]
                self.seg_num_all = self.seg_num[cid]
                self.seg_start_index = self.index_start[cid]
            else:
                self.seg_num_all, self.seg_start_index = 50, 0
            self.n = len(self.data)

    def __len__(self):
        return self.n

    def _item(self, idx):
        if self.synthetic:
            pos, _, cls, seg = _synth_part(idx, self.num_points)
            return pos, np.int64(cls), seg
        pos = self.data[idx][:self.num_points].copy()
        seg = self.seg[idx][:self.num_points].copy()
        return pos, self.label[idx].astype(np.int64), seg


class ShapeNetPart(_PartsegH5Base):
    """h5 part segmentation: ``x`` is the 16-category one-hot at every
    point (no ``cls`` entry); ``trainval`` items are translated and
    shuffled."""

    cls2parts = SHAPENETPART_CLS2PARTS

    def __getitem__(self, idx):
        rng = self._rng(idx)
        pos, cls, seg = self._item(idx)
        if self.partition == "trainval":
            pos = _translate_pointcloud(pos, rng)
            order = rng.permutation(len(pos))
            pos, seg = pos[order], seg[order]
        onehot = self.eye[int(np.ravel(cls)[0])]
        feat = np.broadcast_to(onehot, (len(pos), len(onehot))).copy()
        data = {"pos": pos, "x": feat, "y": seg}
        if self.transform is not None:
            data = self.transform(data, rng)
        return data


class ShapeNetPartCurve(_PartsegH5Base):
    """h5 part segmentation, CurveNet's items: ``pos``, ``cls``, ``y``,
    shuffled in a training split; ``x`` only where a transform adds
    ``heights``."""

    cls2parts = SHAPENETPART_CLS2PARTS

    def __getitem__(self, idx):
        rng = self._rng(idx)
        pos, cls, seg = self._item(idx)
        if "train" in self.partition:
            order = rng.permutation(len(pos))
            pos, seg = pos[order], seg[order]
        data = {"pos": pos, "cls": np.ravel(cls).astype(np.int64), "y": seg}
        if self.transform is not None:
            data = self.transform(data, rng)
        if "heights" in data:
            data["x"] = data["heights"]
        return data


class ShapeNetPartNormal(EpochSeededRNG):
    """txt part segmentation with normals: ``x`` is ``pos`` and the normals
    (``pos`` alone without ``use_normal``), ``cls`` the category, ``y``
    the part labels (minus the category's first part with
    ``multihead``). A training split draws ``num_points`` points with
    replacement; another keeps the first ``num_points``; ``presample``
    takes the FPS sample cached on ``device``."""

    num_classes = 50
    shape_classes = 16
    classes = CLASSES16
    seg_num = SEG_NUM
    part_start = PART_START
    cls2parts = SHAPENETPART_CLS2PARTS
    cls2partembed = _cls2partembed()

    def __init__(self, data_root="", num_points=2048, split="train",
                 transform=None, use_normal=True, class_choice=None,
                 presample=False, multihead=False, device="cuda",
                 **kwargs):
        self.num_points = num_points
        self.split = split
        self.transform = transform
        self.seed = int(kwargs.get("seed", 0))
        self.use_normal = use_normal
        self.multihead = multihead
        self.presample = presample
        self.synthetic = not (data_root and os.path.isdir(data_root))
        if self.synthetic:
            self.items = list(range(32))
            if class_choice is not None:
                cid = CLASSES16.index(class_choice)
                self.items = [i for i in self.items if i % 16 == cid]
            return
        with open(os.path.join(data_root, "synsetoffset2category.txt")) as f:
            cat = dict(line.strip().split() for line in f if line.strip())
        self.classes_map = {c: i for i, c in enumerate(cat)}
        if class_choice is not None:
            cat = {k: v for k, v in cat.items() if k in class_choice}
        ids = {}
        for s in ("train", "val", "test"):
            with open(os.path.join(data_root, "train_test_split",
                                   f"shuffled_{s}_file_list.json")) as f:
                ids[s] = {d.split("/")[2] for d in json.load(f)}
        wanted = ((ids["train"] | ids["val"]) if split == "trainval"
                  else ids[split])
        self.items = []
        for item, synset in cat.items():
            d = os.path.join(data_root, synset)
            for fn in sorted(os.listdir(d)):
                if os.path.splitext(fn)[0] in wanted:
                    self.items.append((item, os.path.join(d, fn)))
        if presample:
            self._presample(data_root, device)

    def _presample(self, data_root, device):
        """Read the cached FPS sample, or make it: each shape's first
        ``min(num_points, len)`` FPS indices on ``device``, then pickled."""
        fname = os.path.join(data_root, "processed",
                             f"{self.split}_{self.num_points}_fps.pkl")
        if os.path.exists(fname):
            with open(fname, "rb") as f:
                self.pre_data, self.pre_cls = pickle.load(f)
            return
        import torch

        from ..core.config import resolve_device
        from ..ops import fps

        device = resolve_device(device)
        self.pre_data, self.pre_cls = [], []
        for item, path in self.items:
            raw = np.loadtxt(path).astype(np.float32)
            xyz = torch.from_numpy(np.ascontiguousarray(raw[None, :, :3]))
            idx = fps(xyz.to(device), min(self.num_points, len(raw)))
            self.pre_data.append(raw[idx[0].cpu().numpy()])
            self.pre_cls.append(np.asarray([self.classes_map[item]],
                                           np.int64))
        os.makedirs(os.path.dirname(fname), exist_ok=True)
        with open(fname, "wb") as f:
            pickle.dump((self.pre_data, self.pre_cls), f)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        rng = self._rng(idx)
        if self.synthetic:
            pos, normals, cls, y = _synth_part(self.items[idx],
                                               self.num_points)
        elif self.presample:
            raw, cls = self.pre_data[idx], int(self.pre_cls[idx][0])
            pos, normals = raw[:, :3], raw[:, 3:6]
            y = raw[:, 6].astype(np.int64)
        else:
            item, path = self.items[idx]
            raw = np.loadtxt(path).astype(np.float32)
            cls = self.classes_map[item]
            if "train" in self.split:
                sel = rng.choice(len(raw), self.num_points, replace=True)
            else:
                sel = np.arange(min(self.num_points, len(raw)))
            raw = raw[sel]
            pos, normals = raw[:, :3], raw[:, 3:6]
            y = raw[:, 6].astype(np.int64)
        if self.multihead:
            y = y - self.part_start[int(cls)]
        data = {"pos": pos, "y": y, "cls": np.asarray([cls], dtype=np.int64)}
        data["x"] = (np.concatenate([pos, normals], axis=-1)
                     if self.use_normal else pos)
        if self.transform is not None:
            data = self.transform(data, rng)
        return data


class ShapeNet(EpochSeededRNG):
    """Multi-view render pretraining over ShapeNet55
    (``geot_tpu/data/shapenetpart.py:307``), the ShapeNet counterpart of
    ``tooth_6000``: an item holds ``pos`` (the cloud, centred and scaled to
    the unit sphere), ``x`` (``pos`` and the height above the untransformed
    cloud's lowest point along ``gravity_dim``), ``views`` (``n_views``
    (3, 3) rotations drawn without replacement from the 12-view table at
    phi = (-1/2 + 1/6) pi, or one random view with ``random_view``) and
    ``imgs`` ((n_views, H, W, 3) renders in [0, 1]).

    With ``data_root`` a directory, the clouds are the PLY files of
    ``<data_root>/pointclouds[_p2048]/<train and val | test>`` (the
    ``sample_pc`` output), read by ``io.IO`` and rolled to [z, x, y], and
    the renders their ``shapenet55v1`` JPGs, read by PIL (imported there
    only: without it such a tree raises ``ImportError``). Otherwise 64
    seeded gaussian clouds and depth splats of ``img_size`` square stand in
    (the renders must match the decoder's output size)."""

    total_views = 12
    # items carry renders and views, no labels: the pretraining stage only
    PRETRAIN_ONLY = True

    def __init__(self, data_dir="", data_root="", n_views: int = 2,
                 num_points=1024, split="train", gravity_dim: int = 2,
                 transform=None, random_view: bool = False,
                 img_size: int = 32, **kwargs):
        root = data_dir or data_root
        self.num_points = num_points
        self.img_size = int(img_size)
        self.n_views = int(n_views)
        self.gravity_dim = int(gravity_dim)
        self.transform = transform
        self.seed = int(kwargs.get("seed", 0))
        self.random_view = bool(random_view)
        theta = np.linspace(0.0, 2.0, self.total_views + 1)[:self.total_views]
        angles = np.stack([theta, np.full_like(theta, -1 / 2 + 1 / 6)],
                          axis=-1) * np.pi
        self.rotation_matrixs = rotate_theta_phi(angles)
        self.synthetic = not (root and os.path.isdir(root))
        if self.synthetic:
            self.file_list = list(range(64))
        else:
            subsets = ["train", "val"] if split == "train" else ["test"]
            self.file_list = []
            for s in subsets:
                d = os.path.join(root, self._sub, s)
                self.file_list += sorted(os.path.join(d, f)
                                         for f in os.listdir(d))

    @property
    def _sub(self) -> str:
        return ("pointclouds_p2048" if self.num_points == 2048
                else "pointclouds")

    def __len__(self):
        return len(self.file_list)

    def _points(self, idx):
        if self.synthetic:
            pts = np.random.default_rng(idx).standard_normal(
                (self.num_points, 3)).astype(np.float32)
        else:
            pts = IO.get(self.file_list[idx]).astype(np.float32)
            pts = pts[:, [2, 0, 1]]
        c = pts.mean(0)
        pts = pts - c
        m = np.sqrt((pts ** 2).sum(1)).max()
        return (pts / max(m, 1e-12)).astype(np.float32)

    def _imgs(self, idx, view_ids, views, pts):
        if self.synthetic:
            return np.stack([_splat_render(pts, v, self.img_size)
                             for v in views])
        paths = [self.file_list[idx].replace(self._sub, "shapenet55v1")
                 .replace(".ply", f"_{str(v + 1).zfill(3)}.jpg")
                 for v in view_ids]
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"ShapeNet: reading the render {paths[0]} "
                              f"needs PIL, which is not installed") from e
        return np.stack([np.asarray(Image.open(p).convert("RGB"),
                                    dtype=np.float32) / 255.0
                         for p in paths])

    def __getitem__(self, idx):
        rng = self._rng(idx)
        pts = self._points(idx)
        data = {"pos": pts}
        if self.transform is not None:
            data = self.transform(data, rng)
        g = self.gravity_dim
        height = pts[:, g:g + 1] - pts[:, g:g + 1].min()
        data["x"] = np.concatenate([data["pos"], height], axis=-1)
        view_ids, views = draw_views(rng, self.rotation_matrixs,
                                     self.n_views, self.random_view)
        data["views"] = views.astype(np.float32)
        data["imgs"] = self._imgs(idx, view_ids, data["views"], data["pos"])
        return data


class ShapeNet55(ShapeNet):
    """The same dataset under its other name (``:401``)."""


class ScanObjectNN(EpochSeededRNG):
    """Real-scan classification into 15 classes: the h5 file of ``mode``
    (``objectbg``/``objectonly``: ``<split>_objectdataset.h5``;
    ``hardest``: ``..._augmentedrot_scale75.h5``), the first
    ``num_points`` points, shuffled in the train split; ``x`` is ``pos``
    and its height above the lowest point along axis 2."""

    num_classes = 15
    gravity_dim = 2

    def __init__(self, data_dir="", data_root="", num_points=2048,
                 split="train", mode: str = "hardest", transform=None,
                 **kwargs):
        root = data_dir or data_root
        self.num_points = num_points
        self.partition = split
        self.transform = transform
        self.seed = int(kwargs.get("seed", 0))
        self.synthetic = not (root and os.path.isdir(root))
        if self.synthetic:
            self.points = None
            self.items = list(range(64))
            return
        name = "training" if split == "train" else "test"
        if mode in ("objectbg", "objectonly"):
            h5 = os.path.join(root, f"{name}_objectdataset.h5")
        elif mode == "hardest":
            h5 = os.path.join(root,
                              f"{name}_objectdataset_augmentedrot_scale75.h5")
        else:
            raise NotImplementedError(f"ScanObjectNN mode {mode}")
        with _h5py().File(h5, "r") as f:
            self.points = np.asarray(f["data"]).astype(np.float32)
            self.labels = np.asarray(f["label"]).astype(np.int64)
        self.items = list(range(len(self.points)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        rng = self._rng(idx)
        if self.points is None:
            pos = np.random.default_rng(idx).standard_normal(
                (self.num_points, 3)).astype(np.float32)
            y = np.int64(idx % self.num_classes)
        else:
            pos = self.points[idx][:self.num_points].copy()
            y = self.labels[idx]
        if self.partition == "train":
            pos = pos[rng.permutation(len(pos))]
        data = {"pos": pos, "y": y}
        if self.transform is not None:
            data = self.transform(data, rng)
        g = self.gravity_dim
        if "heights" in data:
            data["x"] = np.concatenate([data["pos"], data["heights"]],
                                       axis=-1)
        else:
            h = pos[:, g:g + 1] - pos[:, g:g + 1].min()
            data["x"] = np.concatenate([data["pos"], h], axis=-1)
        return data
