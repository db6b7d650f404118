"""Loaders (``geot_tpu/data/build.py``): an epoch-based loader with seeded
shuffling, ``drop_last``, per-rank sharding and a thread pool that loads
and collates the next ``num_workers`` batches ahead; the loaders of a
config's labelled and unlabelled datasets; and the copy of a batch onto the
device.

The rank and the number of ranks come from the caller (``geot_tpu`` asks
JAX for them, ``data/build.py:152``).
"""
from __future__ import annotations

import concurrent.futures as _fut
import copy
import itertools
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .shapenetpart import (ScanObjectNN, ShapeNet, ShapeNet55, ShapeNetPart,
                           ShapeNetPartCurve, ShapeNetPartNormal)
from .tooth_pretrain import (TeethClsDataset, TeethSegFinetuneDataset,
                             Tooth6000, Tooth6000PCA)
from .tooth_semi import TeethSegSemiLDataset, TeethSegSemiUDataset
from .transforms import build_transforms_from_cfg

# the keys a train step reads (geot_tpu/engine/train.py:_model_batch,
# _semi_batch)
MODEL_KEYS = ("pos", "x", "cls", "y", "class_weights")
SEMI_KEYS = ("pos_w", "x_w", "cls_w", "pos_s", "x_s", "cls_s", "raw_pos",
             "y")

DATASETS = {"TeethSegSemiLDataset": TeethSegSemiLDataset,
            "TeethSegSemiUDataset": TeethSegSemiUDataset,
            "TeethSegFinetuneDataset": TeethSegFinetuneDataset,
            "TeethClsDataset": TeethClsDataset,
            "tooth_6000": Tooth6000, "tooth_6000_pca": Tooth6000PCA,
            "ShapeNetPart": ShapeNetPart,
            "ShapeNetPartCurve": ShapeNetPartCurve,
            "ShapeNetPartNormal": ShapeNetPartNormal,
            "ShapeNet": ShapeNet, "ShapeNet55": ShapeNet55,
            "ScanObjectNN": ScanObjectNN}
# the splits that train when the caller does not say
# (geot_tpu/data/build.py:183)
TRAIN_SPLITS = ("train", "training", "trainval")


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack the entries that have one shape across the batch; keep ragged
    ones (full-resolution eval scans) as lists
    (``geot_tpu/data/build.py:28``)."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [np.asarray(s[key]) for s in samples]
        if all(v.shape == vals[0].shape for v in vals) and \
                vals[0].dtype != object:
            out[key] = np.stack(vals)
        else:
            out[key] = [s[key] for s in samples]
    return out


class DataLoader:
    """An epoch loader (``geot_tpu/data/build.py:50-150``): with
    ``shuffle``, the order of epoch e is ``default_rng(seed +
    e).permutation``; each global batch is block-sharded over
    ``num_shards`` ranks; ``drop_last`` drops the ragged tail, otherwise
    the last batch is short. A pool of ``num_workers`` threads loads and
    collates up to ``num_workers`` batches ahead of the one the caller
    takes; the batches and their order do not depend on ``num_workers``
    (each item draws from its own ``(seed, epoch, idx)`` generator).

    ``batch_mixers`` (``Cutmix``) act on each collated batch, in order, on
    the pool's thread, drawing from ``default_rng((seed, epoch, first
    index of the batch))`` (``geot_tpu/data/build.py:127-134``)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, num_shards: int = 1,
                 shard_index: int = 0, num_workers: int = 4,
                 batch_mixers=None):
        if num_shards > 1 and not drop_last:
            raise NotImplementedError("sharding a loader that keeps its "
                                      "tail is not ported")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.num_workers = max(int(num_workers), 1)
        self.batch_mixers = list(batch_mixers or [])
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = (np.random.default_rng(self.seed + self.epoch).permutation(n)
               if self.shuffle else np.arange(n))
        if self.num_shards > 1:
            gb = self.batch_size * self.num_shards
            chunks = idx[:len(idx) - len(idx) % gb].reshape(
                -1, self.num_shards, self.batch_size)
            return chunks[:, self.shard_index, :].reshape(-1)
        return idx

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _fetch(self, batch_idx: np.ndarray) -> Dict[str, Any]:
        batch = default_collate([self.dataset[int(j)] for j in batch_idx])
        if self.batch_mixers:
            rng = np.random.default_rng(
                (self.seed, self.epoch, int(batch_idx[0])))
            for mixer in self.batch_mixers:
                batch = mixer.mix_batch(batch, rng)
        return batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        idx = self._epoch_indices()
        batches = (idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self)))
        with _fut.ThreadPoolExecutor(self.num_workers) as pool:
            ahead = [pool.submit(self._fetch, b)
                     for b in itertools.islice(batches, self.num_workers)]
            for b in batches:
                done = ahead.pop(0)
                ahead.append(pool.submit(self._fetch, b))
                yield done.result()
            for fut in ahead:
                yield fut.result()


def build_dataset_from_cfg(cfg: Dict[str, Any],
                           default_args: Optional[Dict[str, Any]] = None):
    """``DATASETS[cfg["NAME"]]`` built with ``default_args`` and the rest
    of ``cfg`` (``cfg`` wins; ``geot_tpu/data/build.py:24``); a name the
    port lacks raises ``NotImplementedError``."""
    args = dict(default_args or {})
    args.update(copy.deepcopy(dict(cfg)))
    return _dataset_class(args.pop("NAME"))(**args)


def _dataset_class(name):
    if name not in DATASETS:
        raise NotImplementedError(f"dataset {name!r} is not ported; ported: "
                                  f"{sorted(DATASETS)}")
    return DATASETS[name]


def _split_cfg(dataset_cfg: Dict[str, Any], split: str) -> Dict[str, Any]:
    """``common`` merged with the split's own keys, ``split`` set."""
    cfg = dict(dataset_cfg.get("common", {}))
    cfg.update(dataset_cfg.get(split, {}) or {})
    cfg.setdefault("split", split)
    return cfg


def _loader(dataset, batch_size: int, is_train: bool, seed: int,
            num_shards: int, shard_index: int,
            dataloader_cfg: Optional[Dict], mixers=()) -> DataLoader:
    if batch_size % num_shards:
        raise ValueError(f"global batch_size={batch_size} not divisible by "
                         f"{num_shards} ranks")
    return DataLoader(dataset, batch_size // num_shards, shuffle=is_train,
                      drop_last=is_train, seed=seed, num_shards=num_shards,
                      shard_index=shard_index,
                      num_workers=(dataloader_cfg or {}).get("num_workers",
                                                             4),
                      batch_mixers=mixers)


def build_dataloader_from_cfg(batch_size: int, dataset_cfg: Dict[str, Any],
                              datatransforms_cfg: Optional[Dict] = None,
                              split: str = "train", seed: int = 0,
                              num_shards: int = 1, shard_index: int = 0,
                              dataloader_cfg: Optional[Dict] = None,
                              is_train: Optional[bool] = None,
                              device: "str | torch.device | None" = None
                              ) -> DataLoader:
    """The loader of one split of a dataset config (``common`` merged with
    the split's own keys; ``geot_tpu/data/build.py:172-231``).

    A training loader (``is_train``; when None, a split of
    ``TRAIN_SPLITS``) is shuffled and drops its tail; any other keeps its
    order and its tail. The labelled dataset takes the split's transforms
    (the ``train`` or ``val`` ones for a split without its own), and those
    with a ``mix_batch`` (``Cutmix``) mix its collated batches; the
    unlabelled one the ``train_w`` and ``train_s`` transforms, and its
    loader is seeded with ``seed + 1``. ``batch_size`` is global: each of
    ``num_shards`` ranks loads its block of every batch. The loader's
    threads are ``dataloader_cfg["num_workers"]`` (4 without it).
    ``device`` goes to a dataset that computes on one (the FPS of
    ``ShapeNetPartNormal``'s ``presample``)."""
    cfg = _split_cfg(dataset_cfg, split)
    cls = _dataset_class(cfg.get("NAME"))
    if is_train is None:
        is_train = split in TRAIN_SPLITS
    if device is not None and cls is ShapeNetPartNormal:
        cfg.setdefault("device", device)
    tf = datatransforms_cfg
    if cls is TeethSegSemiUDataset:
        return _loader(_semi_dataset(cfg, tf), batch_size, is_train,
                       seed + 1, num_shards, shard_index, dataloader_cfg)
    transform = None
    if tf is not None:
        transform = build_transforms_from_cfg(
            split if split in tf else ("train" if is_train else "val"), tf)
    mixers = [t for t in (transform.transforms if transform else [])
              if hasattr(t, "mix_batch")]
    return _loader(build_dataset_from_cfg(cfg, {"transform": transform}),
                   batch_size, is_train, seed, num_shards, shard_index,
                   dataloader_cfg, mixers)


def _semi_dataset(cfg: Dict[str, Any], tf: Optional[Dict]):
    return build_dataset_from_cfg(cfg, {
        "transform_w": build_transforms_from_cfg("train_w", tf),
        "transform_s": build_transforms_from_cfg("train_s", tf)})


def build_semi_dataloader_from_cfg(batch_size: int,
                                   dataset_cfg: Dict[str, Any],
                                   datatransforms_cfg: Optional[Dict] = None,
                                   split: str = "train", seed: int = 0,
                                   num_shards: int = 1, shard_index: int = 0,
                                   dataloader_cfg: Optional[Dict] = None
                                   ) -> DataLoader:
    """The unlabelled loader (``geot_tpu/data/build.py:209``): the split's
    dataset takes both the ``train_w`` and ``train_s`` transforms; shuffled,
    tail dropped, seeded with ``seed + 1``."""
    return _loader(_semi_dataset(_split_cfg(dataset_cfg, split),
                                 datatransforms_cfg), batch_size, True,
                   seed + 1, num_shards, shard_index, dataloader_cfg)


def build_semi_loaders(cfg: Dict[str, Any], data_root: str = "",
                       num_shards: int = 1, shard_index: int = 0):
    """The labelled and unlabelled train loaders of a semi config
    (``dataset_l`` and ``dataset_u``; for a config without them, such as
    ``FLAGSHIP_SEMI_CFG``, the synthetic teeth datasets at
    ``cfg["num_points"]``), each from ``build_dataloader_from_cfg``.
    ``num_shards`` and ``shard_index`` are the caller's world size and
    rank."""
    n = int(cfg.get("num_points", 16000))
    return tuple(build_dataloader_from_cfg(
        int(cfg[bs]), cfg.get(key) or {"common": {
            "NAME": name, "data_root": data_root, "num_points": n}},
        cfg.get("datatransforms"), split="train",
        seed=int(cfg.get("seed", 0)), num_shards=num_shards,
        shard_index=shard_index)
        for bs, key, name in (
            ("batch_size_l", "dataset_l", "TeethSegSemiLDataset"),
            ("batch_size_u", "dataset_u", "TeethSegSemiUDataset")))


def semi_keys(batch: Dict[str, Any]) -> Tuple[str, ...]:
    """The keys of an unlabelled batch the semi step reads: ``SEMI_KEYS``,
    and ``cur`` (per-point curvature, which ``Poly1FocalLoss_U_Cur`` gates
    on) when the dataset carries it (``geot_tpu/engine/train.py:39-42``)."""
    return SEMI_KEYS + (("cur",) if "cur" in batch else ())


def to_device(batch: Dict[str, Any], keys: Iterable[str],
              device: "str | torch.device") -> Dict[str, torch.Tensor]:
    """The named entries of a collated batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            for k in keys}


def semi_pairs(loader_l: DataLoader, loader_u: DataLoader,
               limit: Optional[int] = None):
    """(labelled, unlabelled) batch pairs of one epoch: the unlabelled
    loader restarts when it runs out (``geot_tpu/engine/train.py``'s
    ``_pairs``); at most ``limit`` pairs. An empty unlabelled loader raises
    ``RuntimeError``, as there."""
    u_iter = iter(loader_u)
    for n, batch_l in enumerate(loader_l):
        if limit is not None and n >= limit:
            return
        try:
            batch_u = next(u_iter)
        except StopIteration:
            u_iter = iter(loader_u)
            try:
                batch_u = next(u_iter)
            except StopIteration:
                # PEP 479 would surface this as an opaque
                # 'generator raised StopIteration'
                raise RuntimeError("unlabeled train loader is empty — check "
                                   "dataset_u config") from None
        yield batch_l, batch_u
