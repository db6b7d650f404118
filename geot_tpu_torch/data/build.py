"""Batch loading for the train step (``geot_tpu/data/build.py``): an
epoch-based loader with seeded shuffling, ``drop_last`` and per-rank
sharding, collating numpy samples in this process, and the copy of a batch
onto the device.

The rank and the number of ranks come from the caller (``geot_tpu`` asks
JAX for them, ``data/build.py:152``).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from .tooth_semi import TeethSegSemiLDataset, TeethSegSemiUDataset
from .transforms import build_transforms_from_cfg

# the keys a train step reads (geot_tpu/engine/train.py:_model_batch,
# _semi_batch)
MODEL_KEYS = ("pos", "x", "cls", "y", "class_weights")
SEMI_KEYS = ("pos_w", "x_w", "cls_w", "pos_s", "x_s", "cls_s", "raw_pos",
             "y")


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack the samples' entries (train samples have fixed shapes)."""
    return {key: np.stack([np.asarray(s[key]) for s in samples])
            for key in samples[0]}


class DataLoader:
    """A train loader (``geot_tpu/data/build.py:DataLoader`` with
    ``shuffle`` and ``drop_last``, without its thread pool): shuffle with
    ``default_rng(seed + epoch)``, block-shard each global batch over
    ``num_shards`` ranks, drop the ragged tail."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 num_shards: int = 1, shard_index: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.random.default_rng(self.seed + self.epoch).permutation(n)
        if self.num_shards > 1:
            gb = self.batch_size * self.num_shards
            chunks = idx[:len(idx) - len(idx) % gb].reshape(
                -1, self.num_shards, self.batch_size)
            return chunks[:, self.shard_index, :].reshape(-1)
        return idx

    def __len__(self) -> int:
        return len(self._epoch_indices()) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        idx = self._epoch_indices()
        for i in range(len(self)):
            batch = idx[i * self.batch_size:(i + 1) * self.batch_size]
            yield default_collate([self.dataset[int(j)] for j in batch])


def build_semi_loaders(cfg: Dict[str, Any], data_root: str = "",
                       num_shards: int = 1, shard_index: int = 0):
    """The labelled and unlabelled train loaders of a semi config
    (``geot_tpu/data/build.py:build_dataloader_from_cfg`` with
    ``split="train"`` and ``build_semi_dataloader_from_cfg``): the
    labelled set with the ``train`` transforms, the unlabelled one with
    ``train_w`` and ``train_s``; both shuffled, ``drop_last``, the
    unlabelled loader seeded with ``seed + 1``. ``num_shards`` and
    ``shard_index`` are the caller's world size and rank."""
    tf = cfg.get("datatransforms")
    seed = int(cfg.get("seed", 0))
    n = int(cfg.get("num_points", 16000))
    ds_l = TeethSegSemiLDataset(data_root, n, "train",
                                transform=build_transforms_from_cfg("train",
                                                                    tf))
    ds_u = TeethSegSemiUDataset(
        data_root, n, "train",
        transform_w=build_transforms_from_cfg("train_w", tf),
        transform_s=build_transforms_from_cfg("train_s", tf))

    def local(batch_size):
        if batch_size % num_shards:
            raise ValueError(f"global batch_size={batch_size} not divisible "
                             f"by {num_shards} ranks")
        return batch_size // num_shards

    loader_l = DataLoader(ds_l, local(int(cfg["batch_size_l"])), seed=seed,
                          num_shards=num_shards, shard_index=shard_index)
    loader_u = DataLoader(ds_u, local(int(cfg["batch_size_u"])),
                          seed=seed + 1, num_shards=num_shards,
                          shard_index=shard_index)
    return loader_l, loader_u


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
