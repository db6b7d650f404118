"""Token/record dataset plumbing (``geot_tpu/data/dataset_base.py``):
``DatasetBase``, records read lazily by token and cached on disk, and
``DataList``, scene-file-list datasets with round-robin voxel covers.

The cache is two pickles, ``<cache_dir>/<dataset_name>/<split>/tokens.pkl``
and ``records.pkl``, the files ``geot_tpu`` writes: a cache that either
package writes, the other reads, with the same records.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .data_util import voxelize


class DatasetBase:
    """Records cached by ``record_tokens``; subclasses define
    ``record_tokens`` and ``read_record(token)``. With ``cache_dir`` and
    ``load_cache_if_exists``, an existing cache is loaded at
    construction."""

    def __init__(self, dataset_name: str, split: str, cache_dir=None,
                 load_cache_if_exists: bool = True, **kwargs):
        self.dataset_name = dataset_name
        self.split = split
        self.cache_dir = cache_dir
        self.is_cached = False
        if load_cache_if_exists and cache_dir is not None:
            self.cache(verbose=0, must_exist=True)

    @property
    def record_tokens(self):
        raise NotImplementedError

    def read_record(self, token):
        raise NotImplementedError

    def __len__(self):
        return len(self.record_tokens)

    def __getitem__(self, index):
        token = self.record_tokens[index]
        try:
            return self._records[token]
        except AttributeError:
            self._records = {token: self.read_record(token)}
            return self._records[token]
        except KeyError:
            self._records[token] = self.read_record(token)
            return self._records[token]

    def read_all_records(self, verbose: int = 1):
        self._records = {}
        for token in self.record_tokens:
            self._records[token] = self.read_record(token)

    def get_cache_path(self, path=None) -> Path:
        if path is None:
            path = self.cache_dir
        base = Path(path) / self.dataset_name / self.split
        base.mkdir(parents=True, exist_ok=True)
        return base

    def cache_load_and_save(self, base_path: Path, op: str, verbose: int):
        tokens_path = base_path / "tokens.pkl"
        records_path = base_path / "records.pkl"
        if op == "load":
            if not (tokens_path.exists() and records_path.exists()):
                raise FileNotFoundError(tokens_path)
            with open(tokens_path, "rb") as f:
                self._record_tokens = pickle.load(f)
            with open(records_path, "rb") as f:
                self._records = pickle.load(f)
        elif op == "save":
            if tokens_path.exists() and records_path.exists() and \
                    hasattr(self, "_record_tokens") and hasattr(self,
                                                                "_records"):
                return
            self.read_all_records(verbose=verbose)
            with open(tokens_path, "wb") as f:
                pickle.dump(list(self.record_tokens), f)
            with open(records_path, "wb") as f:
                pickle.dump(self._records, f)
        else:
            raise ValueError(f"Unknown operation: {op}")

    def cache(self, path=None, verbose: int = 1, must_exist: bool = False):
        """Load the cache under ``path`` (``cache_dir`` without it), or,
        when there is none and ``must_exist`` is off, read every record and
        write it."""
        if self.is_cached:
            return
        base = self.get_cache_path(path)
        try:
            self.cache_load_and_save(base, "load", verbose)
        except FileNotFoundError:
            if must_exist:
                return
            self.cache_load_and_save(base, "save", verbose)
        self.is_cached = True


class DataList(DatasetBase):
    """A scene-file-list dataset (``geot_tpu/data/dataset_base.py:101``):
    ``load_data`` gives ``(coord, feat, label, idx_points)``, the scene
    shifted to its minimum and ``idx_points`` its round-robin voxel cover
    at ``voxel_size`` (one index array a pass; all points in one without
    ``voxel_size``). S3DIS scenes are ``.npy`` xyzrgbl rows, ScanNet
    scenes ``torch.save`` files of (coord, feat[, label])."""

    def __init__(self, dataset_name: str, split: str, data_list,
                 voxel_size=None, **kwargs):
        super().__init__(dataset_name, split, **kwargs)
        self.data_list = list(data_list)
        self.voxel_size = voxel_size

    @property
    def record_tokens(self):
        return self.data_list

    def read_record(self, token):
        return self.load_data(token)

    def load_data(self, data_path):
        if "s3dis" in self.dataset_name:
            data = np.load(data_path)                    # xyzrgbl, N*7
            coord, feat, label = data[:, :3], data[:, 3:6], data[:, 6]
            feat = np.clip(feat / 255.0, 0, 1).astype(np.float32)
        elif "scannet" in self.dataset_name:
            import torch

            data = torch.load(data_path)
            if self.split != "test":
                coord, feat, label = data[0], data[1], data[2]
            else:
                coord, feat, label = data[0], data[1], None
            coord = np.asarray(coord)
            feat = np.clip((np.asarray(feat) + 1) / 2.0, 0, 1).astype(
                np.float32)
        else:
            raise NotImplementedError(self.dataset_name)
        coord = coord - coord.min(0)

        idx_points = []
        if self.voxel_size is not None:
            idx_sort, _, count = voxelize(coord, self.voxel_size, mode=1)
            starts = np.cumsum(np.insert(count, 0, 0)[:-1])
            for i in range(count.max()):
                idx_part = idx_sort[starts + i % count]
                idx_points.append(idx_part)
        else:
            n = len(coord) if label is None else label.shape[0]
            idx_points.append(np.arange(n))
        return coord, feat, label, idx_points
