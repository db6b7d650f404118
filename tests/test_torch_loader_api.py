"""The loader's public API against ``geot_tpu``'s: ``DataLoader``'s
signature, defaults, ``collate_fn`` and sharded tail, and
``build_dataloader_from_cfg`` / ``build_semi_dataloader_from_cfg`` called
as ``geot_tpu``'s own callers call them (``geot_tpu/engine/train.py:193-207``:
both configs by position, then ``split``, ``seed`` and ``distributed``)
over ``cfgs/tooth_semi/smoke.yaml``. Every batch is compared bit for bit.
"""
import inspect
import os

import numpy as np
import pytest

from geot_tpu.core.config import EasyConfig as JConfig
from geot_tpu.data import build as jbuild

from geot_tpu_torch.core.config import EasyConfig
from geot_tpu_torch.data import build as tbuild

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "cfgs", "tooth_semi", "smoke.yaml")


class _Items:
    """n items, each ``{"i": its index, "x": a row of floats}``."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i), "x": np.full((3,), i, np.float32)}


def _indices(loader):
    return [b["i"].tolist() for b in loader]


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            if isinstance(b[k], list):
                assert len(a[k]) == len(b[k]), k
                for u, v in zip(a[k], b[k]):
                    np.testing.assert_array_equal(u, v, err_msg=k)
            else:
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_signatures_are_geot_tpus():
    """The parameters of ``geot_tpu``'s three callables, in its order and
    with its defaults; the port's extras come after them, keyword-only."""
    for name in ("DataLoader", "build_dataloader_from_cfg",
                 "build_semi_dataloader_from_cfg"):
        want = inspect.signature(getattr(jbuild, name)).parameters
        got = inspect.signature(getattr(tbuild, name)).parameters
        assert list(got)[:len(want)] == list(want), name
        for k, p in want.items():
            assert got[k].default == p.default, (name, k)
        for k in list(got)[len(want):]:
            assert got[k].kind is inspect.Parameter.KEYWORD_ONLY, (name, k)


def test_defaults_keep_the_order_and_the_tail():
    """10 items at batch 4 with the defaults: in order, tail kept."""
    want = _indices(jbuild.DataLoader(_Items(10), 4))
    assert want == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    assert _indices(tbuild.DataLoader(_Items(10), 4)) == want


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_sharded_tail_is_wrap_padded(shuffle, drop_last):
    """Two shards of 10 items at 3 a rank: without ``drop_last`` the epoch
    is wrap-padded with its first items to whole global batches (each rank
    takes as many batches); with it the tail is dropped."""
    for epoch in (0, 1):
        for shard in (0, 1):
            kw = dict(shuffle=shuffle, drop_last=drop_last, seed=5,
                      num_shards=2, shard_index=shard)
            j = jbuild.DataLoader(_Items(10), 3, **kw)
            t = tbuild.DataLoader(_Items(10), 3, **kw)
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            assert len(t) == len(j) == (1 if drop_last else 2)
            assert _indices(t) == _indices(j)
    t = tbuild.DataLoader(_Items(10), 3, num_shards=2, shard_index=1)
    assert _indices(t) == [[3, 4, 5], [9, 0, 1]]


def test_positional_order_and_collate_fn():
    """``(dataset, batch_size, shuffle, drop_last, num_workers, seed,
    collate_fn)`` by position, as ``geot_tpu`` takes them."""
    def collate(samples):
        return {"i": np.array([int(s["i"]) for s in samples]) * 10}

    args = (_Items(7), 2, True, True, 3, 9, collate)
    j, t = jbuild.DataLoader(*args), tbuild.DataLoader(*args)
    assert t.num_workers == 3 and t.seed == 9
    assert _indices(t) == _indices(j)
    assert all(i % 10 == 0 for b in _indices(t) for i in b)


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = JConfig(), EasyConfig()
    jcfg.load(SMOKE, recursive=True)
    tcfg.load(SMOKE, recursive=True)
    return jcfg, tcfg


@pytest.mark.parametrize("split,batch_key", [
    ("train", "batch_size_l"), ("val", "batch_size_val"),
    ("test", "batch_size_test")])
def test_callers_form_gives_geot_tpus_batches(smoke, split, batch_key):
    """``build_dataloader_from_cfg(bs, dataset_l, dataloader,
    datatransforms, split=..., seed=..., distributed=...)``, the trainer's
    call: the same loader settings and the same first two batches."""
    loaders = []
    for pkg, cfg in zip((jbuild, tbuild), smoke):
        loader = pkg.build_dataloader_from_cfg(
            cfg.get(batch_key, 2), cfg.dataset_l, cfg.get("dataloader"),
            cfg.get("datatransforms"), split=split, seed=cfg.get("seed", 0),
            distributed=split == "train")
        loader.set_epoch(1)
        loaders.append(loader)
    j, t = loaders
    for attr in ("batch_size", "shuffle", "drop_last", "num_workers",
                 "seed", "num_shards", "shard_index"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert len(t) == len(j)
    assert_batches_equal([b for _, b in zip(range(2), t)],
                         [b for _, b in zip(range(2), j)])


def test_semi_callers_form_gives_geot_tpus_batches(smoke):
    """``build_semi_dataloader_from_cfg(bs, dataset_u, dataloader,
    datatransforms, split="train", seed=..., distributed=...)``."""
    loaders = []
    for pkg, cfg in zip((jbuild, tbuild), smoke):
        loader = pkg.build_semi_dataloader_from_cfg(
            cfg.get("batch_size_u", 2), cfg.dataset_u, cfg.get("dataloader"),
            cfg.get("datatransforms"), split="train", seed=cfg.get("seed", 0),
            distributed=True, pretrain=False)
        loader.set_epoch(2)
        loaders.append(loader)
    j, t = loaders
    assert (t.seed, t.num_workers, len(t)) == (j.seed, j.num_workers, len(j))
    assert_batches_equal([b for _, b in zip(range(2), t)],
                         [b for _, b in zip(range(2), j)])
