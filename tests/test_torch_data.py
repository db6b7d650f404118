"""The port's datasets and batch pairing against ``geot_tpu``: the val/test
items of the labelled dataset, and the error on an empty unlabelled
loader."""
import numpy as np
import pytest

from geot_tpu.data.tooth_semi import TeethSegSemiLDataset as JLDataset
from geot_tpu.data.transforms import build_transforms_from_cfg as jtransforms

from geot_tpu_torch import FLAGSHIP_SEMI_CFG
from geot_tpu_torch.data.build import DataLoader, semi_pairs
from geot_tpu_torch.data.tooth_semi import (TeethSegSemiLDataset,
                                            TeethSegSemiUDataset)
from geot_tpu_torch.data.transforms import build_transforms_from_cfg

N_POINTS = 256
EVAL_KEYS = ("points", "labels", "center", "scale", "patient")


@pytest.mark.parametrize("split", ["val", "test"])
@pytest.mark.parametrize("idx", [0, 1])
def test_eval_items_equal_geot_tpu(split, idx):
    """Every key of a val/test item, its dtype and its value: the sampled
    and transformed cloud plus the full-resolution scan, its centre and
    scale, and the patient id."""
    tf = FLAGSHIP_SEMI_CFG["datatransforms"]
    got = TeethSegSemiLDataset("", N_POINTS, split,
                               transform=build_transforms_from_cfg(split, tf))
    want = JLDataset("", N_POINTS, split, transform=jtransforms(split, tf))
    assert len(got) == len(want)
    a, b = got[idx], want[idx]
    assert set(a) == set(b) and set(EVAL_KEYS) <= set(a)
    for k in a:
        assert type(a[k]) is type(b[k]), k
        if isinstance(b[k], str):
            assert a[k] == b[k], k
            continue
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        assert np.shape(a[k]) == np.shape(b[k]), k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["points"].shape == (40000, 3) and a["pos"].shape == (N_POINTS, 3)


def test_train_items_carry_no_eval_fields():
    data = TeethSegSemiLDataset("", N_POINTS, "train")[0]
    assert not set(EVAL_KEYS) & set(data)


def test_semi_pairs_refuses_an_empty_unlabelled_loader():
    """More unlabelled items per batch than the set holds: ``drop_last``
    leaves no batch, and the pairing says so instead of PEP 479's
    'generator raised StopIteration'."""
    loader_l = DataLoader(TeethSegSemiLDataset("", N_POINTS, "train"), 2,
                          drop_last=True)
    ds_u = TeethSegSemiUDataset("", N_POINTS, "train")
    loader_u = DataLoader(ds_u, len(ds_u) + 1, drop_last=True)
    assert len(loader_u) == 0
    with pytest.raises(RuntimeError,
                       match="unlabeled train loader is empty"):
        next(semi_pairs(loader_l, loader_u))
