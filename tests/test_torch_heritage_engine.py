"""The heritage tasks' protocols and trainer against ``geot_tpu``: the
metrics of ``core/metrics.py``; ``batched_bincount``,
``part_seg_refinement`` and ``get_ins_mious`` on predictions with parts
foreign to the category and islands; ``cls.evaluate`` and
``partseg.evaluate`` on the same logits (with and without
``eval_category_mask`` and ``eval_refine``, ``multihead``, the h5
variant's categories); and ``engine.train.parse_and_run`` on the CPU for
each of the 5 model configs of ``cfgs/scanobjectnn`` and
``cfgs/shapenetpart`` at the small widths, then ``mode=test`` on the best
checkpoint and ``mode=resume``.

The protocols are fed the same logits on both sides (fixed eval steps), so
the metrics must be equal up to float summation order (1e-12 absolute);
the refinement's neighbour search is exact on both sides at these sizes
(``geot_tpu``'s kNN is ``lax.top_k`` up to 256 points).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.core import metrics as jmetrics
from geot_tpu.engine import cls as jcls
from geot_tpu.engine import partseg as jpartseg
from geot_tpu.engine import partseg_eval as jpe

from geot_tpu_torch.core import metrics as tmetrics
from geot_tpu_torch.core.config import EasyConfig
from geot_tpu_torch.data import build as tbuild
from geot_tpu_torch.data.shapenetpart import SHAPENETPART_CLS2PARTS
from geot_tpu_torch.engine import cls as tcls
from geot_tpu_torch.engine import partseg as tpartseg
from geot_tpu_torch.engine import partseg_eval as tpe
from geot_tpu_torch.engine import train as ttrain
from geot_tpu_torch.engine.checkpoint import ckpt_path

from test_torch_heritage_data import write_txt_tree
from test_torch_heritage_models import MODELS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-12


# --- metrics ------------------------------------------------------------------

def test_confusion_matrix_and_mious_match_geot_tpu():
    rng = np.random.default_rng(0)
    for ignore in (None, 3):
        got, want = (tmetrics.ConfusionMatrix(6, ignore),
                     jmetrics.ConfusionMatrix(6, ignore))
        for _ in range(3):
            pred, true = rng.integers(0, 6, (2, 500)), rng.integers(0, 5,
                                                                    (2, 500))
            got.update(pred, true)
            want.update(pred, true)
        for a, b in zip(got.all_metrics(), want.all_metrics()):
            np.testing.assert_array_equal(a, b)
        assert got.overall_accuracy == want.overall_accuracy
        for a, b in zip(tmetrics.get_mious(got.tp, got.union, got.count),
                        jmetrics.get_mious(want.tp, want.union, want.count)):
            np.testing.assert_array_equal(a, b)
        got.reset()
        assert got.total == 0 and not got.tp.any()


def test_part_metrics_match_geot_tpu():
    rng = np.random.default_rng(1)
    pred, label = rng.integers(0, 17, 4000), rng.integers(0, 17, 4000)
    assert tmetrics.seg_metrics_whole(pred, label) == \
        jmetrics.seg_metrics_whole(pred, label)
    conf = rng.integers(0, 50, (3, 5, 5)).astype(np.float64)
    conf[1, 2, :] = 0                                   # an absent class
    np.testing.assert_array_equal(tmetrics.IoU_from_confusions(conf),
                                  jmetrics.IoU_from_confusions(conf))
    num_parts = [3, 4, 2]
    objects = rng.integers(0, 3, 9)
    preds = [rng.standard_normal((num_parts[o], 60)) for o in objects]
    targets = [rng.integers(0, num_parts[o], 60) for o in objects]
    masks = [rng.random(60) < 0.8 for _ in objects]
    a, b = (tmetrics.partnet_metrics(3, num_parts, objects, preds, targets),
            jmetrics.partnet_metrics(3, num_parts, objects, preds, targets))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    a = tmetrics.shapenetpart_metrics(3, num_parts, objects, preds, targets,
                                      masks)
    b = jmetrics.shapenetpart_metrics(3, num_parts, objects, preds, targets,
                                      masks)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert tmetrics.PSNR(0.01) == jmetrics.PSNR(0.01)
    assert tmetrics.PSNR(0.5, 2.0) == jmetrics.PSNR(0.5, 2.0)


def test_parameter_counts_match_geot_tpu():
    """``cal_model_parm_nums_separate`` by name (encoder, generator,
    decoder) on the part-segmentation model: the port's module against
    ``geot_tpu``'s parameter tree (its shapes, ``jax.eval_shape``)."""
    from geot_tpu.core.config import EasyConfig as JEasyConfig
    from geot_tpu.models import build_model_from_cfg as jbuild

    from geot_tpu_torch.core.config import build_model_from_cfg

    path, opts = MODELS["part_pointnet2"]
    cfgs = []
    for cls_ in (JEasyConfig, EasyConfig):
        cfg = cls_()
        cfg.load(os.path.join(ROOT, "cfgs", path), recursive=True)
        cfg.update(list(opts))
        cfgs.append(cfg)
    jmodel = jbuild(cfgs[0].model)
    key = jax.random.PRNGKey(0)
    batch = {"pos": jnp.zeros((2, 64, 3)), "x": jnp.zeros((2, 64, 6)),
             "cls": jnp.zeros((2, 1), jnp.int32)}
    shapes = jax.eval_shape(jmodel.init, {"params": key, "dropout": key},
                            batch)["params"]
    want = jmetrics.cal_model_parm_nums_separate(shapes)
    model = build_model_from_cfg(cfgs[1].model)
    got = tmetrics.cal_model_parm_nums_separate(model)
    assert got == want and got[1] > 0 and got[3] > 0 and got[2] == 0
    assert got[0] == tmetrics.cal_model_parm_nums(model)


# --- part-segmentation evaluation helpers ---------------------------------------

def _bad_predictions(rng, B=3, N=200):
    """Labels of ``B`` shapes: mostly the category's parts, plus a part of
    another category and 1- to 4-point islands."""
    cls = np.array([0, 4, 10][:B])
    pos = rng.standard_normal((B, N, 3)).astype(np.float32)
    pred = np.stack([rng.choice(SHAPENETPART_CLS2PARTS[c][:2], N)
                     for c in cls]).astype(np.int32)
    pred[0, :5] = 20                                 # another category's
    pred[1, 7] = SHAPENETPART_CLS2PARTS[4][3]        # a 1-point island
    pred[2, 10:14] = SHAPENETPART_CLS2PARTS[10][5]   # a 4-point island
    target = np.stack([rng.choice(SHAPENETPART_CLS2PARTS[c], N)
                       for c in cls]).astype(np.int64)
    return pred, pos, cls.reshape(B, 1), target


def test_refinement_and_instance_mious_match_geot_tpu():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 7, (5, 11))
    np.testing.assert_array_equal(tpe.batched_bincount(x, 7),
                                  jpe.batched_bincount(x, 7))
    pred, pos, cls, target = _bad_predictions(rng)
    want = jpe.part_seg_refinement(pred, pos, cls, SHAPENETPART_CLS2PARTS)
    got = tpe.part_seg_refinement(pred, pos, cls, SHAPENETPART_CLS2PARTS)
    np.testing.assert_array_equal(got, want)
    # the tensor's device does the search: the same labels from a tensor
    np.testing.assert_array_equal(tpe.part_seg_refinement(
        pred, torch.from_numpy(pos), cls, SHAPENETPART_CLS2PARTS), want)
    changed = int((got != pred).sum())
    assert changed >= 5 and not (got[0] == 20).any()
    one = pred[:1].copy()
    one[:] = 2                                       # one label: kept
    np.testing.assert_array_equal(tpe.part_seg_refinement(
        one, pos[:1], cls[:1], SHAPENETPART_CLS2PARTS), one)
    for p in (pred, got):
        for mh in (False, True):
            t = target - (np.array([0, 12, 30])[:, None] if mh else 0)
            assert tpe.get_ins_mious(p, t, cls, SHAPENETPART_CLS2PARTS, mh) \
                == jpe.get_ins_mious(p, t, cls, SHAPENETPART_CLS2PARTS, mh)


# --- the protocols --------------------------------------------------------------

class _Loader(list):
    dataset = ()


def _fixed_steps(logits):
    """An eval step for each package that returns the given logits in turn
    (numpy (B, ..., C) arrays)."""
    t_it, j_it = iter(logits), iter(logits)
    return (lambda model, batch: torch.from_numpy(next(t_it)),
            lambda variables, batch: jnp.asarray(next(j_it)))


def _loader(ds_cfg, split, bs, n_batches):
    loader = tbuild.build_dataloader_from_cfg(bs, ds_cfg, split=split,
                                              is_train=False)
    return _Loader(list(loader)[:n_batches])


def test_cls_evaluate_matches_geot_tpu():
    """OA and mAcc (percent) on the same logits; ties broken to the first
    class in both."""
    loader = _loader({"common": {"NAME": "ScanObjectNN",
                                 "num_points": 32}}, "test", 16, 4)
    rng = np.random.default_rng(3)
    logits = [rng.standard_normal((16, 15)).astype(np.float32)
              for _ in loader]
    logits[1][:, :3] = 5.0                           # ties: class 0 wins
    cfg = {"num_classes": 15}
    t_step, j_step = _fixed_steps(logits)
    got = tcls.evaluate(t_step, None, loader, cfg, "cpu")
    want = jcls.evaluate(j_step, None, loader, cfg)
    assert got.keys() == want.keys() == {"oa", "macc"}
    for k in got:
        assert abs(got[k] - want[k]) <= ATOL, (k, got[k], want[k])


PARTSEG_CASES = {
    "plain": {},
    "category_mask": {"eval_category_mask": True},
    "refine": {"eval_refine": True},
    "mask_and_refine": {"eval_category_mask": True, "eval_refine": True},
    "multihead": {"eval_category_mask": True, "eval_refine": True,
                  "dataset": {"common": {"multihead": True}}},
    "multihead_per_split": {"dataset": {"test": {"multihead": True}}},
}


@pytest.fixture(scope="module")
def partseg_batches():
    ds = {"common": {"NAME": "ShapeNetPartNormal", "num_points": 128}}
    loader = _loader(ds, "test", 8, 4)
    rng = np.random.default_rng(4)
    logits = [rng.standard_normal((8, 128, 50)).astype(np.float32)
              for _ in loader]
    for lg, b in zip(logits, loader):
        # confident on the category's own parts for most points, so the
        # refinement has islands to relabel
        for i, c in enumerate(np.asarray(b["cls"]).reshape(-1)):
            lg[i, :100, SHAPENETPART_CLS2PARTS[c][0]] += 4.0
    return loader, logits


@pytest.mark.parametrize("case", sorted(PARTSEG_CASES))
def test_partseg_evaluate_matches_geot_tpu(partseg_batches, case):
    """``ins_miou``, ``cls_miou`` and ``per_category`` on the same logits,
    with the category mask, the refinement and ``multihead`` (which turns
    both off; set in ``common`` or in the val split's own keys)."""
    loader, logits = partseg_batches
    cfg = {"num_classes": 50, "val_split": "test"}
    cfg.update(PARTSEG_CASES[case])
    if "dataset" in cfg:
        cfg["dataset"] = dict(cfg["dataset"], val_split="test")
    t_step, j_step = _fixed_steps(logits)
    got = tpartseg.evaluate(t_step, None, loader, cfg, "cpu")
    want = jpartseg.evaluate(j_step, None, loader, cfg)
    assert got.keys() == want.keys()
    for k in ("ins_miou", "cls_miou"):
        assert abs(got[k] - want[k]) <= ATOL, (k, got[k], want[k])
    assert got["per_category"].keys() == want["per_category"].keys()
    for c, v in want["per_category"].items():
        assert abs(got["per_category"][c] - v) <= ATOL
    print(f"{case}: ins_miou {got['ins_miou']:.6f} cls_miou "
          f"{got['cls_miou']:.6f}")


def test_partseg_h5_categories_and_batch_errors():
    """The h5 variant has no ``cls``: the category comes from the one-hot
    features in both; ``_part_mask`` equals ``geot_tpu``'s; a ragged batch
    raises ``ValueError``."""
    loader = _loader({"common": {"NAME": "ShapeNetPart",
                                 "num_points": 64}}, "test", 8, 2)
    assert "cls" not in loader[0]
    for b in loader:
        np.testing.assert_array_equal(tpartseg._cls_of(b),
                                      jpartseg._cls_of(b))
    rng = np.random.default_rng(5)
    logits = [rng.standard_normal((8, 64, 50)).astype(np.float32)
              for _ in loader]
    cfg = {"num_classes": 50, "eval_category_mask": True}
    t_step, j_step = _fixed_steps(logits)
    got = tpartseg.evaluate(t_step, None, loader, cfg, "cpu")
    want = jpartseg.evaluate(j_step, None, loader, cfg)
    assert abs(got["ins_miou"] - want["ins_miou"]) <= ATOL
    np.testing.assert_array_equal(tpartseg._part_mask(50),
                                  jpartseg._part_mask(50))
    ragged = {"pos": [np.zeros((5, 3)), np.zeros((4, 3))]}
    with pytest.raises(ValueError, match="ragged"):
        tpartseg._batch(ragged, "cpu")
    b = tpartseg._batch(loader[0], "cpu")
    assert set(b) == {"pos", "x", "y"} and b["pos"].dtype == torch.float32
    assert set(tcls._batch({"pos": np.zeros((2, 4, 3), np.float32),
                            "x": np.zeros((2, 4, 4), np.float32),
                            "y": np.zeros(2, np.int64)}, "cpu")) == {
        "pos", "x", "y"}


# --- the trainer -----------------------------------------------------------------

TINY = {"cls_pointnet2": "scanobjectnn/pointnet2cls.yaml",
        "cls_dgcnn": "scanobjectnn/dgcnncls.yaml",
        "cls_pointmlp": "scanobjectnn/pointmlpcls.yaml",
        "part_pointnet2": "shapenetpart/pointnet2part.yaml",
        "part_pointmlp": "shapenetpart/pointmlppart.yaml"}


def _args(name, root, *extra):
    path, opts = MODELS[name]
    assert path == TINY[name]
    return ["--cfg", os.path.join(ROOT, "cfgs", path), "device=cpu",
            f"root_dir={root}", "dataset.common.num_points=128",
            "batch_size=8", "batch_size_val=8", "seed=0",
            "dataloader.num_workers=3", *opts, *extra]


def _run_dir(root, task):
    (d,) = [os.path.join(root, task, x)
            for x in os.listdir(os.path.join(root, task))]
    return d


def _scalars(run_dir):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [json.loads(x) for x in f]


@pytest.mark.parametrize("name", sorted(TINY))
def test_trainer_trains_and_tests_each_config(name, tmp_path):
    """``parse_and_run`` for one epoch with validation and checkpoints,
    then ``mode=test`` on the best checkpoint: its metrics equal the
    run's validation (the val split is the test split)."""
    task = TINY[name].split("/")[0]
    res = ttrain.parse_and_run(_args(name, tmp_path, "epochs=1",
                                     "save_freq=1"))
    best = res["best"]
    primary = "oa" if task == "scanobjectnn" else "ins_miou"
    names = ("oa", "macc") if primary == "oa" else ("ins_miou", "cls_miou")
    for k in names:
        assert np.isfinite(best[k]) and 0.0 <= best[k] <= 100.0, (k, best)
    run_dir = _run_dir(tmp_path, task)
    sc = {d["tag"]: d["value"] for d in _scalars(run_dir)}
    assert np.isfinite(sc["train/loss"]) and f"val/{primary}" in sc
    ck = os.path.join(run_dir, "checkpoint")
    run_name = os.path.basename(run_dir)
    for tag in ("latest", "best", "E1"):
        assert os.path.exists(ckpt_path(ck, run_name, tag)), tag
    res_t = ttrain.parse_and_run(_args(
        name, tmp_path, "mode=test",
        f"pretrained_path={ckpt_path(ck, run_name, 'best')}"))
    for k in names:
        assert res_t[k] == pytest.approx(best[k], abs=1e-9), k
    if primary == "ins_miou":
        assert res_t["per_category"] == pytest.approx(best["per_category"])


def test_resume_continues_bit_exact(tmp_path):
    """Two epochs of PointNet++ part segmentation; ``mode=resume`` from the
    epoch-1 checkpoint writes epoch 2's loss and validation bit-equal to
    the uninterrupted run's, and the best carried over."""
    name = "part_pointnet2"
    common = ("epochs=2", "save_freq=1")
    res = ttrain.parse_and_run(_args(name, tmp_path, *common))
    run_dir = _run_dir(tmp_path, "shapenetpart")
    a2 = {d["tag"]: d["value"] for d in _scalars(run_dir) if d["step"] == 2}
    n_lines = len(_scalars(run_dir))
    e1 = ckpt_path(os.path.join(run_dir, "checkpoint"),
                   os.path.basename(run_dir), "E1")
    res_b = ttrain.parse_and_run(_args(name, tmp_path, "mode=resume",
                                       f"pretrained_path={e1}", *common))
    b = _scalars(run_dir)[n_lines:]
    assert {d["step"] for d in b} == {2}
    b2 = {d["tag"]: d["value"] for d in b}
    skip = ("epoch_seconds",)
    assert {k: v for k, v in b2.items() if k not in skip} == \
        {k: v for k, v in a2.items() if k not in skip}
    assert res_b["best"] == res["best"]


def test_txt_tree_with_presample_through_the_trainer(tmp_path):
    """``cfgs/shapenetpart/pointnet2part.yaml`` on a txt tree: trains on
    ``trainval`` (shuffled, the tail dropped), validates on the presampled
    test split (the FPS cache written on the run's device), and a second
    run reads the cache."""
    tree = str(tmp_path / "tree")
    write_txt_tree(tree, np.random.default_rng(6))
    extra = (f"dataset.common.data_root={tree}", "dataset.common.num_points=64",
             "epochs=1", "batch_size=4", "batch_size_val=3")
    res = ttrain.parse_and_run(_args("part_pointnet2", tmp_path / "a",
                                     *extra))
    pkl = os.path.join(tree, "processed", "test_64_fps.pkl")
    assert os.path.exists(pkl)
    assert np.isfinite(res["best"]["ins_miou"])
    # 12 trainval shapes in batches of 4; 3 categories of 2 test shapes
    assert set(res["best"]["per_category"]) == {0, 1, 2}
    mtime = os.stat(pkl).st_mtime_ns
    res2 = ttrain.parse_and_run(_args("part_pointnet2", tmp_path / "b",
                                      *extra))
    assert os.stat(pkl).st_mtime_ns == mtime
    assert res2["best"] == res["best"]


def test_heritage_tasks_are_no_longer_refused(tmp_path):
    """``task: cls|partseg`` passes ``refuse_unported`` on their configs;
    an eval mode without ``pretrained_path`` refuses to score random
    weights; what stays unported is still refused by its key."""
    for path in TINY.values():
        cfg = EasyConfig()
        cfg.load(os.path.join(ROOT, "cfgs", path), recursive=True)
        ttrain.refuse_unported(cfg)
    with pytest.raises(FileNotFoundError, match="pretrained_path"):
        ttrain.parse_and_run(_args("cls_pointnet2", tmp_path, "mode=test"))
    for opt, key in (("dataset.common.NAME=ShapeNet55",
                      "dataset.common.NAME"), ("tp=2", "tp")):
        with pytest.raises(NotImplementedError, match=key):
            ttrain.parse_and_run(_args("part_pointnet2", tmp_path / "r", opt))
    assert not os.path.exists(tmp_path / "r")
