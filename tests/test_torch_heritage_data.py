"""The heritage datasets and the loader's thread pool against ``geot_tpu``:
every item of ``ScanObjectNN``, ``ShapeNetPart``, ``ShapeNetPartCurve`` and
``ShapeNetPartNormal`` (synthetic, and from trees the tests write: h5
files, a txt tree with ``class_choice``, ``multihead`` and ``presample``)
in a training and a test split at epochs 1 and 2, the presample cache
file, the loaders' batches with 1 and 6 worker threads, the training
splits, and OBJ scans parsed on the pool's threads.

Exact equality throughout: both packages run the same numpy draws on the
same bytes; the presample FPS indices are ``fps_ref``'s against
``geot_tpu``'s FPS on the CPU.
"""
import json
import os
import pickle

import h5py
import numpy as np
import pytest

from geot_tpu.data import build as jbuild
from geot_tpu.data import shapenetpart as jsp

from geot_tpu_torch.data import build as tbuild
from geot_tpu_torch.data import io as tio
from geot_tpu_torch.data import shapenetpart as tsp
from geot_tpu_torch.data import tooth_semi as tdata
from geot_tpu_torch.engine import train as ttrain

from test_torch_io import write_teeth3ds

# the first three of the 16, so that a category's index in the tree is its
# index in CLASSES16
CATEGORIES = (("Airplane", "02691156"), ("Bag", "02773838"),
              ("Cap", "02954340"))


def assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(b[k], list):      # a ragged entry of a batch
            assert type(a[k]) is list and len(a[k]) == len(b[k]), k
            for x, y in zip(a[k], b[k]):
                assert_items_equal({k: x}, {k: y})
            continue
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        assert np.shape(a[k]) == np.shape(b[k]), k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def assert_same_items(got, want, epochs=(1, 2)):
    assert len(got) == len(want) > 0
    for epoch in epochs:
        got.epoch = want.epoch = epoch
        for i in range(len(got)):
            assert_items_equal(got[i], want[i])


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_items_equal(a, b)


# --- the trees ----------------------------------------------------------------

@pytest.fixture(scope="module")
def h5_tree(tmp_path_factory):
    """ShapeNetPart shards (2 train, 1 val, 1 test; 5 shapes of 96 points
    each) and ScanObjectNN's three files (12 scans of 80 points)."""
    root = tmp_path_factory.mktemp("h5")
    rng = np.random.default_rng(11)
    part = root / "shapenetpart"
    part.mkdir()
    for name in ("ply_data_train0", "ply_data_train1", "ply_data_val0",
                 "ply_data_test0"):
        label = rng.integers(0, 16, (5, 1))
        with h5py.File(part / f"{name}.h5", "w") as f:
            f["data"] = rng.standard_normal((5, 96, 3)).astype(np.float32)
            f["label"] = label.astype(np.uint8)
            f["pid"] = np.stack([rng.choice(
                jsp.SHAPENETPART_CLS2PARTS[int(c)], 96) for c in label[:, 0]
            ]).astype(np.uint8)
    scan = root / "scanobjectnn"
    scan.mkdir()
    for name in ("training_objectdataset", "test_objectdataset",
                 "training_objectdataset_augmentedrot_scale75",
                 "test_objectdataset_augmentedrot_scale75"):
        with h5py.File(scan / f"{name}.h5", "w") as f:
            f["data"] = rng.standard_normal((12, 80, 3)).astype(np.float32)
            f["label"] = rng.integers(0, 15, 12).astype(np.int64)
    return str(part), str(scan)


def write_txt_tree(root, rng, sizes=(90, 70, 110)):
    """A ShapeNetPartNormal tree: 3 categories of 6 shapes (x y z nx ny nz
    part), 3 in train, 1 in val and 2 in test each; shape lengths cycle
    through ``sizes``."""
    os.makedirs(os.path.join(root, "train_test_split"), exist_ok=True)
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        f.writelines(f"{name}\t{syn}\n" for name, syn in CATEGORIES)
    splits = {"train": [], "val": [], "test": []}
    for c, (name, syn) in enumerate(CATEGORIES):
        os.makedirs(os.path.join(root, syn), exist_ok=True)
        parts = jsp.SHAPENETPART_CLS2PARTS[jsp.CLASSES16.index(name.lower())]
        for i in range(6):
            sid = f"{c}{i:04d}a"
            n = sizes[i % len(sizes)]
            rows = np.concatenate([
                rng.standard_normal((n, 6)).round(6),
                rng.choice(parts, (n, 1))], axis=1)
            np.savetxt(os.path.join(root, syn, sid + ".txt"), rows,
                       fmt="%.6f")
            split = "train" if i < 3 else "val" if i == 3 else "test"
            splits[split].append(f"shape_data/{syn}/{sid}")
    for s, ids in splits.items():
        with open(os.path.join(root, "train_test_split",
                               f"shuffled_{s}_file_list.json"), "w") as f:
            json.dump(ids, f)


@pytest.fixture(scope="module")
def txt_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("txt"))
    write_txt_tree(root, np.random.default_rng(12))
    return root


# --- the datasets -------------------------------------------------------------

@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("mode", ["synthetic", "objectbg", "objectonly",
                                  "hardest"])
def test_scanobjectnn_items_equal_geot_tpu(h5_tree, mode, split):
    """``pos``, ``x`` (the height channel) and ``y``, epochs 1 and 2."""
    root = "" if mode == "synthetic" else h5_tree[1]
    kw = dict(data_root=root, num_points=64, split=split,
              mode="hardest" if mode == "synthetic" else mode, seed=3)
    got, want = tsp.ScanObjectNN(**kw), jsp.ScanObjectNN(**kw)
    assert got.synthetic == (mode == "synthetic")
    assert_same_items(got, want)
    item = got[0]
    np.testing.assert_array_equal(
        item["x"][:, 3], item["pos"][:, 2] - item["pos"][:, 2].min())


@pytest.mark.parametrize("split", ["trainval", "train", "test"])
@pytest.mark.parametrize("cls_name", ["ShapeNetPart", "ShapeNetPartCurve"])
@pytest.mark.parametrize("source", ["synthetic", "h5"])
def test_shapenetpart_h5_items_equal_geot_tpu(h5_tree, source, cls_name,
                                              split):
    root = "" if source == "synthetic" else h5_tree[0]
    kw = dict(data_root=root, num_points=64, split=split, seed=1)
    got, want = getattr(tsp, cls_name)(**kw), getattr(jsp, cls_name)(**kw)
    assert len(got) == (32 if source == "synthetic" else
                        {"trainval": 15, "train": 10, "test": 5}[split])
    assert_same_items(got, want)


def test_shapenetpart_h5_class_choice_equal_geot_tpu(h5_tree):
    label = jsp._load_h5_partseg("trainval", h5_tree[0])[1]
    choice = jsp.CLASSES16[int(label[0, 0])]
    kw = dict(data_root=h5_tree[0], num_points=64, split="trainval",
              class_choice=choice)
    got, want = tsp.ShapeNetPart(**kw), jsp.ShapeNetPart(**kw)
    assert got.seg_num_all == want.seg_num_all
    assert got.seg_start_index == want.seg_start_index
    assert_same_items(got, want)


@pytest.mark.parametrize("extra", [
    {}, {"use_normal": False}, {"multihead": True},
    {"class_choice": "chair"}], ids=["normals", "xyz", "multihead",
                                     "class_choice"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_shapenetpart_normal_synthetic_equal_geot_tpu(split, extra):
    kw = dict(num_points=64, split=split, **extra)
    assert_same_items(tsp.ShapeNetPartNormal(**kw),
                      jsp.ShapeNetPartNormal(**kw))


@pytest.mark.parametrize("extra", [
    {}, {"multihead": True}, {"class_choice": "Cap"}],
    ids=["all", "multihead", "class_choice"])
@pytest.mark.parametrize("split", ["trainval", "train", "test"])
def test_shapenetpart_normal_txt_equal_geot_tpu(txt_tree, split, extra):
    """From the txt tree: the items, the category map and the file list
    (a ``test`` item keeps its first ``num_points`` points, shorter shapes
    whole)."""
    kw = dict(data_root=txt_tree, num_points=80, split=split, **extra)
    got, want = tsp.ShapeNetPartNormal(**kw), jsp.ShapeNetPartNormal(**kw)
    assert got.items == want.items and got.classes_map == want.classes_map
    assert len(got) == {"trainval": 12, "train": 9, "test": 6}[split] // (
        3 if "class_choice" in extra else 1)
    assert_same_items(got, want)


def test_presample_cache_equals_geot_tpus(tmp_path):
    """``presample`` on two copies of a tree: the pickles hold the same
    arrays (the FPS indices bit-equal: the rows are the cloud's at them),
    a second dataset reads the cache without sampling again, and the
    items are equal."""
    trees = []
    for side in ("port", "jax"):
        root = str(tmp_path / side)
        write_txt_tree(root, np.random.default_rng(13))
        trees.append(root)
    kw = dict(num_points=80, split="test", presample=True)
    got = tsp.ShapeNetPartNormal(data_root=trees[0], device="cpu", **kw)
    want = jsp.ShapeNetPartNormal(data_root=trees[1], **kw)
    pkl = [os.path.join(t, "processed", "test_80_fps.pkl") for t in trees]
    with open(pkl[0], "rb") as f:
        data_t, cls_t = pickle.load(f)
    with open(pkl[1], "rb") as f:
        data_j, cls_j = pickle.load(f)
    assert len(data_t) == len(data_j) == 6
    for a, b in zip(data_t + cls_t, data_j + cls_j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert {len(a) for a in data_t} == {70, 80}
    assert_same_items(got, want)
    os.utime(pkl[0], (0, 0))
    again = tsp.ShapeNetPartNormal(data_root=trees[0], device="cpu", **kw)
    assert os.stat(pkl[0]).st_mtime == 0
    assert_same_items(again, want, epochs=(1,))


def test_presample_without_a_card_raises(txt_tree, tmp_path):
    """The default device is the card; without one the FPS is not run on
    the CPU behind the caller's back."""
    import shutil

    root = str(tmp_path / "tree")
    shutil.copytree(txt_tree, root)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsp.ShapeNetPartNormal(data_root=root, num_points=80, split="test",
                               presample=True)


def test_constants_equal_geot_tpus():
    for name in ("CLASSES16", "SEG_NUM", "PART_START",
                 "SHAPENETPART_CLS2PARTS"):
        assert getattr(tsp, name) == getattr(jsp, name), name
    np.testing.assert_array_equal(tsp._cls2partembed(), jsp._cls2partembed())
    rng = np.random.default_rng(2)
    pc = rng.standard_normal((50, 3)).astype(np.float32)
    for fn in ("translate_pointcloud", "jitter_pointcloud",
               "rotate_pointcloud"):
        np.testing.assert_array_equal(
            getattr(tsp, fn)(pc, rng=np.random.default_rng(5)),
            getattr(jsp, fn)(pc, rng=np.random.default_rng(5)), err_msg=fn)
    for idx in (0, 7, 31):
        for a, b in zip(tsp._synth_part(idx, 40), jsp._synth_part(idx, 40)):
            np.testing.assert_array_equal(a, b)


# --- the loader ---------------------------------------------------------------

LOADER_CASES = {
    "scanobjectnn_train": ({"common": {"NAME": "ScanObjectNN",
                                       "num_points": 64}}, "train", 12),
    "scanobjectnn_test": ({"common": {"NAME": "ScanObjectNN",
                                      "num_points": 64}}, "test", 12),
    "shapenetpart_trainval": ({"common": {"NAME": "ShapeNetPartNormal",
                                          "num_points": 64}}, "trainval", 5),
    "shapenetpart_h5_trainval": ({"common": {"NAME": "ShapeNetPart",
                                             "num_points": 64}},
                                 "trainval", 5),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_batches_equal_geot_tpus_with_any_worker_count(case):
    """With 1 and 6 worker threads, and with more threads than cores
    switching every microsecond, the port's loader gives the same batches
    in the same order as ``geot_tpu``'s (epochs 1 and 2); a training split
    (``trainval`` too) is shuffled and drops its tail."""
    import sys

    ds, split, bs = LOADER_CASES[case]
    want = jbuild.build_dataloader_from_cfg(bs, ds, {"num_workers": 3},
                                            split=split, seed=4)
    many = (os.cpu_count() or 1) + 2
    got = {w: tbuild.build_dataloader_from_cfg(
        bs, ds, split=split, seed=4, dataloader_cfg={"num_workers": w})
        for w in (1, 6, many)}
    assert got[6].num_workers == 6 and got[1].num_workers == 1
    train = split in ("train", "trainval")
    for loader in got.values():
        assert loader.shuffle == loader.drop_last == train
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for epoch in (1, 2):
            want.set_epoch(epoch)
            ref = list(want)
            assert len(ref) == len(want.dataset) // bs if train else \
                -(-len(want.dataset) // bs)
            for loader in got.values():
                loader.set_epoch(epoch)
                assert_batches_equal(list(loader), ref)
    finally:
        sys.setswitchinterval(interval)


def test_training_split_rules_and_worker_default():
    ds = {"common": {"NAME": "ShapeNetPartNormal", "num_points": 32}}
    for split, train in (("trainval", True), ("training", True),
                         ("train", True), ("test", False), ("val", False)):
        loader = tbuild.build_dataloader_from_cfg(4, ds, split=split)
        assert loader.shuffle == loader.drop_last == train, split
        assert loader.num_workers == 4
    loader = tbuild.build_dataloader_from_cfg(4, ds, split="trainval",
                                              is_train=False)
    assert not loader.shuffle and not loader.drop_last
    loader = tbuild.build_dataloader_from_cfg(4, ds, split="test",
                                              is_train=True)
    assert loader.shuffle and loader.drop_last
    loader.set_epoch(1)
    a = loader._epoch_indices().tolist()
    loader.set_epoch(2)
    b = loader._epoch_indices().tolist()
    assert a != b and sorted(a) == sorted(b)


def test_obj_scans_parse_on_the_pool_threads(tmp_path):
    """A Teeth3DS tree of OBJ scans read through the native parser on 6
    threads at once: the loader's batches equal those of one thread and of
    ``geot_tpu``'s loader, and each thread's parse equals the numpy
    parser's."""
    import concurrent.futures as fut

    root = str(tmp_path / "teeth3ds")
    scans = []
    for i in range(12):
        pts, labels = tdata._synthetic_scan(90 + i, 3000 + 37 * i)
        scans.append((f"P{i:03d}", i % 2, pts, labels))
    write_teeth3ds(root, scans)
    paths = [os.path.join(root, f) for f in sorted(os.listdir(root))
             if f.endswith(".obj")]
    with fut.ThreadPoolExecutor(6) as pool:
        parsed = list(pool.map(tio.load_obj_vertices, paths * 4))
    for path, got in zip(paths * 4, parsed):
        np.testing.assert_array_equal(got, tio.load_obj_vertices_numpy(path))
    ds = {"common": {"NAME": "TeethSegSemiLDataset", "data_root": root,
                     "num_points": 256}}
    want = jbuild.build_dataloader_from_cfg(2, ds, None, split="test")
    ref = list(want)
    for w in (1, 6):
        got = tbuild.build_dataloader_from_cfg(
            2, ds, split="test", dataloader_cfg={"num_workers": w})
        assert_batches_equal(list(got), ref)


def test_unported_dataset_names_are_refused(tmp_path):
    """A dataset name that neither package registers (``S3DIS``) raises
    ``NotImplementedError`` naming it, in the loader and, by its dotted
    key, before a run directory is made."""
    with pytest.raises(NotImplementedError, match="S3DIS"):
        tbuild.build_dataloader_from_cfg(
            2, {"common": {"NAME": "S3DIS"}}, split="train")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for key in ("dataset.common.NAME", "dataset.test.NAME"):
        with pytest.raises(NotImplementedError, match=key):
            ttrain.parse_and_run([
                "--cfg", os.path.join(root, "cfgs/scanobjectnn/dgcnncls.yaml"),
                f"{key}=S3DIS", f"root_dir={tmp_path}", "device=cpu"])
    assert not os.path.exists(tmp_path / "scanobjectnn")
