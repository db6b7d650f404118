"""The dataset utilities, the record cache, the visualisers and the
package surfaces against ``geot_tpu``: ``data_util`` (``EpochSeededRNG``,
``get_features_by_keys``, ``get_class_weights``, the hashes, ``voxelize``
in both modes, ``crop_pc``, ``rotate_point_clouds_batch``),
``DatasetBase`` / ``DataList`` with caches written by either package and
read by the other, the files of ``vis3d`` and ``vis2d``, and the names of
``data``, ``utils``, the datasets and the losses.

Bit-equal (byte-equal for files) throughout, but for the tensor branches:
``get_features_by_keys`` on tensors equals the numpy branch exactly and
``rotate_point_clouds_batch`` on tensors within 1e-12 in float64 and 1e-6
in float32 (an einsum's summation order).
"""
import os
import pickle

import numpy as np
import pytest
import torch

import geot_tpu.data as jdata
import geot_tpu.utils as jutils
from geot_tpu.data import data_util as jdu
from geot_tpu.data import dataset_base as jdb
from geot_tpu.losses import cluster_contrast as jcc
from geot_tpu.utils import vis2d as jvis2d
from geot_tpu.utils import vis3d as jvis3d

import geot_tpu_torch.data as tdata
import geot_tpu_torch.utils as tutils
from geot_tpu_torch.data import data_util as tdu
from geot_tpu_torch.data import dataset_base as tdb
from geot_tpu_torch.losses import cluster_contrast as tcc
from geot_tpu_torch.utils import vis2d as tvis2d
from geot_tpu_torch.utils import vis3d as tvis3d


def _eq(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
        return
    if a is None or b is None:
        assert a is None and b is None
        return
    assert np.asarray(a).dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(a, b)


# --- the surfaces ------------------------------------------------------------

def test_surfaces_match_geot_tpu_name_for_name():
    assert set(tdata.__all__) == set(jdata.__all__)
    assert set(tutils.__all__) == set(jutils.__all__)
    for mod, names in ((tdata, tdata.__all__), (tutils, tutils.__all__)):
        for n in names:
            assert getattr(mod, n) is not None, n
    assert set(tdata.DATASETS) == set(jdata.DATASETS.module_dict)
    assert set(tdata.DataTransforms) == set(jdata.DataTransforms.module_dict)
    public = {n for n in dir(jcc) if not n.startswith("_")
              and getattr(getattr(jcc, n), "__module__", "") == jcc.__name__}
    assert public <= set(dir(tcc)), public - set(dir(tcc))
    assert tcc.K_SPLIT == jcc.K_SPLIT


# --- data_util ---------------------------------------------------------------

def test_epoch_seeded_rng_and_small_helpers():
    a, b = tdu.EpochSeededRNG(), jdu.EpochSeededRNG()
    a.seed = b.seed = 5
    a.epoch = b.epoch = 3
    assert a._rng(7).bit_generator.state == b._rng(7).bit_generator.state
    rng = np.random.default_rng(0)
    data = {"pos": rng.standard_normal((4, 10, 3)),
            "x": rng.standard_normal((4, 10, 2)),
            "heights": rng.standard_normal((4, 10, 1))}
    for keys in ("pos", "pos,x", "x,heights,pos"):
        _eq(tdu.get_features_by_keys(data, keys),
            jdu.get_features_by_keys(data, keys))
        got = tdu.get_features_by_keys(
            {k: torch.from_numpy(v) for k, v in data.items()}, keys)
        assert torch.is_tensor(got)
        np.testing.assert_array_equal(got.numpy(),
                                      jdu.get_features_by_keys(data, keys))
    for counts in ([10, 0, 3, 7], np.arange(1, 18) * 1000):
        for normalize in (False, True):
            _eq(tdu.get_class_weights(counts, normalize),
                jdu.get_class_weights(counts, normalize))
    ang = np.random.default_rng(1).uniform(-3, 3, (6, 2))
    _eq(tdu.rotate_theta_phi(ang), jdu.rotate_theta_phi(ang))


def test_hashes_are_bit_equal():
    rng = np.random.default_rng(2)
    for arr in (rng.integers(-50, 50, (300, 3)).astype(np.float64),
                rng.integers(0, 2 ** 20, (200, 4)).astype(np.int64),
                np.floor(rng.standard_normal((100, 3)) / 0.05)):
        _eq(tdu.fnv_hash_vec(arr), jdu.fnv_hash_vec(arr))
        _eq(tdu.ravel_hash_vec(arr), jdu.ravel_hash_vec(arr))
    for fn in (tdu.fnv_hash_vec, tdu.ravel_hash_vec):
        with pytest.raises(ValueError):
            fn(np.zeros(3))


@pytest.mark.parametrize("hash_type", ["fnv", "ravel"])
def test_voxelize_both_modes_bit_equal(hash_type):
    rng = np.random.default_rng(3)
    coord = rng.uniform(0, 1, (2000, 3))
    for size in (0.05, (0.1, 0.05, 0.2)):
        ra, rb = np.random.default_rng(4), np.random.default_rng(4)
        _eq(tdu.voxelize(coord, size, hash_type, 0, rng=ra),
            jdu.voxelize(coord, size, hash_type, 0, rng=rb))
        assert ra.bit_generator.state == rb.bit_generator.state
        _eq(tdu.voxelize(coord, size, hash_type, 1),
            jdu.voxelize(coord, size, hash_type, 1))


@pytest.mark.parametrize("kw", [
    {"split": "train", "voxel_size": 0.05, "voxel_max": 300},
    {"split": "val", "voxel_size": 0.05, "voxel_max": 300,
     "shuffle": False},
    {"split": "train", "voxel_size": 0.2, "voxel_max": 900,
     "variable": False},
    {"split": "train", "voxel_size": None, "voxel_max": 500},
    {"split": "train", "voxel_size": 0.05, "downsample": False},
    {"split": "test", "voxel_size": 0.1, "voxel_max": 2000},
])
def test_crop_pc_bit_equal(kw):
    rng = np.random.default_rng(5)
    coord = rng.uniform(0, 2, (1500, 3))
    feat = rng.uniform(0, 1, (1500, 3))
    label = rng.integers(0, 13, 1500)
    for f, lab in ((feat, label), (None, None)):
        ra, rb = np.random.default_rng(6), np.random.default_rng(6)
        _eq(tdu.crop_pc(coord, f, lab, rng=ra, **kw),
            jdu.crop_pc(coord, f, lab, rng=rb, **kw))
        assert ra.bit_generator.state == rb.bit_generator.state


@pytest.mark.parametrize("use_normals", [False, True])
def test_rotate_point_clouds_batch(use_normals):
    rng = np.random.default_rng(8)
    pc = rng.standard_normal((3, 50, 6 if use_normals else 3))
    R = tdu.rotate_theta_phi(rng.uniform(-3, 3, (3, 2)))
    for dt in (np.float32, np.float64):
        want = jdu.rotate_point_clouds_batch(pc.astype(dt), R, use_normals)
        _eq(tdu.rotate_point_clouds_batch(pc.astype(dt), R, use_normals),
            want)
        got = tdu.rotate_point_clouds_batch(torch.from_numpy(pc.astype(dt)),
                                            R, use_normals)
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 if dt == np.float64 else 1e-6)


# --- DatasetBase / DataList --------------------------------------------------

class _Squares:
    """A ``DatasetBase`` whose records are computed from their token."""

    def __init__(self, base, n, **kw):
        self.n = n
        base.__init__(self, "squares", "train", **kw)

    @property
    def record_tokens(self):
        return [f"t{i}" for i in range(self.n)]

    def read_record(self, token):
        i = int(token[1:])
        return {"sq": np.arange(i) ** 2, "name": token}


def _squares(pkg):
    base = (tdb if pkg == "torch" else jdb).DatasetBase
    return type(f"Squares_{pkg}", (_Squares, base), {})


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_record_cache_is_read_by_the_other_package(writer, reader,
                                                   tmp_path):
    w = _squares(writer)(_squares(writer).__mro__[2], 6,
                         cache_dir=str(tmp_path))
    assert not w.is_cached
    w.cache()
    assert w.is_cached
    base = tmp_path / "squares" / "train"
    assert sorted(os.listdir(base)) == ["records.pkl", "tokens.pkl"]
    r = _squares(reader)(_squares(reader).__mro__[2], 99,
                         cache_dir=str(tmp_path))
    assert r.is_cached
    assert r._record_tokens == [f"t{i}" for i in range(6)]
    for i in range(6):
        _eq(r[i]["sq"], w[i]["sq"])
        assert r[i]["name"] == w[i]["name"]
    with open(base / "records.pkl", "rb") as f:
        raw = pickle.load(f)
    assert set(raw) == {f"t{i}" for i in range(6)}


def test_dataset_base_lazy_records_and_errors(tmp_path):
    for pkg in ("torch", "jax"):
        cls = _squares(pkg)
        ds = cls(cls.__mro__[2], 4)
        assert len(ds) == 4 and not ds.is_cached
        _eq(ds[3]["sq"], np.arange(3) ** 2)
        _eq(ds[1]["sq"], np.arange(1) ** 2)
        with pytest.raises(ValueError, match="Unknown operation"):
            ds.cache_load_and_save(tmp_path, "copy", 0)
        missing = cls(cls.__mro__[2], 2, cache_dir=str(tmp_path / pkg))
        assert not missing.is_cached


@pytest.mark.parametrize("voxel_size", [None, 0.1])
def test_datalist_s3dis_scenes_equal(voxel_size, tmp_path):
    rng = np.random.default_rng(9)
    paths = []
    for i in range(2):
        scene = np.concatenate([rng.uniform(0, 3, (400, 3)),
                                rng.uniform(0, 255, (400, 3)),
                                rng.integers(0, 13, (400, 1))], axis=1)
        p = tmp_path / f"Area_{i}.npy"
        np.save(p, scene)
        paths.append(str(p))
    got = tdb.DataList("s3dis", "train", paths, voxel_size=voxel_size,
                       cache_dir=str(tmp_path / "cache"))
    got.cache()
    want = jdb.DataList("s3dis", "train", paths, voxel_size=voxel_size,
                        cache_dir=str(tmp_path / "cache"))
    assert want.is_cached           # read from the port's cache
    for i in range(2):
        fresh = jdb.DataList("s3dis", "train", paths,
                             voxel_size=voxel_size).load_data(paths[i])
        for a, b, c in zip(got[i], want[i], fresh):
            if isinstance(a, list):
                assert len(a) == len(b) == len(c) > 0
                for x, y, z in zip(a, b, c):
                    _eq(x, y)
                    _eq(x, z)
            else:
                _eq(a, b)
                _eq(a, c)
    for pkg in (tdb, jdb):
        with pytest.raises(NotImplementedError):
            pkg.DataList("modelnet", "train", paths).load_data(paths[0])


# --- the visualisers ---------------------------------------------------------

def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_visualiser_files_are_byte_equal(tmp_path):
    rng = np.random.default_rng(10)
    pts = [rng.standard_normal((40, 3)).astype(np.float32),
           rng.standard_normal((1, 30, 3))]
    labels = [rng.integers(0, 17, 40), None]
    colors = [None, rng.uniform(0, 1, (30, 3))]
    obj_colors = rng.integers(0, 255, (40, 3))
    imgs = [rng.uniform(0, 1, (3, 16, 16)),
            np.linspace(0, 1, 16 * 16 * 3).reshape(16, 16, 3)]
    trees = {}
    for pkg, mod3, mod2 in (("torch", tvis3d, tvis2d),
                            ("jax", jvis3d, jvis2d)):
        root = tmp_path / pkg
        root.mkdir()
        mod3.vis_points(pts[0], labels=labels[0],
                        out=str(root / "points.ply"))
        mod3.vis_multi_points(pts, colors=colors, labels=labels,
                              out_dir=str(root / "multi"), save_fig=True,
                              save_name="panel")
        mod3.vis_neighbors(pts[0], pts[0][:5], 3, out_dir=str(root / "nb"))
        mod3.write_obj(pts[0], obj_colors, str(root / "c.obj"))
        mod2.show_imgs(imgs, out=str(root / "imgs" / "i.png"))
        mod2.show_imgs(np.full((8, 8, 3), 0.5), out=str(root / "one.png"))
        trees[pkg] = _files(root)
    assert set(trees["torch"]) == set(trees["jax"])
    assert len(trees["torch"]) == 8
    for name, data in trees["torch"].items():
        assert data == trees["jax"][name], name
    with open(tmp_path / "v.obj", "w") as f:
        f.write("# c\nv 1 2 3 0.1 0.2 0.3\nv 4 5 6\nvn 0 0 1\nf 1 2 3\n")
    for a, b in zip(tvis3d.read_obj(str(tmp_path / "v.obj")),
                    jvis3d.read_obj(str(tmp_path / "v.obj"))):
        _eq(a, b)
    for a, b in zip(tvis3d.read_obj(str(tmp_path / "torch" / "c.obj")),
                    jvis3d.read_obj(str(tmp_path / "jax" / "c.obj"))):
        _eq(a, b)
