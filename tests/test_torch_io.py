"""The port's file input against ``geot_tpu``'s: the OBJ parser on every
case of the fuzz corpus (``tests/test_obj_fuzz.py``), PLY reading (ascii
and binary, both endiannesses), ``IO.get`` by extension, ``save_ply``, and
Teeth3DS read from a directory tree that the test writes: every field of
the train, val and test items of both datasets with the flagship's
transforms. Exact equality throughout: both sides run the same numpy
arithmetic on the same bytes."""
import json
import os

import numpy as np
import pytest

from geot_tpu.data import io as jio
from geot_tpu.data import tooth_semi as jdata
from geot_tpu.data.transforms import build_transforms_from_cfg as jtransforms
from geot_tpu.native import get_lib, obj_loader
from geot_tpu.utils.vis3d import save_ply as jsave_ply

from geot_tpu_torch import FLAGSHIP_SEMI_CFG
from geot_tpu_torch.data import io as tio
from geot_tpu_torch.data import tooth_semi as tdata
from geot_tpu_torch.data.transforms import build_transforms_from_cfg
from geot_tpu_torch.engine.predict import map_pred_to_fdi
from geot_tpu_torch.utils.vis3d import save_ply

from test_obj_fuzz import CASES


def _native_on():
    if get_lib() is None:
        pytest.skip("geot_tpu's native parser does not build here")


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_obj_parser_matches_geot_tpu(tmp_path, monkeypatch, name, native):
    """Each corpus case through the port's parser and ``geot_tpu``'s
    ``load_obj_vertices``, its C++ parser on and off: the same (N, 3)
    float32 array (``binary_garbage``: no crash, equal output), and the
    corpus's expected vertices where it names them."""
    body, want = CASES[name]
    path = tmp_path / "scan.obj"
    path.write_bytes(body)
    if native:
        _native_on()
    else:
        monkeypatch.setattr(obj_loader, "load_vertices", lambda _: None)
    ref = jio.load_obj_vertices(str(path))
    got = tio.load_obj_vertices(str(path))
    assert got.dtype == np.float32 and got.shape[1:] == (3,)
    np.testing.assert_array_equal(got, ref.reshape(-1, 3))
    if want is not None:
        np.testing.assert_array_equal(
            got, np.asarray(want, np.float32).reshape(-1, 3))


def _binary_ply(path, pts, endian):
    """A binary PLY with x, y, z between a double and a uchar property,
    and a face list after the vertices."""
    dt = np.dtype([("nx", endian + "f8"), ("x", endian + "f4"),
                   ("y", endian + "f4"), ("z", endian + "f4"),
                   ("red", "u1")])
    rows = np.zeros(len(pts), dt)
    rows["nx"] = 0.5
    rows["x"], rows["y"], rows["z"] = pts.T
    rows["red"] = 7
    fmt = "binary_big_endian" if endian == ">" else "binary_little_endian"
    head = (f"ply\nformat {fmt} 1.0\ncomment made by a test\n"
            f"element vertex {len(pts)}\nproperty double nx\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nelement face 1\n"
            "property list uchar int vertex_indices\nend_header\n")
    face = np.array([3], np.uint8).tobytes() + \
        np.array([0, 1, 2], endian + "i4").tobytes()
    path.write_bytes(head.encode() + rows.tobytes() + face)


@pytest.mark.parametrize("kind", ["ascii", "ascii_colors",
                                  "binary_little_endian",
                                  "binary_big_endian"])
def test_ply_reader_matches_geot_tpu(tmp_path, kind):
    pts = np.random.default_rng(3).standard_normal((50, 3)).astype(
        np.float32)
    path = tmp_path / "cloud.ply"
    if kind.startswith("ascii"):
        labels = np.arange(50) % 17 if kind == "ascii_colors" else None
        jsave_ply(str(path), pts, labels=labels)
        want = np.round(pts.astype(np.float64), 5).astype(np.float32)
        atol = 6e-6   # the 5-decimal text
    else:
        _binary_ply(path, pts, ">" if "big" in kind else "<")
        want, atol = pts, 0
    got = tio._read_ply_xyz(str(path))
    np.testing.assert_array_equal(got, jio._read_ply_xyz(str(path)))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_array_equal(tio.IO.get(str(path)), got)


@pytest.mark.parametrize("labels", [None, np.arange(40) % 19],
                         ids=["plain", "labels"])
def test_save_ply_writes_geot_tpus_bytes(tmp_path, labels):
    pts = np.random.default_rng(4).standard_normal((40, 3)) * 3
    save_ply(str(tmp_path / "a.ply"), pts, labels=labels)
    jsave_ply(str(tmp_path / "b.ply"), pts, labels=labels)
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()


def test_io_get_matches_geot_tpu(tmp_path):
    rng = np.random.default_rng(5)
    arr = rng.standard_normal((20, 3)).astype(np.float32)
    np.save(tmp_path / "a.npy", arr)
    np.savez(tmp_path / "a.npz", data=arr)
    np.savetxt(tmp_path / "a.txt", arr)
    (tmp_path / "a.json").write_text(json.dumps({"labels": [0, 11, 48]}))
    for ext in ("npy", "npz", "txt", "json"):
        path = str(tmp_path / f"a.{ext}")
        got, want = tio.IO.get(path), jio.IO.get(path)
        if ext == "json":
            assert got == want == {"labels": [0, 11, 48]}
            continue
        assert got.dtype == want.dtype, ext
        np.testing.assert_array_equal(got, want, err_msg=ext)
    (tmp_path / "a.off").write_text("")
    for io_mod in (tio, jio):
        with pytest.raises(ValueError, match="unsupported extension"):
            io_mod.IO.get(str(tmp_path / "a.off"))


# --- Teeth3DS on disk ---------------------------------------------------------

def write_obj(path, pts):
    with open(path, "w") as f:
        f.write("# scan\n")
        f.writelines(f"v {x!r} {y!r} {z!r}\nvn 0 0 1\n"
                     for x, y, z in pts.astype(np.float64).tolist())
        f.write("f 1 2 3\n")


def write_teeth3ds(root, scans):
    """A Teeth3DS tree under ``root``: ``<id>_<jaw>.obj`` scans, JSON label
    files in FDI codes of the jaw, ``data.json`` with absolute paths, and
    the split lists ``semi_l_train_0.2.txt`` (the first half of the scans),
    ``semi_u_train_0.2.txt`` (the rest) and ``testing.txt`` (every scan).
    ``scans``: ``(mesh_id, jaw, points, class ids)``."""
    os.makedirs(root, exist_ok=True)
    index = {"scans": {}, "gt": {}}
    lines = []
    for mesh_id, jaw, pts, labels in scans:
        line = f"{mesh_id}_{'lower' if jaw == 0 else 'upper'}"
        obj = os.path.join(root, line + ".obj")
        gt = os.path.join(root, line + ".json")
        write_obj(obj, pts)
        with open(gt, "w") as f:
            json.dump({"id_patient": mesh_id,
                       "labels": map_pred_to_fdi(labels, jaw)}, f)
        index["scans"][line] = obj
        index["gt"][line] = gt
        lines.append(line)
    with open(os.path.join(root, "data.json"), "w") as f:
        json.dump(index, f)
    half = len(lines) // 2
    for name, part in (("semi_l_train_0.2.txt", lines[:half]),
                       ("semi_u_train_0.2.txt", lines[half:]),
                       ("testing.txt", lines)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(part) + "\n\n")


@pytest.fixture(scope="module")
def teeth3ds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("teeth3ds"))
    scans = []
    for i in range(4):
        pts, labels = tdata._synthetic_scan(70 + i, 600 + 50 * i)
        scans.append((f"P{i:03d}", i % 2, pts, labels))
    write_teeth3ds(root, scans)
    return root, scans


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert type(a[k]) is type(b[k]), k
        if isinstance(b[k], str):
            assert a[k] == b[k], k
            continue
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        assert np.shape(a[k]) == np.shape(b[k]), k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_teeth3ds_items_equal_geot_tpu(teeth3ds, split):
    """Both datasets read from the tree: the same split lists, jaws and
    patients, and every field of every item equal to ``geot_tpu``'s, the
    full-resolution scan and labels of the val/test items too."""
    root, scans = teeth3ds
    tf = FLAGSHIP_SEMI_CFG["datatransforms"]
    n = 256
    lt = "train" if split == "train" else "val"
    got_l = tdata.TeethSegSemiLDataset(
        root, n, split, transform=build_transforms_from_cfg(lt, tf))
    want_l = jdata.TeethSegSemiLDataset(root, n, split,
                                        transform=jtransforms(lt, tf))
    got_u = tdata.TeethSegSemiUDataset(
        root, n, split, transform_w=build_transforms_from_cfg("train_w", tf),
        transform_s=build_transforms_from_cfg("train_s", tf))
    want_u = jdata.TeethSegSemiUDataset(
        root, n, split, transform_w=jtransforms("train_w", tf),
        transform_s=jtransforms("train_s", tf))
    for got, want in ((got_l, want_l), (got_u, want_u)):
        assert not got.synthetic and not want.synthetic
        assert got.file_list == want.file_list
        assert len(got) == (len(scans) if split != "train" else 2)
        got.epoch = want.epoch = 1
        for i in range(len(got)):
            _assert_items_equal(got[i], want[i])
    if split == "test":
        item = got_l[1]
        mesh_id, jaw, pts, labels = scans[1]
        assert item["patient"] == mesh_id and item["cls"][0] == jaw
        np.testing.assert_array_equal(item["points"], pts)
        np.testing.assert_array_equal(item["labels"], labels)


def test_teeth3ds_keeps_geot_tpus_errors(tmp_path, teeth3ds):
    """A label outside the FDI map raises ``KeyError`` in both packages; a
    relative path in ``data.json`` resolves against the working
    directory, not ``data_root``."""
    root, _ = teeth3ds
    bad = str(tmp_path / "bad")
    pts, labels = tdata._synthetic_scan(9, 300)
    write_teeth3ds(bad, [("Q000", 0, pts, labels), ("Q001", 1, pts, labels)])
    gt = os.path.join(bad, "Q000_lower.json")
    with open(gt) as f:
        d = json.load(f)
    d["labels"][5] = 19
    with open(gt, "w") as f:
        json.dump(d, f)
    for ds in (tdata.TeethSegSemiLDataset(bad, 64, "train"),
               jdata.TeethSegSemiLDataset(bad, 64, "train")):
        with pytest.raises(KeyError):
            ds[0]
    with open(os.path.join(bad, "data.json")) as f:
        index = json.load(f)
    index["scans"]["Q001_upper"] = "Q001_upper.obj"
    with open(os.path.join(bad, "data.json"), "w") as f:
        json.dump(index, f)
    cwd = os.getcwd()
    for cls in (tdata.TeethSegSemiUDataset, jdata.TeethSegSemiUDataset):
        ds = cls(bad, 64, "train")
        with pytest.raises(FileNotFoundError):
            ds[0]
        os.chdir(bad)
        try:
            assert ds[0]["pos_w"].shape == (64, 3)
        finally:
            os.chdir(cwd)
    assert tdata.TeethSegSemiLDataset(str(tmp_path / "none"), 64).synthetic
