"""ShapeNet multi-view pretraining against ``geot_tpu``: OFF meshes through
``sample_pc`` (``read_off``, ``sample_mesh_poisson`` with its FPS thinning,
the PLY tree), the ``ShapeNet`` / ``ShapeNet55`` items synthetic and from a
PLY + JPG tree the test writes, one small-width ViewGen pretraining step
over ShapeNet batches, the trainer pretraining over ShapeNet, and the
trainer's verdict on ShapeNet named where labels are needed.

Tolerances: meshes, samples, PLY bytes, items and batches bit-equal (the
FPS indices are ``fps_ref``'s against ``geot_tpu``'s FPS on the CPU); the
pretraining step, in float64, within ``tests/test_torch_pretrain.py``'s
bounds: the loss within 1e-6 relative, AdamW's first moment within 1e-5
of each tensor's largest entry and the weights within 1e-6 of the
learning rate.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.core.config import EasyConfig as JEasyConfig
from geot_tpu.data import build as jbuild
from geot_tpu.data import sample_pc as jsample
from geot_tpu.data import shapenetpart as jsp
from geot_tpu.engine.pretrain import make_pretrain_step as jmake_step
from geot_tpu.engine.state import TrainState as JTrainState
from geot_tpu.models import build_model_from_cfg as jmodel_build
from geot_tpu.optim import build_optimizer_from_cfg as joptimizer

from geot_tpu_torch.core.config import EasyConfig
from geot_tpu_torch.data import build as tbuild
from geot_tpu_torch.data import io as tio
from geot_tpu_torch.data import sample_pc as tsample
from geot_tpu_torch.data import shapenetpart as tsp
from geot_tpu_torch.engine import checkpoint as tckpt
from geot_tpu_torch.engine import train as ttrain
from geot_tpu_torch.engine import writer as twriter
from geot_tpu_torch.engine.convert import params_from_jax, state_from_jax
from geot_tpu_torch.engine.pretrain import make_pretrain_step, pretrain_batch
from geot_tpu_torch.engine.state import TrainState
from geot_tpu_torch.optim import build_scheduler_from_cfg

from test_torch_heritage_data import (assert_batches_equal,
                                      assert_items_equal, assert_same_items)
from test_torch_layers_surface import draw_variables
from test_torch_pretrain import GEN_CFG, VIEWGEN, _adam_mu, _j, _np
from test_pretrain import TINY_PRETRAIN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- OFF meshes and sample_pc ------------------------------------------------

CUBE = ("OFF\n8 6 0\n"
        "0 0 0\n1 0 0\n1 1 0\n0 1 0\n0 0 1\n1 0 1\n1 1 1\n0 1 1\n"
        "4 0 1 2 3\n4 4 5 6 7\n4 0 1 5 4\n4 2 3 7 6\n4 1 2 6 5\n"
        "4 0 3 7 4\n")


def _write_meshes(root):
    """3 train, 1 val and 2 test OFF meshes: a cube of quads, the cube in
    the one-line ``OFF n m 0`` form, a random triangle soup and a pentagon
    fan; an unrelated file the walk skips."""
    rng = np.random.default_rng(21)
    soups = []
    for i in range(3):
        v = rng.standard_normal((60, 3)) * (1 + i)
        f = rng.integers(0, 60, (90, 3))
        soups.append("OFF\n60 90 0\n"
                     + "".join(f"{a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in v)
                     + "".join(f"3 {a} {b} {c}\n" for a, b, c in f))
    one_line = "OFF 8 6 0\n" + CUBE.split("\n", 2)[2]
    pent = ("OFF\n6 2 0\n0 0 0\n2 0 0\n3 1 0\n1 2 0\n-1 1 0\n0 0 3\n"
            "5 0 1 2 3 4\n3 0 1 5\n")
    tree = {"train": {"a_cube.off": CUBE, "b_soup.off": soups[0],
                      "c_soup.off": soups[1], "notes.txt": "skip me"},
            "val": {"d_one_line.off": one_line},
            "test": {"e_pent.off": pent, "f_soup.off": soups[2]}}
    for split, files in tree.items():
        os.makedirs(root / split)
        for name, text in files.items():
            (root / split / name).write_text(text)
    return tree


def test_read_off_equals_geot_tpus(tmp_path):
    tree = _write_meshes(tmp_path)
    for split, files in tree.items():
        for name in files:
            if not name.endswith(".off"):
                continue
            got = tsample.read_off(str(tmp_path / split / name))
            want = jsample.read_off(str(tmp_path / split / name))
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    verts, faces = tsample.read_off(str(tmp_path / "val" / "d_one_line.off"))
    assert verts.shape == (8, 3) and faces.shape == (12, 3)
    verts, faces = tsample.read_off(str(tmp_path / "test" / "e_pent.off"))
    np.testing.assert_array_equal(faces, [[0, 1, 2], [0, 2, 3], [0, 3, 4],
                                          [0, 1, 5]])


@pytest.mark.parametrize("num_points", [1024, 2048])
def test_sample_mesh_poisson_equals_geot_tpus(num_points):
    """The dataset's sizes: (1, 4096) -> 1024 and (1, 8192) -> 2048."""
    rng = np.random.default_rng(22)
    verts = rng.standard_normal((300, 3)).astype(np.float32)
    faces = rng.integers(0, 300, (500, 3))
    want = jsample.sample_mesh_poisson(verts, faces, num_points)
    got = tsample.sample_mesh_poisson(verts, faces, num_points,
                                      device="cpu")
    assert got.dtype == want.dtype and got.shape == (num_points, 3)
    np.testing.assert_array_equal(got, want)
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(
        tsample.sample_mesh_poisson(verts, faces, 64, 3, rng_a, "cpu"),
        jsample.sample_mesh_poisson(verts, faces, 64, 3, rng_b))
    assert rng_a.bit_generator.state == rng_b.bit_generator.state


def _tree_bytes(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.fixture(scope="module")
def ply_trees(tmp_path_factory):
    """The same mesh tree sampled to 256 points by each package."""
    trees = {}
    for pkg in ("torch", "jax"):
        root = tmp_path_factory.mktemp(f"meshes_{pkg}")
        _write_meshes(root)
        if pkg == "torch":
            tsample.sample_pc(str(root), 256, device="cpu")
        else:
            jsample.sample_pc(str(root), 256)
        trees[pkg] = root
    return trees


def test_sample_pc_writes_byte_equal_ply_trees(ply_trees):
    got = _tree_bytes(ply_trees["torch"] / "pointclouds")
    want = _tree_bytes(ply_trees["jax"] / "pointclouds")
    assert sorted(got) == sorted(want) == sorted(
        os.path.join(s, n) for s, n in (
            ("train", "a_cube.ply"), ("train", "b_soup.ply"),
            ("train", "c_soup.ply"), ("val", "d_one_line.ply"),
            ("test", "e_pent.ply"), ("test", "f_soup.ply")))
    for name in got:
        assert got[name] == want[name], name
    pts = tio.IO.get(str(ply_trees["torch"] / "pointclouds" / "train"
                         / "a_cube.ply"))
    assert pts.shape == (256, 3) and pts.dtype == np.float32
    assert pts.min() >= 0 and pts.max() <= 1


def test_sample_pc_splits_and_device_rule(tmp_path):
    _write_meshes(tmp_path)
    tsample.sample_pc(str(tmp_path), 32, splits=("test", "none"),
                      device="cpu")
    assert os.listdir(tmp_path / "pointclouds") == ["test"]
    assert len(os.listdir(tmp_path / "pointclouds" / "test")) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsample.sample_pc(str(tmp_path), 32)


# --- the ShapeNet items ------------------------------------------------------

def _write_renders(root, rng):
    """12 JPG renders (``shapenet55v1/<split>/<name>_001.jpg`` ...) of
    every cloud of the PLY tree under ``root``."""
    from PIL import Image

    for split in ("train", "val", "test"):
        src = root / "pointclouds" / split
        dst = root / "shapenet55v1" / split
        os.makedirs(dst)
        for name in sorted(os.listdir(src)):
            for v in range(12):
                img = rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)
                Image.fromarray(img).save(
                    dst / name.replace(".ply", f"_{v + 1:03d}.jpg"))


@pytest.mark.parametrize("kw", [
    {}, {"n_views": 3, "num_points": 300, "img_size": 16},
    {"random_view": True, "n_views": 1, "gravity_dim": 1, "seed": 3}])
@pytest.mark.parametrize("cls_name", ["ShapeNet", "ShapeNet55"])
def test_synthetic_items_equal_geot_tpus(cls_name, kw):
    got, want = getattr(tsp, cls_name)(**kw), getattr(jsp, cls_name)(**kw)
    assert len(got) == len(want) == 64
    assert got.synthetic and want.synthetic
    for epoch in (1, 2):
        got.epoch = want.epoch = epoch
        for i in (0, 1, 17, 63):
            assert_items_equal(got[i], want[i])


@pytest.mark.parametrize("split", ["train", "test"])
def test_tree_items_equal_geot_tpus(ply_trees, split):
    root = ply_trees["torch"]
    if not (root / "shapenet55v1").exists():
        _write_renders(root, np.random.default_rng(23))
    tf = {"train": ["PointsToTensor", "PointCloudScaleAndTranslate"]}
    kw = dict(data_root=str(root), split=split, num_points=256, n_views=2)
    got = tsp.ShapeNet(transform=tbuild.build_transforms_from_cfg(
        "train", tf), **kw)
    from geot_tpu.data.transforms import build_transforms_from_cfg

    want = jsp.ShapeNet(transform=build_transforms_from_cfg("train", tf),
                        **kw)
    assert not got.synthetic
    assert len(got) == (4 if split == "train" else 2)
    assert_same_items(got, want)
    item = got[0]
    assert item["imgs"].shape == (2, 24, 24, 3)
    assert item["x"].shape == (256, 4)


def test_tree_renders_without_pil_raise_naming_the_render(ply_trees,
                                                          monkeypatch):
    root = ply_trees["torch"]
    if not (root / "shapenet55v1").exists():
        _write_renders(root, np.random.default_rng(23))
    ds = tsp.ShapeNet(data_root=str(root), split="test", num_points=256)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=r"shapenet55v1.*\.jpg.*PIL"):
        ds[0]


# --- pretraining over ShapeNet -----------------------------------------------

SHAPENET = {"common": {"NAME": "ShapeNet", "num_points": 128, "n_views": 2,
                       "img_size": 128}}


def test_loaders_give_geot_tpus_batches():
    want = jbuild.build_dataloader_from_cfg(2, SHAPENET, split="train",
                                            seed=4)
    want.set_epoch(1)
    ref = [b for _, b in zip(range(3), want)]
    for w in (1, 3):
        got = tbuild.build_dataloader_from_cfg(
            2, SHAPENET, split="train", seed=4,
            dataloader_cfg={"num_workers": w})
        got.set_epoch(1)
        assert_batches_equal([b for _, b in zip(range(3), got)], ref)


def _shapenet_batch(x64):
    loader = tbuild.build_dataloader_from_cfg(2, SHAPENET, split="train",
                                              seed=0)
    loader.set_epoch(1)
    batch = next(iter(loader))
    dt = np.float64 if x64 else np.float32
    return {k: v.astype(dt) if v.dtype == np.float32 else v
            for k, v in batch.items()}


# tests/test_torch_pretrain.py's small ViewGen with a one-block encoder
STEP_CFG = dict(GEN_CFG, encoder_args=dict(GEN_CFG["encoder_args"], depth=1,
                                           extract_layers=[1]))


@pytest.fixture(scope="module")
def step_init():
    """The JAX model and weights drawn by numpy into its tree (no init
    compile)."""
    jmodel = jmodel_build(STEP_CFG)
    return jmodel, _np(draw_variables(jmodel, _j(_shapenet_batch(False)),
                                      seed=24))


def _run_step(init, x64):
    cfg = EasyConfig()
    cfg.load(VIEWGEN, recursive=True)
    cfg.model = EasyConfig(STEP_CFG)
    dt = np.float64 if x64 else np.float32
    batch = _shapenet_batch(x64)
    jmodel, variables = init
    cast = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, dt)),
                                  variables)
    tx = joptimizer(None, lr=cfg.lr, **cfg.optimizer)
    before = _np(cast)
    jstate = JTrainState.create(cast, tx)
    lr = build_scheduler_from_cfg(dict(cfg, warmup_epochs=0))(1)
    jnew, jm = jmake_step(jmodel, tx, dict(cfg))(jstate, _j(batch),
                                                 jnp.asarray(lr, dt))
    state = TrainState.create(cfg, cfg.model, device="cpu")
    if x64:
        state.model.double()
    state.load(state_from_jax(before))
    tm = make_pretrain_step(cfg)(state, pretrain_batch(batch, "cpu"), lr)
    return _np(jnew), float(jm["loss"]), state, float(tm["loss"]), lr


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def test_pretrain_step_over_shapenet_float64(step_init):
    jax.config.update("jax_enable_x64", True)
    try:
        jnew, jloss, state, loss, lr = _run_step(step_init, True)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert np.isfinite(loss) and state.step == 1
    assert _rel(loss, jloss) <= 1e-6
    mu = params_from_jax({"params": _adam_mu(jnew.opt_state),
                          "batch_stats": {}})
    after = params_from_jax({"params": jnew.params,
                             "batch_stats": jnew.batch_stats})
    named = dict(state.model.named_parameters())
    assert set(mu) == set(named)
    gmax = max(float(v.abs().max()) for v in mu.values())
    for k, p in named.items():
        got = state.opt.state[p]["exp_avg"].double().numpy()
        ref = mu[k].double().numpy()
        scale = max(np.abs(ref).max(), 1e-6 * gmax)
        assert np.abs(got - ref).max() / scale <= 1e-5, k
        live = np.abs(ref) > 1e-9 * gmax
        dw = np.abs(p.detach().double().numpy() - after[k].double().numpy())
        assert (dw[live] <= 1e-6 * lr).all(), (k, dw[live].max())


def test_trainer_pretrains_over_shapenet(tmp_path, monkeypatch):
    """``parse_and_run`` on ``viewgen.yaml`` at the small width with the
    dataset named ShapeNet: one epoch, validation, checkpoints (the
    scalars file without TensorBoard's event files, whose import takes
    seconds here)."""
    monkeypatch.setattr(twriter, "_make_tb", lambda log_dir: None)
    res = ttrain.parse_and_run([
        "--cfg", VIEWGEN, *TINY_PRETRAIN, "dataset.common.NAME=ShapeNet",
        "dataset.common.num_points=128", "num_points=128", "epochs=1",
        "val_freq=1", "batch_size=8", "batch_size_val=16",
        f"root_dir={tmp_path}", "device=cpu"])
    assert np.isfinite(res["val_loss"]) and res["best"]["epoch"] == 1, res
    (run,) = [os.path.join(d, "checkpoint") for d, sub, _ in os.walk(tmp_path)
              if "checkpoint" in sub]
    name = os.path.basename(os.path.dirname(run))
    for tag in ("latest", "best"):
        assert os.path.exists(tckpt.ckpt_path(run, name, tag)), tag


# --- the verdict where labels are needed ------------------------------------

def _cfg(pkg, path, opts):
    cfg = (JEasyConfig if pkg == "jax" else EasyConfig)()
    cfg.load(os.path.join(ROOT, "cfgs", path), recursive=True)
    cfg.update(list(opts) + ["seed=0"])
    return cfg


@pytest.mark.parametrize("kind,path,key", [
    ("cls", "scanobjectnn/pointnet2cls.yaml", "dataset.common.NAME"),
    ("partseg", "shapenetpart/pointnet2part.yaml", "dataset.common.NAME"),
    ("sup", "tooth_sup/pointnet2.yaml", "dataset_l.common.NAME")])
def test_shapenet_where_labels_are_needed_gets_geot_tpus_verdict(kind, path,
                                                                 key):
    """``geot_tpu``'s trainer path on a ShapeNet batch fails (its step
    reads labels the items do not carry); the port refuses the config by
    the dataset's key before a run starts."""
    from test_torch_registry_rest_gate import geot_tpu_trains, port_trains
    from test_supervised_zoo import TINY

    opts = {"cls": ["model.encoder_args.width=8",
                    "model.encoder_args.num_samples=8",
                    "model.encoder_args.strides=[4,4]",
                    "model.encoder_args.blocks=[1,1]",
                    "model.cls_args.mlps=[32]"],
            "partseg": ["model.encoder_args.width=8",
                        "model.encoder_args.num_samples=8",
                        "model.encoder_args.strides=[4,4]",
                        "model.encoder_args.blocks=[1,1]"],
            "sup": TINY["pointnet2.yaml"]}[kind]
    opts = opts + [f"{key}=ShapeNet", key.replace("NAME", "num_points")
                   + "=128"]
    jcfg, tcfg = _cfg("jax", path, opts), _cfg("torch", path, opts)
    ds = jcfg.get(key.split(".")[0])
    loader = jbuild.build_dataloader_from_cfg(4, ds, split="train", seed=0)
    batch = next(iter(loader))
    assert "y" not in batch
    assert geot_tpu_trains("sup" if kind == "cls" else kind, jcfg,
                           batch) is False
    assert port_trains(kind, tcfg) is False
    with pytest.raises(NotImplementedError, match=f"no labels.*{key}"):
        ttrain.refuse_unported(tcfg)
    # pretraining over it passes the gate
    pre = EasyConfig()
    pre.load(VIEWGEN, recursive=True)
    pre.update(["dataset.common.NAME=ShapeNet"])
    ttrain.refuse_unported(pre)
