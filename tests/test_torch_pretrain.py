"""GeoT's pretraining stage in the port against ``geot_tpu``: the
scheduler family, the PNG reader, the multi-view datasets, every module of
the generation stack, the four generation encoders, one pretraining step,
the encoder graft into the flagship, and the trainer on
``cfgs/tooth_pretrain/viewgen.yaml`` cut to ``tests/test_pretrain.py``'s
``TINY_PRETRAIN``.

Inputs are seeded numpy arrays or the synthetic datasets (bit-equal in
both packages); weights go across through ``params_from_jax``. At 128 to
256 points every JAX neighbour search is exact ``lax.top_k``, as the
port's always is. Stochastic depth is off where the two frameworks would
draw different masks.
"""
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from PIL import Image

from geot_tpu.core.config import EasyConfig as JEasyConfig
from geot_tpu.data import build as jdata_build
from geot_tpu.data.tooth_pretrain import _load_render
from geot_tpu.engine import checkpoint as jckpt
from geot_tpu.engine.pretrain import make_pretrain_step as jmake_step
from geot_tpu.engine.state import TrainState as JTrainState
from geot_tpu.models import build_model_from_cfg as jbuild
from geot_tpu.models.generation import view_gen as jview_gen
from geot_tpu.optim import build_optimizer_from_cfg as joptimizer
from geot_tpu.optim import build_scheduler_from_cfg as jscheduler

from geot_tpu_torch.core.config import EasyConfig, build_model_from_cfg
from geot_tpu_torch.data import build as tdata_build
from geot_tpu_torch.data.png import read_png, read_png_rgb
from geot_tpu_torch.engine import checkpoint as tckpt
from geot_tpu_torch.engine import train as ttrain
from geot_tpu_torch.engine.convert import params_from_jax, state_from_jax
from geot_tpu_torch.engine.pretrain import make_pretrain_step, pretrain_batch
from geot_tpu_torch.engine.state import TrainState
from geot_tpu_torch.models.generation import view_gen as tview_gen
from geot_tpu_torch.optim import build_scheduler_from_cfg

from test_pretrain import TINY_PRETRAIN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIEWGEN = os.path.join(ROOT, "cfgs", "tooth_pretrain", "viewgen.yaml")
SMOKE = os.path.join(ROOT, "cfgs", "tooth_semi", "smoke.yaml")
# tests/test_generation.py's size: trans_dim 48, depth 2, 128 points,
# 64 px input grid at ratio 16 -> 128 x 128 renders
GEN_CFG = {
    "NAME": "ViewGenBase",
    "encoder_args": {
        "NAME": "PointTransformer_genencoder", "trans_dim": 48, "depth": 2,
        "num_heads": 4, "group_size": 8, "num_group": 32, "encoder_dims": 32,
        "extract_layers": [1, 2], "drop_path_rate": 0.0},
    "generator_args": {
        "NAME": "ViewTransformer", "in_channels": 48, "feat_channels": 48,
        "depth": 1, "channels_per_head": 16, "drop_rate": 0.0,
        "obj_size": 56, "img_size": 64, "img_ds_ratio": 16},
    "decoder_args": {"NAME": "ViewDecoder", "in_channels": 48,
                     "out_channels": 3},
    "loss_args": {"weight_fg": 1.0, "weight_bg": 0.1},
}
B, N, V, OUT = 2, 128, 2, 128


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads: the tier-1 run puts several test processes on
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jinit(model, *args, method=None):
    """``model.init`` under ``jit`` (one compile, where eager init compiles
    every operation on its own), as numpy."""
    key = jax.random.PRNGKey(0)
    init = jax.jit(lambda *a: model.init(
        {"params": key, "dropout": jax.random.fold_in(key, 1)}, *a,
        method=method))
    return _np(init(*args))


def _japply(model, variables, *args, **kwargs):
    return jax.jit(lambda v, *a: model.apply(v, *a, **kwargs))(variables,
                                                                *args)


def _port(cfg, variables):
    """The port's model of ``cfg`` with ``geot_tpu``'s ``variables``, in
    eval mode."""
    model = build_model_from_cfg(cfg)
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model.eval()


def _batch(seed=0, weight=False):
    """A numpy batch of ``B`` clouds of ``N`` points, ``V`` random views
    each and renders with a white background."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi, np.pi, (B * V, 3))
    views = np.stack([_rot(a) for a in ang]).reshape(B, V, 3, 3)
    imgs = rng.uniform(0, 1, (B, V, OUT, OUT, 3)).astype(np.float32)
    imgs[:, :, :OUT // 3] = 1.0                     # background rows
    out = {"pos": rng.standard_normal((B, N, 3)).astype(np.float32),
           "views": views.astype(np.float32), "imgs": imgs}
    out["x"] = out["pos"]
    if weight:
        out["weight"] = rng.uniform(0.1, 1, (B, V, OUT, OUT)).astype(
            np.float32)
    return out


def _rot(a):
    cx, cy, cz = np.cos(a)
    sx, sy, sz = np.sin(a)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --- schedules ---------------------------------------------------------------

SCHEDS = ("multistep", "step", "cosine", "tanh", "poly", "plateau", "none")


@pytest.mark.parametrize("sched", SCHEDS)
def test_every_schedule_matches_geot_tpu(sched):
    """Each ``sched`` with warmup 0 and 5, with and without ``min_lr``,
    ``decay_rate`` and ``t_max``, at epochs 1 .. epochs + 2: the same
    Python floats as ``geot_tpu``'s."""
    seen = 0
    for warmup in (0, 5):
        for extra in ({}, {"min_lr": 1e-6, "decay_rate": 0.5, "t_max": 7,
                           "decay_epochs": [3, 8], "warmup_lr": 2e-5}):
            cfg = {"sched": sched, "lr": 5e-4, "epochs": 12,
                   "warmup_epochs": warmup, **extra}
            if sched == "step" and "decay_epochs" in extra:
                cfg["decay_epochs"] = 4
            got, want = build_scheduler_from_cfg(cfg), jscheduler(dict(cfg))
            for epoch in range(1, cfg["epochs"] + 3):
                assert got(epoch) == want(epoch), (cfg, epoch)
                seen += 1
    assert seen == 4 * 14


def test_plateau_follows_a_fed_metric_like_geot_tpu():
    """``plateau`` over a metric sequence (warmup 3, patience 2, cooldown
    1, both modes): each epoch's lr and the schedule's state equal
    ``geot_tpu``'s."""
    rng = np.random.default_rng(4)
    metrics = np.concatenate([np.linspace(0.1, 0.5, 5), np.full(9, 0.5),
                              rng.uniform(0.3, 0.6, 12), [0.0, -0.2, -0.1]])
    for mode in ("max", "min"):
        cfg = {"sched": "plateau", "lr": 1e-3, "epochs": 40,
               "warmup_epochs": 3, "patience_epochs": 2,
               "cooldown_epochs": 1, "decay_rate": 0.5, "plateau_mode": mode}
        got, want = build_scheduler_from_cfg(cfg), jscheduler(dict(cfg))
        lrs = []
        for epoch, m in enumerate(metrics, 1):
            assert got(epoch) == want(epoch), (mode, epoch)
            lrs.append(got(epoch))
            got.note_metric(m)
            want.note_metric(m)
            assert got.state_dict() == want.state_dict(), (mode, epoch)
        assert len(set(lrs)) > 3, lrs
        again = build_scheduler_from_cfg(cfg)
        again.load_state_dict(got.state_dict())
        assert again(len(metrics) + 1) == want(len(metrics) + 1)


# --- the PNG reader ----------------------------------------------------------

def _png_bytes(arr, ctype, depth=8, filt=0, interlace=0, palette=None):
    """A PNG of ``arr`` (H, W, samples) uint8 with every row under filter
    ``filt`` (PNG section 9), written here so that each filter is read."""
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1).astype(np.int32)
    bpp = max(1, arr.shape[2] * depth // 8)
    raw = bytearray()
    prev = np.zeros(rows.shape[1], np.int32)
    for r in rows:
        left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if filt == 0:
            f = r
        elif filt == 1:
            f = r - left
        elif filt == 2:
            f = r - prev
        elif filt == 3:
            f = r - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            f = r - np.where((pa <= pb) & (pa <= pc), left,
                             np.where(pb <= pc, prev, upleft))
        raw += bytes([filt]) + bytes((f & 0xFF).astype(np.uint8))
        prev = r

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", bytes(palette))
    return out + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND",
                                                                   b"")


@pytest.mark.parametrize("mode", ("L", "RGB", "RGBA", "P"))
def test_png_reader_equals_load_render(mode, tmp_path):
    """Grey, RGB, RGBA and palette PNGs that PIL writes, of several sizes
    (1-pixel-wide and 1-pixel-high included; PIL picks the palette's bit
    depth and the rows' filters), decode bit-equal to ``geot_tpu``'s
    ``_load_render`` (PIL)."""
    rng = np.random.default_rng(1)
    for h, w in ((1, 1), (1, 9), (7, 1), (13, 17), (64, 48)):
        for colours in (2, 5, 200):
            if mode == "P":
                im = Image.fromarray(rng.integers(0, colours, (h, w))
                                     .astype(np.uint8), "P")
                im.putpalette(rng.integers(0, 256, 3 * colours).tolist())
            elif mode == "L":
                im = Image.fromarray(rng.integers(0, 256, (h, w))
                                     .astype(np.uint8), "L")
            else:
                im = Image.fromarray(rng.integers(0, 256, (h, w, len(mode)))
                                     .astype(np.uint8), mode)
            path = str(tmp_path / f"{mode}_{h}_{w}_{colours}.png")
            im.save(path, optimize=colours == 5)
            got, want = read_png_rgb(path), _load_render(path)
            assert got.dtype == want.dtype == np.float32
            assert got.shape == want.shape == (h, w, 3)
            assert np.array_equal(got, want), path


def test_png_filters_depths_and_refusals(tmp_path):
    """Every row filter at each sample layout, grey and palette at 1, 2 and
    4 bits, grey+alpha; each bit-equal to PIL's reading. A 16-bit and an
    interlaced PNG raise ``ValueError`` naming the colour type and bit
    depth."""
    rng = np.random.default_rng(2)
    cases = []
    for ctype, samples in ((0, 1), (2, 3), (4, 2), (6, 4)):
        for filt in range(5):
            cases.append((rng.integers(0, 256, (6, 5, samples))
                          .astype(np.uint8), ctype, 8, filt, None))
    for depth in (1, 2, 4):
        for ctype in (0, 3):
            idx = rng.integers(0, 1 << depth, (5, 11, 1)).astype(np.uint8)
            packed = np.packbits(np.unpackbits(idx, axis=2)[..., 8 - depth:]
                                 .reshape(5, -1), axis=1)[..., None]
            pal = (rng.integers(0, 256, 3 << depth).tolist() if ctype == 3
                   else None)
            for filt in (0, 4):
                cases.append((packed, ctype, depth, filt, pal, 11))
    for n, case in enumerate(cases):
        arr, ctype, depth, filt, pal = case[:5]
        data = _png_bytes(arr, ctype, depth, filt, palette=pal)
        if len(case) == 6:     # sub-byte: the IHDR width is the pixels'
            data = data[:16] + struct.pack(">I", case[5]) + data[20:]
            body = data[12:29]
            data = data[:29] + struct.pack(">I", zlib.crc32(body)) + \
                data[33:]
        path = str(tmp_path / f"c{n}.png")
        with open(path, "wb") as f:
            f.write(data)
        want = np.asarray(Image.open(path).convert("RGB"))
        assert np.array_equal(read_png(path), want), (ctype, depth, filt)
    for arr, ctype, depth, interlace, msg in (
            (np.zeros((2, 4, 2), np.uint8), 0, 16, 0, "type 0 .grey. at "
             "bit depth 16"),
            (np.zeros((2, 2, 3), np.uint8), 2, 8, 1, "type 2 .RGB. at bit "
             "depth 8, interlaced")):
        path = str(tmp_path / f"bad{ctype}.png")
        with open(path, "wb") as f:
            f.write(_png_bytes(arr, ctype, depth, interlace=interlace))
        with pytest.raises(ValueError, match=msg):
            read_png(path)
    Image.fromarray(rng.integers(0, 65535, (3, 4)).astype(np.uint16)).save(
        str(tmp_path / "pil16.png"))
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png(str(tmp_path / "pil16.png"))


# --- the datasets ------------------------------------------------------------

def _write_tree(root, rng):
    """A pretraining manifest tree: 5 OBJ clouds in ``case<id>``
    directories (one of them filtered out), renders per view in grey, RGB
    and palette PNGs, and the manifests of both datasets for ``train``
    and ``val``."""
    from geot_tpu_torch.data.tooth_semi import _synthetic_scan

    pcs, rgbs = [], []
    for i in range(5):
        case = os.path.join(root, f"case{i:04d}")
        os.makedirs(case)
        name = f"case{i:04d}_{'lower' if i % 2 == 0 else 'upper'}"
        pts = _synthetic_scan(700 + i, 3000)[0]
        with open(os.path.join(case, name + ".obj"), "w") as f:
            f.writelines(f"v {x!r} {y!r} {z!r}\n"
                         for x, y, z in pts.astype(np.float64).tolist())
        rdir = os.path.join(case, "render")
        os.makedirs(rdir)
        for v in range(12):
            a = rng.integers(0, 256, (24, 24, 3)).astype(np.uint8)
            a[:8] = 255
            im = Image.fromarray(a)
            im = (im.convert("L") if v % 3 == 1 else
                  im.convert("P", palette=Image.Palette.ADAPTIVE)
                  if v % 3 == 2 else im)
            im.save(os.path.join(rdir, f"{name}_{v}.png"))
        pcs.append(os.path.join(case, name + ".obj"))
        rgbs.append(rdir)
    for split in ("train", "val"):
        for suffix in ("_pca_0.5.json", "_pca_cur_0.5.json"):
            with open(os.path.join(root, split + suffix), "w") as f:
                json.dump({"pc_data": pcs, "rgb_data": rgbs,
                           "filter_upper": [3], "filter_lower": [42]}, f)


@pytest.mark.parametrize("name", ("tooth_6000", "tooth_6000_pca"))
def test_dataset_items_equal_geot_tpu(name, tmp_path):
    """Items of both datasets, synthetic and from a manifest tree, for
    several (epoch, idx), with ``random_view`` too: bit-equal to
    ``geot_tpu``'s."""
    _write_tree(str(tmp_path), np.random.default_rng(3))
    for root, opts in (("", {}), ("", {"n_views": 1, "random_view": True}),
                       (str(tmp_path), {}), (str(tmp_path), {"n_views": 3})):
        cfg = {"common": {"NAME": name, "data_root": root, "num_points": 512,
                          "n_views": 2, "img_size": 24, **opts}}
        for split in ("train", "val"):
            got = tdata_build.build_dataloader_from_cfg(
                2, cfg, None, split=split, seed=5).dataset
            want = jdata_build.build_dataloader_from_cfg(
                2, cfg, None, None, split=split, seed=5).dataset
            assert len(got) == len(want) == (16 if not root else 4)
            assert got.synthetic == want.synthetic == (not root)
            for epoch, idx in ((0, 0), (1, 3), (7, 1)):
                got.epoch = want.epoch = epoch
                a, b = got[idx], want[idx]
                assert sorted(a) == sorted(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype, (k, root, opts)
                    assert np.array_equal(a[k], b[k]), (k, root, opts,
                                                        epoch, idx)


# --- the generation stack ----------------------------------------------------

@pytest.mark.parametrize("kernel,stride", ((5, 4), (3, 2), (3, 4)))
def test_conv_transpose_is_flax_conv_transpose(kernel, stride):
    """Flax ``ConvTranspose(padding="SAME")`` with its own HWIO kernel:
    the port's dilate, pad and unflipped ``conv2d`` gives the same image,
    of the input's size times the stride."""
    import flax.linen as nn

    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.standard_normal((2, 4, 5, 6)).astype(np.float32)
    layer = nn.ConvTranspose(7, (kernel, kernel), strides=(stride, stride))
    variables = _jinit(layer, jnp.asarray(x))
    variables["params"]["bias"] = rng.standard_normal(7).astype(np.float32)
    want = np.asarray(_japply(layer, variables, jnp.asarray(x)))
    port = tview_gen.ConvTranspose(6, 7, kernel, stride)
    port.load_state_dict({"weight": torch.from_numpy(
        variables["params"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "bias": torch.from_numpy(variables["params"]["bias"])})
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4 * stride, 5 * stride, 7)
    assert _rel(got, want) <= 1e-5


def test_bilinear_upsample_is_jax_image_resize():
    """``jax.image.resize(..., "bilinear")`` to twice the size is
    ``F.interpolate(align_corners=False)``, borders included."""
    x = np.random.default_rng(6).standard_normal((2, 5, 3, 4)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 6, 4),
                                       "bilinear"))
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for edge in (got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert np.abs(edge).max() > 0


@pytest.mark.parametrize("name", ("ViewDecoder", "ViewDecoder_big",
                                  "ViewDecoder_ds"))
def test_decoders_match_geot_tpu(name):
    """Each decoder on a random feature grid, eval mode (and train mode for
    the BatchNorm one: its output and updated statistics), relative
    1e-5."""
    x = np.random.default_rng(7).standard_normal((3, 4, 4, 48)).astype(
        np.float32)
    cfg = {"NAME": name, "in_channels": 48, "out_channels": 3}
    jmodel = jbuild(cfg)
    variables = _jinit(jmodel, jnp.asarray(x))
    model = _port(cfg, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want = _japply(jmodel, variables, jnp.asarray(x))
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= 1e-5
    if name == "ViewDecoder_big":
        model.train()
        with torch.no_grad():
            g = model(torch.from_numpy(x))
        w, mutated = _japply(jmodel, variables, jnp.asarray(x),
                             training=True, mutable=["batch_stats"])
        assert _rel(g.numpy(), w) <= 1e-5
        stats = params_from_jax({"params": variables["params"],
                                 "batch_stats": _np(mutated["batch_stats"])})
        sd = model.state_dict()
        for k, v in stats.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)


def _jax_queries(gen, pos, views):
    """``geot_tpu``'s query build (``view_gen.py:154-172``), step by step
    in JAX."""
    mesh, qpos = gen._meshgrid()
    scale, bias, flat_view = gen._scale_bias(pos, views)
    inv = jnp.linalg.inv(flat_view)
    grid_world = scale[:, None] * mesh[None] + bias[:, None]
    point_grid = jnp.einsum("bcd,bnd->bnc", inv[:, :, :2], grid_world)
    P = point_grid.shape[1]
    direction = flat_view[:, :, 2]
    direction = direction / (jnp.linalg.norm(direction, axis=-1,
                                             keepdims=True) + 1e-12)
    return (scale, bias, jnp.concatenate([
        point_grid, jnp.broadcast_to(direction[:, None], (len(inv), P, 3)),
        jnp.broadcast_to(qpos[None], (len(inv), P, 2))], axis=-1))


def test_view_transformer_and_its_query_grid_match_geot_tpu():
    """The query grid (scale, bias and the queries: ``inv`` and the
    ``floor``s sit on rounding edges) and the generator's output, relative
    1e-5, for random views and for the identity."""
    gen_cfg = dict(GEN_CFG["generator_args"], depth=2)
    jgen = jbuild(gen_cfg)
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((B, 32, 48)).astype(np.float32)
    centers = rng.standard_normal((B, 32, 3)).astype(np.float32)
    pos = _batch(9)["pos"]
    variables = _jinit(jgen, *(jnp.asarray(a) for a in (
        feats, centers, pos, _batch(9)["views"])))
    gen = _port(gen_cfg, variables)
    apply = jax.jit(jgen.apply)
    for views in (_batch(9)["views"],
                  np.broadcast_to(np.eye(3, dtype=np.float32), (B, V, 3, 3))):
        args = [jnp.asarray(a) for a in (feats, centers, pos, views)]
        tpos, tviews = torch.from_numpy(pos), torch.from_numpy(
            np.ascontiguousarray(views))
        scale, bias, want_q = _jax_queries(jgen, *args[2:])
        t_scale, t_bias, _ = gen._scale_bias(tpos, tviews)
        assert _rel(t_scale.numpy(), scale) <= 1e-6
        assert _rel(t_bias.numpy(), bias) <= 1e-6
        assert _rel(gen.queries(tpos, tviews).numpy(), want_q) <= 1e-5
        with torch.no_grad():
            got = gen(*(torch.from_numpy(np.ascontiguousarray(a)) for a in
                        (feats, centers, pos, views)))
        want = apply(variables, *args)
        assert got.shape == want.shape == (B * V, 4, 4, 48)
        assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("weight", (False, True))
def test_viewgen_loss_and_recon_match_geot_tpu(weight):
    """``ViewGenBase`` at ``tests/test_generation.py``'s size, with and
    without ``weight``: loss relative 1e-5, recon absolute 1e-5; the
    gradient reaches the generator."""
    batch = _batch(10, weight)
    jmodel = jbuild(GEN_CFG)
    variables = _jinit(jmodel, _j(batch))
    model = _port(GEN_CFG, variables)
    loss, recon = model(_t(batch))
    jloss, jrecon = _japply(jmodel, variables, _j(batch))
    assert recon.shape == (B * V, OUT, OUT, 3)
    assert _rel(float(loss.detach()), float(jloss)) <= 1e-5
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(jrecon),
                               rtol=0, atol=1e-5)
    loss.backward()
    assert float(model.generator.query_mlp_fc1.weight.grad.abs().sum()) > 0


GEN_ENCODERS = {
    "PointTransformer_genencoder": dict(GEN_CFG["encoder_args"]),
    "PointNet2GenEncoder": {"in_channels": 3, "width": 16,
                            "strides": [4, 4], "blocks": [1, 1],
                            "num_samples": 16, "radius": 0.3,
                            "aggr_args": {"feature_type": "dp_fj",
                                          "reduction": "max"}},
    "DGCNNGenEncoder": {"in_channels": 3, "channels": 16, "embed_dim": 32,
                        "n_blocks": 4, "k": 8},
    "PointMLPGenEncoder": {"in_channels": 3, "embed_dim": 16,
                           "k_neighbors": [8, 8], "reducers": [2, 2],
                           "dim_expansion": [2, 2], "pre_blocks": [1, 1],
                           "pos_blocks": [1, 1]},
}


@pytest.mark.parametrize("name", sorted(GEN_ENCODERS))
def test_generation_encoders_match_geot_tpu(name):
    """The four encoders' ``forward_cls_feat`` (features, points) on the
    same clouds, eval mode, relative 1e-5."""
    cfg = dict(GEN_ENCODERS[name], NAME=name)
    cfg.pop("drop_path_rate", None)
    pos = _batch(11)["pos"]
    jmodel = jbuild(cfg)
    jpos = jnp.asarray(pos)
    variables = _jinit(jmodel, jpos, method=jmodel.forward_cls_feat)
    model = _port(cfg, variables)
    want = _japply(jmodel, variables, jpos, method=jmodel.forward_cls_feat)
    with torch.no_grad():
        got = model.forward_cls_feat(torch.from_numpy(pos))
        as_dict = model.forward_cls_feat({"pos": torch.from_numpy(pos)})
    for g, d, w in zip(got, as_dict, want):
        assert g.shape == w.shape
        assert torch.equal(g, d)
        assert _rel(g.numpy(), w) <= 1e-5, name


# --- one pretraining step ----------------------------------------------------

def _step_cfg():
    cfg = EasyConfig()
    cfg.load(VIEWGEN, recursive=True)
    cfg.model = EasyConfig(GEN_CFG)
    return cfg


@pytest.fixture(scope="module")
def step_init():
    """The JAX model and its float32 initial weights, for both dtypes."""
    jmodel = jbuild(GEN_CFG)
    return jmodel, _jinit(jmodel, _j(_batch(12, weight=True)))


def _run_step(init, x64):
    """One pretraining step from the same weights in both packages
    (``weight`` maps on): (JAX state after, JAX loss, port state, port
    loss, lr)."""
    cfg = _step_cfg()
    dt = np.float64 if x64 else np.float32
    batch = {k: v.astype(dt) if v.dtype == np.float32 else v
             for k, v in _batch(12, weight=True).items()}
    jmodel, variables = init
    cast = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, dt)),
                                  variables)
    tx = joptimizer(None, lr=cfg.lr, **cfg.optimizer)
    before = _np(cast)              # the step donates the JAX state
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


@pytest.fixture(scope="module")
def one_step(step_init):
    return _run_step(step_init, False)


@pytest.fixture(scope="module")
def one_step_x64(step_init):
    jax.config.update("jax_enable_x64", True)
    try:
        return _run_step(step_init, True)
    finally:
        jax.config.update("jax_enable_x64", False)


def _adam_mu(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return _np(found[0].mu)


def test_pretrain_step_loss_and_statistics_match_geot_tpu(one_step):
    """float32: the loss relative 1e-5, the updated BatchNorm statistics
    within 1e-6, ``step`` 1."""
    jnew, jloss, state, loss, _ = one_step
    assert np.isfinite(loss)
    assert _rel(loss, jloss) <= 1e-5
    want = params_from_jax({"params": jnew.params,
                            "batch_stats": jnew.batch_stats})
    sd = state.model.state_dict()
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)
    assert state.step == 1


def test_pretrain_step_gradients_and_weights_match_geot_tpu(one_step_x64):
    """float64 (the batch-statistics BatchNorm makes float32 gradients
    differ from either package's float64 ones by more than the two
    packages differ from each other): AdamW's first moment (0.1 x the
    clipped gradient) tensor by tensor within 1e-5 of the tensor's largest
    entry, and the weights after AdamW within 1e-6 of the learning rate,
    but for entries whose gradient is zero up to rounding (a bias before
    BatchNorm), where the first Adam step's sign is rounding's."""
    jnew, jloss, state, loss, lr = one_step_x64
    assert _rel(loss, jloss) <= 1e-6
    mu = params_from_jax({"params": _adam_mu(jnew.opt_state),
                          "batch_stats": {}})
    after = params_from_jax({"params": jnew.params,
                             "batch_stats": jnew.batch_stats})
    named = dict(state.model.named_parameters())
    assert set(mu) == set(named)
    gmax = max(float(v.abs().max()) for v in mu.values())
    worst = 0.0
    for k, p in named.items():
        got = state.opt.state[p]["exp_avg"].double().numpy()
        ref = mu[k].double().numpy()
        scale = max(np.abs(ref).max(), 1e-6 * gmax)
        err = np.abs(got - ref).max() / scale
        worst = max(worst, err)
        assert err <= 1e-5, (k, err)
        live = np.abs(ref) > 1e-9 * gmax
        dw = np.abs(p.detach().double().numpy() - after[k].double().numpy())
        assert (dw[live] <= 1e-6 * lr).all(), (k, dw[live].max())
        assert (dw <= 2 * lr * 1.0001).all(), k
    print(f"float64: worst per-tensor gradient error / max|g|: {worst:.3e}")


# --- the graft ---------------------------------------------------------------

def _smoke_seg(pkg):
    cfg = (JEasyConfig if pkg == "jax" else EasyConfig)()
    cfg.load(SMOKE, recursive=True)
    return cfg


def test_load_pretrain_encoder_matches_geot_tpus_graft(tmp_path):
    """A ``geot_tpu`` pretraining state at the smoke trunk's size, saved as
    ``geot_tpu``'s checkpoint and, converted, as the port's: grafted into
    the smoke ``WholePartSeg`` by both packages, the same entries take the
    checkpoint's values, nothing is skipped and the rest keeps its fresh
    values; from the run directory too. The same state with a trunk entry
    of another shape and one the model lacks: both packages skip those
    two and graft the rest. A model with neither a ``segmentor`` nor an
    ``encoder`` and a checkpoint without an encoder raise; a missing path
    and ``geot_tpu``'s own checkpoint directory are refused."""
    seg = _smoke_seg("torch")
    sargs = seg.model.segmentor_args
    enc = {k: sargs[k] for k in ("trans_dim", "depth", "num_heads",
                                 "group_size", "num_group", "encoder_dims")}
    gcfg = dict(GEN_CFG, encoder_args=dict(GEN_CFG["encoder_args"], **enc,
                                           extract_layers=[1, 2, 3]),
                generator_args=dict(GEN_CFG["generator_args"],
                                    in_channels=enc["trans_dim"]))
    batch = _batch(13)
    pre = _jinit(jbuild(gcfg), _j(batch))
    bent = jax.tree_util.tree_map(np.copy, pre)
    bent["params"]["encoder"]["norm"]["scale"] = np.ones(7, np.float32)
    bent["params"]["encoder"]["extra"] = {"kernel": np.ones((2, 3),
                                                            np.float32)}
    jseg = jbuild(_smoke_seg("jax").model)
    pos = jnp.asarray(batch["pos"])
    fresh = _jinit(jseg, {"pos": pos, "x": pos,
                          "cls": jnp.zeros((B, 1), jnp.int32)})
    model = build_model_from_cfg(seg.model)
    model.load_state_dict(params_from_jax(fresh), strict=True)
    fresh_sd = {k: v.clone() for k, v in model.state_dict().items()}
    tx = joptimizer(None, lr=1e-3, NAME="adamw", weight_decay=0.05)
    for tag, variables, n_skip in (("same", pre, 0), ("bent", bent, 2)):
        jpath = jckpt.save_checkpoint(
            JEasyConfig(ckpt_dir=str(tmp_path / f"j_{tag}"), run_name="pt"),
            JTrainState.create(jax.tree_util.tree_map(jnp.asarray,
                                                      variables), tx), 1)
        want, jskipped = jckpt.load_pretrain_encoder(fresh, jpath)
        want = params_from_jax(want)
        run = tmp_path / f"run_{tag}"
        os.makedirs(run / "checkpoint")
        tpath = str(run / "checkpoint" / "pt_ckpt_best.pth")
        torch.save({"state": {"model": params_from_jax(variables)},
                    "epoch": 1, "extra": {}}, tpath)
        for source in (tpath, str(run)):
            got, skipped = tckpt.load_pretrain_encoder(fresh_sd, source)
            assert len(skipped) == len(jskipped) == n_skip, (skipped,
                                                             jskipped)
            assert set(got) == set(want)
            for k, v in got.items():
                assert torch.equal(v, want[k]), k
        trunk = {k[len("encoder."):]: v for k, v in
                 params_from_jax(variables).items()
                 if k.startswith("encoder.")}
        for k, v in got.items():
            inner = k[len("segmentor."):]
            if inner in trunk and tuple(trunk[inner].shape) == tuple(
                    v.shape):
                assert torch.equal(v, trunk[inner]), k
            else:
                assert torch.equal(v, fresh_sd[k]), k
        if tag == "bent":
            assert sorted(skipped) == [
                "segmentor.extra.weight (unexpected)",
                "segmentor.norm.weight (shape (7,) vs (48,))"]
    with pytest.raises(ValueError, match="neither"):
        tckpt.load_pretrain_encoder({"head.weight": torch.zeros(1)}, tpath)
    torch.save({"state": {"model": {"decoder.w": torch.zeros(1)}}},
               str(tmp_path / "noenc.pth"))
    with pytest.raises(ValueError, match="no 'encoder'"):
        tckpt.load_pretrain_encoder(fresh_sd, str(tmp_path / "noenc.pth"))
    with pytest.raises(FileNotFoundError):
        tckpt.load_pretrain_encoder(fresh_sd, str(tmp_path / "gone"))
    with pytest.raises(ValueError, match="reads its own"):
        tckpt.load_pretrain_encoder(fresh_sd, jpath)


# --- the trainer ---------------------------------------------------------------

def _run_dir(root):
    (d,) = os.listdir(os.path.join(root, "tooth_pretrain"))
    return os.path.join(root, "tooth_pretrain", d)


def test_trainer_pretrains_resumes_and_grafts(tmp_path):
    """``parse_and_run`` on ``viewgen.yaml`` cut to ``TINY_PRETRAIN`` on the
    CPU: each epoch's lr is the warmup's, the losses finite, ``latest``,
    ``best`` and ``E1`` written; ``mode=resume`` from ``E1`` continues at
    epoch 2 with the saved best and gives the uninterrupted run's epoch-2
    scalars; a missing resume path raises ``FileNotFoundError``; the smoke
    flagship with ``pretrain_encoder_path`` (the run's directory) takes
    its first step from the grafted trunk, its teacher too."""
    opts = TINY_PRETRAIN + ["device=cpu", "save_freq=1", "val_freq=1"]
    res = ttrain.parse_and_run(["--cfg", VIEWGEN, f"root_dir={tmp_path}",
                                *opts])
    assert np.isfinite(res["val_loss"]) and res["best"]["epoch"] in (1, 2)
    run = _run_dir(str(tmp_path))
    with open(os.path.join(run, "scalars.jsonl")) as f:
        sc = [json.loads(x) for x in f]
    lrs = [d["value"] for d in sc if d["tag"] == "lr"]
    cfg = EasyConfig()
    cfg.load(VIEWGEN, recursive=True)
    cfg.update(TINY_PRETRAIN)
    sched = build_scheduler_from_cfg(cfg)
    assert lrs == [sched(1), sched(2)], lrs
    assert all(np.isfinite(d["value"]) for d in sc)
    ck = os.path.join(run, "checkpoint")
    name = os.path.basename(run)
    for tag in ("latest", "best", "E1", "E2"):
        assert os.path.exists(tckpt.ckpt_path(ck, name, tag)), tag
    e1 = tckpt.ckpt_path(ck, name, "E1")
    assert torch.load(e1, weights_only=True)["epoch"] == 1

    res_b = ttrain.parse_and_run(["--cfg", VIEWGEN, f"root_dir={tmp_path}",
                                  "mode=resume", f"pretrained_path={e1}",
                                  *opts])
    with open(os.path.join(run, "scalars.jsonl")) as f:
        sc_b = [json.loads(x) for x in f][len(sc):]
    assert {d["step"] for d in sc_b} == {2}
    a2 = {d["tag"]: d["value"] for d in sc if d["step"] == 2}
    b2 = {d["tag"]: d["value"] for d in sc_b}
    assert a2.keys() == b2.keys()
    for k in a2:
        assert abs(a2[k] - b2[k]) <= 1e-6 * max(abs(a2[k]), 1e-30), k
    assert res_b["best"]["epoch"] == res["best"]["epoch"]
    with pytest.raises(FileNotFoundError, match="mode=resume requires"):
        ttrain.parse_and_run(["--cfg", VIEWGEN, f"root_dir={tmp_path}/x",
                              "mode=resume",
                              f"pretrained_path={tmp_path}/gone.pth", *opts])

    # the graft: TINY_PRETRAIN's encoder is the smoke flagship's trunk;
    # the smoke run stops after its first step
    enc = {k[len("encoder."):]: v for k, v in
           tckpt.load_variables(tckpt.discover_checkpoint(run),
                                False).items()
           if k.startswith("encoder.")}
    seen = {}
    real = ttrain.make_semi_step

    class Stop(Exception):
        pass

    def spy(cfg):
        step = real(cfg)

        def first(state, *args, **kwargs):
            seen["student"] = {k: v.clone() for k, v in
                               state.model.state_dict().items()}
            seen["teacher"] = {k: v.clone() for k, v in
                               state.teacher.state_dict().items()}
            seen["metrics"] = step(state, *args, **kwargs)
            raise Stop

        return first

    ttrain.make_semi_step = spy
    try:
        with pytest.raises(Stop):
            ttrain.parse_and_run([
                "--cfg", SMOKE, f"root_dir={tmp_path}/s", "device=cpu",
                f"pretrain_encoder_path={run}"])
    finally:
        ttrain.make_semi_step = real
    assert np.isfinite(float(seen["metrics"]["loss"]))
    assert len(enc) > 40
    for who in ("student", "teacher"):
        for k, v in enc.items():
            assert torch.equal(seen[who]["segmentor." + k], v), (who, k)
