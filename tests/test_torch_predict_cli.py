"""The port's predict CLI and model loading against ``geot_tpu``'s:
``main`` on one OBJ scan (with votes and ``--ply``) and on a directory of
scans, at the flagship recipe cut to a small width, the labels JSON equal
to ``geot_tpu``'s; a reference ``.pth`` read as ``geot_tpu``'s
``convert_torch_seg_t`` reads it; and the trainer's reference
``pretrained_path``. (Serving the zoo: ``tests/test_torch_serve.py``.)

At 256 sampled points every JAX neighbour search is exact ``lax.top_k``, as
the port's always is, so labels are compared for equality."""
import argparse
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.engine import checkpoint as jckpt
from geot_tpu.engine import predict as jpredict
from geot_tpu.models import build_model_from_cfg as jbuild

from geot_tpu_torch.engine import checkpoint as tckpt
from geot_tpu_torch.engine import predict as tpredict
from geot_tpu_torch.engine import train as ttrain
from geot_tpu_torch.engine.convert import params_from_jax

from test_torch_io import write_obj, write_teeth3ds
from test_torch_model import N_POINTS, SMALL_ARGS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "cfgs", "tooth_semi",
                        "transformer_finetune_fixmatch_ntm.yaml")
# the flagship YAML cut to the small width of tests/test_torch_model.py
SMALL = [f"model.segmentor_args.{k}={v}".replace(" ", "")
         for k, v in SMALL_ARGS.items() if k != "NAME"] + \
    [f"num_points={N_POINTS}"]


def jax_variables(jmodel, batch, seed=0):
    """``jmodel``'s variables from a jitted ``init`` (seconds, where flax's
    eager init of these models takes up to 20 s), as numpy, with jittered
    BatchNorm statistics and, for the seg_T family, a non-zero
    ``T_linear``."""
    key = jax.random.PRNGKey(seed)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        {"params": key, "dropout": jax.random.fold_in(key, 1)},
        {k: jnp.asarray(v) for k, v in batch.items()}))
    rng = np.random.default_rng(seed)

    def jitter(path, a):
        name = path[-1].key
        if name == "mean":
            return rng.uniform(-0.05, 0.05, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        return a

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        jitter, variables["batch_stats"])
    seg = variables["params"].get("segmentor", {})
    if "T_linear" in seg:
        seg["T_linear"] = rng.standard_normal(seg["T_linear"].shape).astype(
            np.float32) * 0.1
    return variables


def _reference_pth(path, variables, prefix="module.", epoch=3):
    """A reference-style checkpoint of ``variables``: torch Conv1d-shaped
    (out, in, 1) weights where the reference has Conv1d layers, keys under
    ``module.``, BatchNorm counters, an epoch, and a pickled argument
    object (which ``weights_only=True`` refuses)."""
    sd = {}
    for k, v in params_from_jax(variables).items():
        if k.endswith(".weight") and v.ndim == 2 and (
                ".encoder." in k or "seg_head" in k or "propogation" in k):
            v = v[..., None]
        elif k.endswith(".weight") and v.ndim == 2 and "dgcnn_pro" in k:
            v = v[..., None, None]
        if k.endswith("num_batches_tracked"):
            v = torch.tensor(12)
        sd[prefix + k] = v
    torch.save({"model": sd, "epoch": epoch,
                "args": argparse.Namespace(lr=1e-3)}, path)
    return path


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    pos = np.zeros((1, N_POINTS, 3), np.float32)
    variables = jax_variables(
        jbuild({"NAME": "WholePartSeg", "segmentor_args": SMALL_ARGS}),
        {"pos": pos, "x": pos, "cls": np.zeros((1, 1), np.int32)}, seed=2)
    pth = _reference_pth(str(tmp / "ref.pth"), variables)
    scans = tmp / "scans"
    scans.mkdir()
    from geot_tpu_torch.data.tooth_semi import _synthetic_scan
    for i, name in enumerate(("b_upper.obj", "c.obj")):
        write_obj(str(scans / name), _synthetic_scan(40 + i, 1200 + 300 * i)
                  [0])
    np.save(scans / "d_lower.npy", _synthetic_scan(45, 900)[0])
    tree = str(tmp / "teeth3ds")
    write_teeth3ds(tree, [(f"P{i}", i % 2, *_synthetic_scan(60 + i, 500))
                          for i in range(4)])
    return tmp, variables, pth, scans, tree


def test_reference_pth_converts_as_geot_tpu(small):
    """The port's import of a reference ``.pth`` equals ``geot_tpu``'s
    ``convert_torch_seg_t`` of the same file through ``params_from_jax``,
    bit for bit; the epoch comes along; a bare state_dict converts the
    same; ``read_weights`` tells it from a port checkpoint by content;
    ``convert_cli`` writes the same state_dict to a file."""
    tmp, variables, pth, _, _ = small
    sd, epoch = tckpt.load_torch_pth(pth, with_epoch=True)
    got = tckpt.convert_torch_seg_t(sd, depth=SMALL_ARGS["depth"])
    jsd = jckpt.load_torch_pth(pth)
    p, s = jckpt.convert_torch_seg_t(jsd, depth=SMALL_ARGS["depth"])
    want = params_from_jax({"params": p, "batch_stats": s})
    assert epoch == 3 and set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert set(got) == set(params_from_jax(variables))
    bare = str(tmp / "bare.pth")
    torch.save({k[len("module."):]: v for k, v in
                torch.load(pth, weights_only=False)["model"].items()}, bare)
    for path in (pth, bare):
        w = tpredict.read_weights(path, depth=SMALL_ARGS["depth"])
        assert all(torch.equal(w[k], got[k]) for k in got)
    model = tpredict.load_model(SMALL_ARGS, ckpt=pth, device="cpu")
    ref = params_from_jax(variables)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ref[k]), k
    with pytest.raises(ValueError, match="seg_T weights only"):
        tpredict.read_weights(pth, depth=None)
    out = tckpt.convert_cli([pth, str(tmp / "converted.pt"), "--depth",
                             str(SMALL_ARGS["depth"])])
    saved = torch.load(out, weights_only=True)
    assert set(saved) == set(got)
    assert all(torch.equal(saved[k], got[k]) for k in got)


def _jmain(argv):
    return jpredict.main(argv)


def _tmain(argv):
    return tpredict.main(argv + ["device=cpu"])


def test_predict_cli_one_scan_matches_geot_tpu(small):
    """One OBJ scan with 2 votes and ``--ply``: the labels JSON (all but
    the timing) and the PLY bytes equal ``geot_tpu``'s."""
    tmp, _, pth, scans, _ = small
    out = {}
    for tag, main in (("j", _jmain), ("t", _tmain)):
        labels = main(["--cfg", FLAGSHIP, "--ckpt", pth, "--input",
                       str(scans / "b_upper.obj"), "--output",
                       str(tmp / f"{tag}.json"), "--ply",
                       str(tmp / f"{tag}.ply"), "--votes", "2", *SMALL])
        with open(tmp / f"{tag}.json") as f:
            out[tag] = json.load(f)
        assert out[tag]["labels"] == labels
        assert out[tag].pop("seconds") >= 0
    assert out["t"] == out["j"]
    assert out["t"]["jaw"] == "upper" and out["t"]["n_points"] == 1200
    assert (tmp / "t.ply").read_bytes() == (tmp / "j.ply").read_bytes()


def test_predict_cli_directory_matches_geot_tpu(small):
    """A directory of OBJ and npy scans streamed through
    ``predict_stream``: per-scan JSON (and PLY) files equal to
    ``geot_tpu``'s; the jaw comes from the file name, not the directory;
    ``--votes`` is refused in this mode, as in ``geot_tpu``."""
    tmp, _, pth, scans, _ = small
    for tag, main in (("j", _jmain), ("t", _tmain)):
        n = main(["--cfg", FLAGSHIP, "--ckpt", pth, "--input", str(scans),
                  "--output", str(tmp / f"dir_{tag}"), "--ply", "yes",
                  *SMALL])
        assert n == 3
    names = sorted(os.listdir(tmp / "dir_t"))
    assert names == sorted(os.listdir(tmp / "dir_j")) and len(names) == 6
    for name in names:
        a = (tmp / "dir_t" / name).read_bytes()
        assert a == (tmp / "dir_j" / name).read_bytes(), name
    jaws = {n: json.loads((tmp / "dir_t" / n).read_text())["jaw"]
            for n in names if n.endswith(".json")}
    assert jaws == {"b_upper.json": "upper", "c.json": "upper",
                    "d_lower.json": "lower"}
    with pytest.raises(SystemExit):
        _tmain(["--cfg", FLAGSHIP, "--input", str(scans), "--votes", "2",
                "--output", str(tmp / "x"), *SMALL])


class _Loaded(Exception):
    """Raised once the trainer has grafted its pretrained weights: the
    test stops the run there."""


class _Log(list):
    """A logger that keeps its messages."""

    def info(self, msg):
        self.append(msg)

    warning = info


def test_trainer_reads_a_reference_pth(small):
    """``pretrained_path`` = a reference ``.pth``, data from a Teeth3DS
    tree: ``mode=val`` scores its weights (every entry grafted),
    ``mode=finetune_encoder`` grafts the encoder only and leaves the rest at the fresh init (the run is stopped
    once the weights are in); for a zoo config the file does not convert,
    and the load is logged as failed, as ``geot_tpu`` logs it before
    training from scratch."""
    _, variables, pth, _, tree = small
    smoke = os.path.join(ROOT, "cfgs", "tooth_semi", "smoke.yaml")
    on_disk = [f"dataset_l.common.data_root={tree}",
               f"dataset_u.common.data_root={tree}"]
    grafted = {}
    real = ttrain._load_pretrained

    def spy(model, weights, *args):
        real(model, weights, *args)
        grafted[args[1]] = {k: v.clone() for k, v in
                            model.state_dict().items()}
        if args[1] == "finetune_encoder":
            raise _Loaded

    ttrain._load_pretrained = spy
    try:
        # main() without a run directory: no log file, no event writer
        res = ttrain.main(_cfg(smoke, "mode=val", f"pretrained_path={pth}",
                               *on_disk), device="cpu")
        assert 0.0 <= res["val"]["whole_miou"] <= 1.0
        with pytest.raises(_Loaded):
            ttrain.main(_cfg(smoke, "mode=finetune_encoder",
                             f"pretrained_path={pth}", *on_disk),
                        device="cpu")
    finally:
        ttrain._load_pretrained = real
    ref = params_from_jax(variables)
    cfg = _cfg(smoke)
    fresh = ttrain.SemiTrainState.create(
        cfg, seg_args=dict(cfg.model.segmentor_args),
        seed=int(cfg.get("seed", 0)), device="cpu").model.state_dict()
    n_enc = 0
    for mode, want in (("val", ref), ("finetune_encoder", None)):
        for k, v in grafted[mode].items():
            if k.endswith("num_batches_tracked"):
                continue
            w = want[k] if want else (ref if "encoder" in k else fresh)[k]
            n_enc += mode != "val" and "encoder" in k
            assert torch.equal(v, w), (mode, k)
    assert n_enc == 16
    zoo = _cfg(os.path.join(ROOT, "cfgs", "tooth_sup", "pointnet2.yaml"))
    log = _Log()
    assert ttrain._pretrained_weights(zoo, pth, "train", False, log) is None
    assert log and log[0].startswith("pretrain load failed")


def _cfg(path, *opts):
    from geot_tpu_torch.core.config import EasyConfig

    cfg = EasyConfig()
    cfg.load(path, recursive=True)
    cfg.update(list(opts))
    return cfg
