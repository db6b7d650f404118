"""The port's trainer on the CPU: checkpoints of the whole train state, a
resumed run against an uninterrupted one, preemption, the eval modes, the
refused switches, and the package's import rule (no ``jax``, ``yaml`` or
``geot_tpu``), with ``cfgs/tooth_semi/smoke.yaml`` (D = 48, depth 3, 256
points) through ``parse_and_run``."""
import glob
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from geot_tpu_torch import FLAGSHIP_SEMI_CFG
from geot_tpu_torch.core.config import EasyConfig
from geot_tpu_torch.data.build import (MODEL_KEYS, SEMI_KEYS,
                                       build_semi_loaders, semi_pairs,
                                       to_device)
from geot_tpu_torch.engine import checkpoint as ckpt
from geot_tpu_torch.engine import train as ttrain
from geot_tpu_torch.engine.state import SemiTrainState
from geot_tpu_torch.engine.steps import make_semi_step

from test_torch_model import N_POINTS, SMALL_ARGS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "cfgs", "tooth_semi", "smoke.yaml")
CFG = dict(FLAGSHIP_SEMI_CFG, num_points=N_POINTS)
# tags whose values are times, not results
_TIMES = ("epoch_seconds", "data_seconds")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: these shapes run no faster on more, and the
    tier-1 run puts several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stepped_state(seed):
    """A small state after one semi step, with non-trivial ``cm``."""
    state = SemiTrainState.create(CFG, seg_args=SMALL_ARGS, seed=seed,
                                  device="cpu")
    state.cm = torch.rand((17, 17), generator=torch.Generator()
                          .manual_seed(seed))
    l, u = build_semi_loaders(CFG)
    bl, bu = next(semi_pairs(l, u))
    make_semi_step(CFG)(state, to_device(bl, MODEL_KEYS, "cpu"),
                        to_device(bu, SEMI_KEYS, "cpu"), 1e-3, True)
    return state


def _flat(sd, prefix=""):
    """Every tensor and number of a nested state dict by path."""
    out = {}
    items = sd.items() if isinstance(sd, dict) else enumerate(sd)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == fb[k].dtype and torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    state = _stepped_state(0)
    torch.rand(3, generator=state.generator)   # move the mask generator on
    cfg = {"ckpt_dir": str(tmp_path / "ck"), "run_name": "r"}
    latest = ckpt.save_checkpoint(cfg, state, 4, additional_dict={
        "miou": 0.5, "epoch": 4}, is_best=True, save_freq=2)
    names = sorted(os.listdir(tmp_path / "ck"))
    assert names == ["r_ckpt_E4.pth", "r_ckpt_best.pth", "r_ckpt_latest.pth"]
    fresh = SemiTrainState.create(CFG, seg_args=SMALL_ARGS, seed=9,
                                  device="cpu")
    epoch, extra = ckpt.load_checkpoint(latest, fresh)
    assert (epoch, extra) == (4, {"miou": 0.5, "epoch": 4})
    _assert_same(fresh.state_dict(), state.state_dict())
    assert fresh.opt.state and fresh.t_opt.state and fresh.step == 1
    # the restored generator draws the masks the saved one would
    assert torch.equal(torch.rand(5, generator=fresh.generator),
                       torch.rand(5, generator=state.generator))
    # the teacher is the saved teacher, not a copy of the student
    assert not torch.equal(fresh.teacher.state_dict()[
        "segmentor.seg_head.0.weight"], fresh.model.state_dict()[
        "segmentor.seg_head.0.weight"])
    _assert_same(ckpt.load_variables(os.path.join(
        tmp_path, "ck", "r_ckpt_best.pth")), state.model.state_dict())


def test_a_kill_during_a_save_keeps_the_previous_file(tmp_path, monkeypatch):
    state = _stepped_state(1)
    cfg = {"ckpt_dir": str(tmp_path), "run_name": "r"}
    latest = ckpt.save_checkpoint(cfg, state, 1)
    before = open(latest, "rb").read()
    real_save = torch.save

    def killed(obj, path):
        with open(path, "wb") as f:
            f.write(b"half a file")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", killed)
    state.step += 5
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_checkpoint(cfg, state, 2)
    monkeypatch.setattr(torch, "save", real_save)
    assert open(latest, "rb").read() == before
    assert os.path.exists(latest + ".tmp")
    fresh = SemiTrainState.create(CFG, seg_args=SMALL_ARGS, device="cpu")
    assert ckpt.load_checkpoint(latest, fresh)[0] == 1 and fresh.step == 1


def test_discover_checkpoint_order(tmp_path):
    ck = tmp_path / "checkpoint"
    ck.mkdir()

    def touch(name, t):
        p = ck / name
        p.write_bytes(b"")
        os.utime(p, (t, t))

    touch("r_ckpt_E100.pth", 100)
    touch("r_ckpt_E2.pth", 300)
    touch("r_ckpt_latest.pth.tmp", 400)
    assert ckpt.discover_checkpoint(str(tmp_path)).endswith("_E2.pth")
    touch("r_ckpt_latest.pth", 200)
    assert ckpt.discover_checkpoint(str(tmp_path)).endswith("_latest.pth")
    touch("r_ckpt_best.pth", 50)
    assert ckpt.discover_checkpoint(str(tmp_path)).endswith("_best.pth")
    assert ckpt.discover_checkpoint(str(tmp_path), "latest").endswith(
        "_latest.pth")
    (ck / "r_ckpt_best.pth").unlink()
    (ck / "r_ckpt_latest.pth").unlink()
    for p in ck.glob("*E*"):
        p.unlink()
    with pytest.raises(FileNotFoundError):
        ckpt.discover_checkpoint(str(tmp_path))


def test_partial_checkpoints(tmp_path, caplog):
    state = _stepped_state(2)
    path = str(tmp_path / "weights.pth")
    torch.save({"state": {"model": state.model.state_dict()}, "epoch": 7},
               path)
    fresh = SemiTrainState.create(CFG, seg_args=SMALL_ARGS, seed=5,
                                  device="cpu")
    cm = fresh.cm.clone()
    missing = []
    assert ckpt.load_checkpoint(path, fresh, missing_fields=missing) == (
        7, {})
    assert sorted(missing) == ["cm", "contrast", "ema_params", "ema_t",
                               "generator", "opt", "step", "t_opt",
                               "t_predictor", "teacher"]
    _assert_same(fresh.model.state_dict(), state.model.state_dict())
    _assert_same(fresh.teacher.state_dict(), state.model.state_dict())
    assert torch.equal(fresh.cm, cm) and fresh.step == 0
    assert "partial checkpoint" in caplog.text
    sd = state.model.state_dict()
    sd.pop("segmentor.seg_head.3.weight")
    torch.save({"state": {"model": sd}}, path)
    with pytest.raises(ValueError, match="missing model-weight"):
        ckpt.load_checkpoint(path, fresh)


# --- whole runs through parse_and_run --------------------------------------

def _run(root, *opts):
    return ttrain.parse_and_run(["--cfg", SMOKE, f"root_dir={root}",
                                 "device=cpu", *opts])


def _run_dir(root):
    dirs = glob.glob(os.path.join(root, "tooth_semi", "*"))
    assert len(dirs) == 1, dirs
    return dirs[0]


def _scalars(run_dir, step):
    out = {}
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        for line in f:
            d = json.loads(line)
            if d["step"] == step and d["tag"] not in _TIMES:
                out[d["tag"]] = d["value"]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The smoke recipe (dropout on) for 2 epochs without a break, and for
    1 epoch then resumed to 2; both validate every epoch."""
    root = tmp_path_factory.mktemp("runs")
    whole = _run(root / "whole", "epochs=2", "val_freq=1")
    first = _run(root / "split", "epochs=1", "val_freq=1")
    split_dir = _run_dir(root / "split")
    latest = ckpt.discover_checkpoint(split_dir, "latest")
    resumed = _run(root / "split", "mode=resume", f"pretrained_path={latest}",
                   "epochs=2", "val_freq=1")
    return {"root": root, "whole": whole, "first": first,
            "resumed": resumed, "whole_dir": _run_dir(root / "whole"),
            "split_dir": split_dir}


def test_resume_is_bit_equal_to_an_uninterrupted_run(runs):
    # the resumed run wrote into its own run directory
    assert _run_dir(runs["root"] / "split") == runs["split_dir"]
    a = _scalars(runs["whole_dir"], 2)
    b = _scalars(runs["split_dir"], 2)
    assert a == b
    for tag in list(ttrain.REF_TAGS)[:9] + ["insT_threed_loss", "lr",
                                             "val_whole_miou",
                                             "best_val_miou",
                                             "test_whole_miou"]:
        assert tag in a, tag
    assert all(np.isfinite(v) for v in a.values())
    assert runs["whole"]["val"] == runs["resumed"]["val"]
    assert runs["whole"]["best"] == runs["resumed"]["best"]
    sa = torch.load(ckpt.discover_checkpoint(runs["whole_dir"], "latest"),
                    weights_only=True)
    sb = torch.load(ckpt.discover_checkpoint(runs["split_dir"], "latest"),
                    weights_only=True)
    assert sa["epoch"] == sb["epoch"] == 2
    _assert_same(sa["state"], sb["state"])


def test_run_directory_and_its_files(runs):
    d = runs["whole_dir"]
    name = os.path.basename(d)
    assert name.startswith("tooth_semi-train-smoke-seed1609-")
    files = set(os.listdir(d))
    assert {"cfg.yaml", "scalars.jsonl", "step_times.jsonl",
            f"{name}.log", "checkpoint"} <= files
    assert sorted(os.listdir(os.path.join(d, "checkpoint"))) == [
        f"{name}_ckpt_best.pth", f"{name}_ckpt_latest.pth"]
    cfg = EasyConfig()
    cfg.load(os.path.join(d, "cfg.yaml"))
    assert cfg.epochs == 2 and cfg.run_dir == d and cfg.device == "cpu"
    steps = [json.loads(x) for x in open(os.path.join(d,
                                                      "step_times.jsonl"))]
    assert [s["step"] for s in steps] == list(range(2, 25))


def test_val_mode_rescores_the_best_checkpoint(runs):
    best = ckpt.discover_checkpoint(runs["whole_dir"], "best")
    res = _run(runs["root"] / "whole", "mode=val", f"pretrained_path={best}")
    b = runs["whole"]["best"]
    assert (res["val"]["whole_miou"], res["val"]["whole_dsc"],
            res["val"]["whole_acc"]) == (b["miou"], b["dsc"], b["acc"])
    assert os.path.exists(os.path.join(runs["whole_dir"], "cfg_val.yaml"))
    res = _run(runs["root"] / "whole", "mode=test", f"pretrained_path={best}")
    assert res["test"] == runs["whole"]["test"]


def test_finetune_starts_from_the_checkpoint_weights(runs, tmp_path,
                                                     monkeypatch):
    best = ckpt.discover_checkpoint(runs["whole_dir"], "best")
    w = ckpt.load_variables(best)
    seen = {}
    real = ttrain.cal_mean_feature

    def spy(cm_step, model, loader, num_classes, device):
        seen["model"] = {k: v.clone() for k, v in model.state_dict().items()}
        return real(cm_step, model, loader, num_classes, device)

    monkeypatch.setattr(ttrain, "cal_mean_feature", spy)
    _run(tmp_path, "mode=finetune", f"pretrained_path={best}", "epochs=1",
         "val_freq=0", "test_freq=0")
    _assert_same(seen["model"], w)


def test_sigterm_checkpoints_after_the_epoch_and_stops(tmp_path,
                                                        monkeypatch):
    real = ttrain.make_semi_step

    def make(cfg):
        step = real(cfg)
        calls = []

        def signalling(*args):
            calls.append(1)
            if len(calls) == 2:
                signal.raise_signal(signal.SIGTERM)
            return step(*args)

        return signalling

    monkeypatch.setattr(ttrain, "make_semi_step", make)
    handler = signal.getsignal(signal.SIGTERM)
    res = _run(tmp_path, "epochs=3", "val_freq=0", "test_freq=0")
    assert res["preempted_at"] == 1
    assert signal.getsignal(signal.SIGTERM) == handler
    path = ckpt.discover_checkpoint(_run_dir(tmp_path), "latest")
    assert torch.load(path, weights_only=True)["epoch"] == 1
    assert "test" not in res and "val" not in res


# --- refusals --------------------------------------------------------------

def _ported(opt, key):
    """A case of a switch ported since it was listed: no key to match (the
    case id keeps the key it was listed with)."""
    return pytest.param(opt, None, id=f"{opt}-{key}")


@pytest.mark.parametrize("opt,key", [
    _ported("ema_eval=0.999", "ema_eval"), ("num_votes=2", None),
    _ported("profile_epoch=1", "profile_epoch"),
    _ported("wandb.use_wandb=True", "wandb.use_wandb"),
    _ported("jax_distributed=True", "jax_distributed"),
    _ported("distributed=True", "distributed"), ("tp=2", "tp"),
    ("sp=2", "sp"),
    ("fsdp=True", "fsdp"), _ported("step_per_update=2", "step_per_update"),
    _ported("eval_device_cache=False", "eval_device_cache"),
    _ported("pretrain_encoder_path=/x", "pretrain_encoder_path"),
    _ported("mode=finetune_encoder", "mode"),
    _ported("task=partseg", "task"), _ported("task=cls", "task"),
    _ported("model.generator_args={}", "model.generator_args"),
    ("model.segmentor_args.depth=2", None),
    ("model.segmentor_args.dtype=bfloat16", "model.segmentor_args.dtype"),
    ("model_t.segmentor_args.dtype=bfloat16",
     "model_t.segmentor_args.dtype"),
    _ported("use_contrastive=True", "use_contrastive"),
    _ported("pseudo_refine=True", "pseudo_refine"),
    _ported("threed_anchors=64", "threed_anchors"),
    _ported("skip_nonfinite_updates=True", "skip_nonfinite_updates"),
    _ported("reference_bugs=True", "reference_bugs"),
    _ported("use_feat_loss=True", "use_feat_loss"),
    _ported("use_identity_loss=True", "use_identity_loss"),
    _ported("criterion_u_args.NAME=Poly1FocalLoss_U",
            "Poly1FocalLoss_U_corr"),
    _ported("optimizer.NAME=adahessian", "adahessian"),
    _ported("sched=cosine", "cosine")])
def test_unported_switches_are_refused(opt, key):
    """Each switch whose branch the port lacks is refused, naming its key;
    the cases with no key (votes, a teacher of another topology, the semi
    step's branches, ``ema_eval``, the pretraining graft and stage, the
    cosine schedule, the heritage tasks) are ported now and pass both
    checks;
    ``tests/test_torch_fast_train.py``, ``tests/test_torch_semi_trainer.py``,
    ``tests/test_torch_ema.py`` and ``tests/test_torch_pretrain.py`` train
    with them."""
    cfg = EasyConfig()
    cfg.load(SMOKE, recursive=True)
    cfg.update([opt])
    if key is None:
        ttrain.refuse_unported(cfg)
        make_semi_step(cfg)
        return
    with pytest.raises(NotImplementedError, match=key):
        ttrain.main(cfg, device="cpu")


def test_other_configs_and_reference_files_are_refused(tmp_path):
    # the heritage configs run now (tests/test_torch_heritage_engine.py);
    # a dataset the port lacks is refused by its key before a run starts
    for path, opt, key in (
            ("cfgs/shapenetpart/pointnet2part.yaml",
             "dataset.common.NAME=S3DIS", "dataset.common.NAME"),
            ("cfgs/shapenetpart/pointmlppart.yaml",
             "dataset.test.NAME=ScanNet", "dataset.test.NAME"),
            ("cfgs/scanobjectnn/dgcnncls.yaml",
             "dataset.common.NAME=ModelNet40", "dataset.common.NAME")):
        with pytest.raises(NotImplementedError, match=key):
            ttrain.parse_and_run(["--cfg", os.path.join(ROOT, path), opt,
                                  f"root_dir={tmp_path}", "device=cpu"])
    assert not os.path.exists(tmp_path / "scanobjectnn")
    # a reference-style .pth that does not convert to the model: as in
    # geot_tpu (engine/train.py:248-310), finetune logs the failed load
    # and goes on from the fresh weights (the run is stopped once its
    # train state is built), an eval mode raises
    ref = str(tmp_path / "reference.pth")
    torch.save({"model": {"w": torch.zeros(2)}}, ref)
    with pytest.raises(FileNotFoundError, match="was NOT loaded"):
        _run(tmp_path / "val", "mode=val", f"pretrained_path={ref}")

    class Built(Exception):
        pass

    def stop(cfg):
        raise Built

    real = ttrain.make_supervised_step
    ttrain.make_supervised_step = stop
    try:
        with pytest.raises(Built):
            _run(tmp_path / "ft", "mode=finetune", f"pretrained_path={ref}")
    finally:
        ttrain.make_supervised_step = real
    log = open(glob.glob(os.path.join(_run_dir(tmp_path / "ft"),
                                      "*.log"))[0]).read()
    assert "pretrain load failed ('segmentor.encoder" in log
    assert "was NOT loaded" in log


def test_missing_paths_and_a_missing_card_raise(tmp_path, monkeypatch):
    cfg = EasyConfig()
    cfg.load(SMOKE, recursive=True)
    with pytest.raises(FileNotFoundError, match="mode=resume requires"):
        ttrain.main(EasyConfig(cfg, mode="resume"), device="cpu")
    for mode in ("val", "test"):
        with pytest.raises(ValueError, match="requires pretrained_path"):
            ttrain.main(EasyConfig(cfg, mode=mode), device="cpu")
        with pytest.raises(FileNotFoundError):
            ttrain.main(EasyConfig(cfg, mode=mode,
                                   pretrained_path=str(tmp_path / "no.pth")),
                        device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.parse_and_run(["--cfg", SMOKE, f"root_dir={tmp_path}"])


# --- the import rule -------------------------------------------------------

def test_every_module_imports_without_jax_yaml_or_geot_tpu(tmp_path):
    """Every module of the package imports with jax, flax, optax, orbax,
    yaml, geot_tpu and PIL blocked, and in the same process
    ``parse_and_run`` trains one smoke epoch on the CPU: the entry point
    reads its YAML with the port's own reader."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml",
                   "geot_tpu", "PIL")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {ROOT!r})
        import geot_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            geot_tpu_torch.__path__, "geot_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert "geot_tpu_torch.engine.train" in names, names
        assert {{"geot_tpu_torch.optim.extra",
                 "geot_tpu_torch.optim.adahessian"}} <= set(names), names
        layers = ["helpers", "weight_init", "drop", "factories", "mlp",
                  "knn", "subsample", "kmeans", "graph_conv", "attention"]
        assert {{"geot_tpu_torch.models.layers." + m for m in layers}} | {{
            "geot_tpu_torch.ops." + m for m in ("scatter", "vector_attn",
                                                "subsample", "compat")}} | {{
            "geot_tpu_torch.models.backbone.pointnet2_votes"}} <= set(names)
        assert {{"geot_tpu_torch.data." + m for m in (
            "data_util", "dataset_base", "sample_pc", "transforms")}} | {{
            "geot_tpu_torch.losses.cluster_contrast",
            "geot_tpu_torch.utils.vis2d"}} <= set(names), names
        from geot_tpu_torch.engine.train import parse_and_run
        res = parse_and_run(["--cfg", {SMOKE!r}, "epochs=1",
                             "root_dir={tmp_path}", "device=cpu",
                             "optimizer.NAME=lookahead_sgdp",
                             "optimizer.layer_decay=0.75",
                             "step_per_update=2", "profile_epoch=1",
                             "eval_device_cache=False",
                             "wandb.use_wandb=True"])
        assert 0 <= res["val"]["whole_acc"] <= 1, res
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ok", len(names))
    """)
    t = time.time()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path),
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    n = int(out.stdout.strip().splitlines()[-1].split()[1])
    print(f"{n} modules, one smoke epoch: {time.time() - t:.1f} s")
    assert n >= 30
