"""The trainer's other switches against ``geot_tpu``: ``profile_epoch``,
``wandb.use_wandb``, ``eval_device_cache: False``, ``step_per_update`` with
another optimizer, a resume in the middle of an accumulation group, the
finetune and jaw-classification datasets, pretraining over two ranks, and
the refusals that remain.

The trainer runs ``cfgs/tooth_semi/smoke.yaml`` on the CPU (stochastic
depth and dropout off where it is held against ``geot_tpu``: the
frameworks draw different masks). ``geot_tpu``'s epoch scalars are held
to ``tests/test_torch_resume_jax.py``'s bounds (``LOSS_RTOL`` relative on
the loss terms, ``METRIC_ATOL`` absolute on the metrics).
"""
import glob
import json
import os
import subprocess
import sys
import types

os.environ.setdefault("GEOT_EXACT_KNN", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from geot_tpu.core.config import EasyConfig as JEasyConfig  # noqa: E402
from geot_tpu.data import tooth_pretrain as jtooth  # noqa: E402
from geot_tpu.engine import train as jtrain  # noqa: E402
from geot_tpu.engine.checkpoint import (_restore,  # noqa: E402
                                       discover_checkpoint)
from geot_tpu.engine.writer import Wandb as JWandb  # noqa: E402

from geot_tpu_torch.core.config import (EasyConfig,  # noqa: E402
                                        build_model_from_cfg)
from geot_tpu_torch.data import build as tdata_build  # noqa: E402
from geot_tpu_torch.data import tooth_pretrain as ttooth  # noqa: E402
from geot_tpu_torch.data import tooth_semi as tdata  # noqa: E402
from geot_tpu_torch.engine import train as ttrain  # noqa: E402
from geot_tpu_torch.engine.checkpoint import save_checkpoint  # noqa: E402
from geot_tpu_torch.engine.convert import semi_state_from_jax  # noqa: E402
from geot_tpu_torch.engine.state import SemiTrainState  # noqa: E402
from geot_tpu_torch.engine.eval import validate  # noqa: E402
from geot_tpu_torch.engine.steps import make_eval_step  # noqa: E402
from geot_tpu_torch.engine.writer import Wandb  # noqa: E402

from test_pretrain import TINY_PRETRAIN  # noqa: E402
from test_torch_io import write_teeth3ds  # noqa: E402
from test_torch_resume_jax import (LOSS_RTOL, LOSSES,  # noqa: E402
                                   METRIC_ATOL, OPTS, SMOKE, _only_dir,
                                   _scalars)
from torch_helpers import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIEWGEN = os.path.join(ROOT, "cfgs", "tooth_pretrain", "viewgen.yaml")
# two ranks against one process: float32 on the CPU, the global sums in
# another order (SyncBN, the loss's sums, the gradients): the first step's
# loss relative, and the weights after the second step, root mean square
# in learning rates (an AdamW step moves a weight by about lr, and a
# gradient near 0 whose sign the order flips moves it the other way)
PRETRAIN_LOSS_RTOL = 1e-5
PRETRAIN_WEIGHT_LR = 0.05



def _run(root, *opts):
    return ttrain.parse_and_run(["--cfg", SMOKE, f"root_dir={root}",
                                 "device=cpu", *opts])


# --- profile_epoch, wandb, eval_device_cache -------------------------------

def test_profile_epoch_writes_a_trace(tmp_path):
    _run(tmp_path, "epochs=1", "profile_epoch=1")
    run_dir = _only_dir(str(tmp_path))
    (path,) = glob.glob(os.path.join(run_dir, "trace", "*.json"))
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    # the kernels' ops (on the CPU their plain versions)
    assert {"geot::fps", "geot::knn_small_k"} <= names


class _FakeWandb(types.ModuleType):
    """A ``wandb`` that records ``init`` and ``save``."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kwargs):
        self.calls.append(("init", kwargs))
        return types.SimpleNamespace(log=lambda data, step=None: None)

    def save(self, path):
        self.calls.append(("save", path))


def _plain(x):
    return json.loads(json.dumps(x, sort_keys=True, default=str))


def test_wandb_facade_matches_geot_tpu(tmp_path, monkeypatch):
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    (run_dir / "cfg.yaml").write_text("lr: 0.1\n")
    cfgs = []
    for cls in (JEasyConfig, EasyConfig):
        cfg = cls()
        cfg.load(SMOKE, recursive=True)
        cfg.update(["wandb.use_wandb=True", "wandb.project=geot",
                    f"run_dir={run_dir}", "run_name=r"])
        cfgs.append(cfg)
    # without wandb: a no-op
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert Wandb.launch(cfgs[1], True) is None and Wandb.run is None
    Wandb.log({"x": 1.0})
    calls = []
    for facade, cfg in ((JWandb, cfgs[0]), (Wandb, cfgs[1])):
        fake = _FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        try:
            assert facade.launch(cfg, True) is not None
            facade.log({"x": 1.0}, step=1)
        finally:
            facade.run = None
        calls.append(_plain(fake.calls))
    assert calls[0] == calls[1]
    init = dict(calls[1][0][1])
    assert init["project"] == "geot" and init["name"] == "r"
    assert {"run_path", "commit", "gitdiff"} <= set(init["config"])
    assert calls[1][1] == ["save", str(run_dir / "cfg.yaml")]


def test_trainer_runs_with_wandb_on_and_no_wandb(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    res = _run(tmp_path, "epochs=1", "wandb.use_wandb=True")
    assert 0.0 <= res["val"]["whole_acc"] <= 1.0 and Wandb.run is None


def test_uncached_validation_gives_the_cached_metrics():
    cfg = EasyConfig()
    cfg.load(SMOKE, recursive=True)
    model = build_model_from_cfg(cfg.model).eval()
    loader = tdata_build.build_dataloader_from_cfg(
        2, cfg.dataset_l, None, cfg.datatransforms, split="val")
    loader.dataset.file_list = loader.dataset.file_list[:4]
    step = make_eval_step()
    plain = validate(step, model, loader, dict(cfg, eval_device_cache=False))
    assert not hasattr(loader, "_geot_eval_cache")
    again = validate(step, model, loader, dict(cfg, eval_device_cache=False))
    cached = validate(step, model, loader, dict(cfg))
    assert hasattr(loader, "_geot_eval_cache")
    assert plain == again == cached


# --- step_per_update and another optimizer --------------------------------

def test_sgd_with_step_per_update_tracks_geot_tpu(tmp_path):
    """An SGD update every 2 gradients: ``geot_tpu`` trains epoch 1 and
    checkpoints it (its optimizer state a ``MultiStepsState`` over SGD's
    ``TraceState``, the T-predictor's a ``TraceState``); both packages
    resume from that state to epoch 2, 12 steps, and their epoch-2
    scalars agree."""
    opts = ["optimizer.NAME=sgd", "step_per_update=2", *OPTS]
    jroot = tmp_path / "j"
    jtrain.parse_and_run(["--cfg", SMOKE, "epochs=1", f"root_dir={jroot}",
                          *opts])
    jdir = _only_dir(str(jroot))
    jlatest = discover_checkpoint(jdir, "latest")
    payload = _restore(jlatest)
    cfg = EasyConfig()
    cfg.load(SMOKE, recursive=True)
    cfg.update(opts)
    state = SemiTrainState.create(cfg, seg_args=dict(
        cfg.model.segmentor_args), device="cpu")
    state.load(semi_state_from_jax(payload["state"]))
    assert state.opt.every_k == 2 and int(state.opt.state[
        state.opt.params()[0]]["step"]) == 6
    run_dir = tmp_path / "t" / "tooth_semi" / "from-geot_tpu"
    extra = {k: float(v) for k, v in payload["extra"].items()
             if k != "ema_selected"}
    extra["epoch"] = int(extra["epoch"])
    tlatest = save_checkpoint({"ckpt_dir": str(run_dir / "checkpoint"),
                               "run_name": "from-geot_tpu"}, state,
                              int(payload["epoch"]), additional_dict=extra,
                              is_best=True)
    jtrain.parse_and_run(["--cfg", SMOKE, "mode=resume",
                          f"pretrained_path={jlatest}", "epochs=2",
                          f"root_dir={jroot}", *opts])
    _run(tmp_path / "t", "mode=resume", f"pretrained_path={tlatest}",
         "epochs=2", *opts)
    j, t = _scalars(jdir, 2), _scalars(str(run_dir), 2)
    worst = {}
    for tag in LOSSES:
        worst[tag] = abs(t[tag] - j[tag]) / abs(j[tag])
        assert worst[tag] <= LOSS_RTOL, (tag, t[tag], j[tag])
    metrics = [k for k in j if k.startswith(("val_", "best_val_", "test_"))]
    assert len(metrics) >= 20
    for tag in metrics:
        worst[tag] = abs(t[tag] - j[tag])
        assert worst[tag] <= METRIC_ATOL, (tag, t[tag], j[tag])
    print("epoch 2, |port - geot_tpu| (losses relative):",
          {k: f"{v:.2e}" for k, v in worst.items() if v})


def test_resume_in_the_middle_of_a_group_is_bit_equal(tmp_path):
    """12 steps an epoch, an update every 5 (lookahead AdamW with layer
    decay): epoch 1 ends 2 gradients into a group, which its checkpoint
    carries; epoch 2 resumed from it equals the uninterrupted run's."""
    opts = ["epochs=2", "val_freq=1", "save_freq=1", "step_per_update=5",
            "optimizer.NAME=lookahead_adamw", "optimizer.lookahead_k=2",
            "optimizer.layer_decay=0.75"]
    _run(tmp_path, *opts)
    run_dir = _only_dir(str(tmp_path))
    a2 = _scalars(run_dir, 2)
    (e1,) = glob.glob(os.path.join(run_dir, "checkpoint", "*E1.pth"))
    saved = torch.load(e1, weights_only=True)["state"]["opt"]["state"]
    assert {s["mini_step"] for s in saved.values()} == {2}
    assert {int(s["step"]) for s in saved.values()} == {2}
    ttrain.parse_and_run(["--cfg", SMOKE, f"root_dir={tmp_path}",
                          "device=cpu", "mode=resume",
                          f"pretrained_path={e1}", *opts])
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    b2 = {d["tag"]: d["value"] for d in lines[len(lines) // 2:]
          if d["step"] == 2}
    tags = [t for t in a2 if t not in ("epoch_seconds", "data_seconds")]
    assert len(tags) >= 20
    assert {t: b2[t] for t in tags} == {t: a2[t] for t in tags}


# --- the datasets ----------------------------------------------------------

@pytest.fixture(scope="module")
def finetune_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("finetune"))
    scans = [(f"P{i:03d}", i % 2, *tdata._synthetic_scan(70 + i, 700))
             for i in range(6)]
    write_teeth3ds(root, scans)
    lines = [f"P{i:03d}_{'lower' if i % 2 == 0 else 'upper'}"
             for i in range(6)]
    for name, part in (("full_train_finetune_0.1.txt", lines[:4]),
                       ("full_val_finetune.txt", lines[4:]),
                       ("full_test_finetune.txt", lines[4:]),
                       ("full_train_finetune.txt", lines)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(part) + "\n")
    return root


@pytest.mark.parametrize("name", ["TeethSegFinetuneDataset",
                                  "TeethClsDataset"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_datasets_equal_geot_tpu(name, split, finetune_tree):
    kw = {"data_root": finetune_tree, "num_points": 512, "split": split}
    jds, tds = getattr(jtooth, name)(**kw), getattr(ttooth, name)(**kw)
    assert not tds.synthetic and len(tds) == len(jds) > 0
    for ds in (jds, tds):
        ds.epoch = 3
    for i in range(len(tds)):
        want, got = jds[i], tds[i]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
    if name == "TeethClsDataset":
        assert got["y"].tolist() == [tds.file_list[-1]["location"]]
        assert tds.num_classes == 2 and got["x"].shape == (512, 4)


def test_finetune_dataset_trains_through_the_supervised_recipe(
        finetune_tree, tmp_path):
    res = ttrain.parse_and_run([
        "--cfg", os.path.join(ROOT, "cfgs", "tooth_sup", "transformer.yaml"),
        f"root_dir={tmp_path}", "device=cpu", "epochs=1",
        "dataset_l.common.NAME=TeethSegFinetuneDataset",
        f"dataset_l.common.data_root={finetune_tree}",
        "dataset_l.common.num_points=256", "batch_size_l=2",
        "model.segmentor_args.trans_dim=48", "model.segmentor_args.depth=3",
        "model.segmentor_args.num_group=32",
        "model.segmentor_args.group_size=8",
        "model.segmentor_args.encoder_dims=32",
        "model.segmentor_args.extract_layers=[1,2,3]",
        "model.segmentor_args.downsample_targets=[128,64,32]"])
    assert 0.0 <= res["val"]["whole_acc"] <= 1.0


# --- pretraining over two ranks -------------------------------------------

def _pretrain_weights(run_dir):
    (latest,) = glob.glob(os.path.join(run_dir, "checkpoint",
                                       "*latest.pth"))
    return torch.load(latest, weights_only=True)["state"]["model"]


def _steplosses(text):
    return [float(line.split("steploss ")[1].split()[1])
            for line in text.splitlines() if "steploss " in line]


def test_two_rank_pretraining_equals_one_process(tmp_path):
    """One epoch of 2 steps of 8 synthetic scans (4 a rank) through
    ``engine.launch``, against one process on the same batches."""
    opts = [*TINY_PRETRAIN, "epochs=1", "val_freq=1", "batch_size=8",
            "warmup_epochs=0", "model.encoder_args.drop_path_rate=0.0",
            "seed=3"]
    env = dict(os.environ, OMP_NUM_THREADS="1", GEOT_LOG_STEP_LOSS="1")
    one = tmp_path / "one"
    proc = subprocess.run(
        [sys.executable, "-m", "geot_tpu_torch.engine.train", "--cfg",
         VIEWGEN, f"run_dir={one}", "run_name=one", "device=cpu", *opts],
        cwd=ROOT, timeout=600, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    two = tmp_path / "two"
    proc2 = subprocess.run(
        [sys.executable, "-m", "geot_tpu_torch.engine.launch", "--nprocs",
         "2", "--devices-per-proc", "1", "--run-dir", str(two), "--",
         "--cfg", VIEWGEN, *opts],
        cwd=ROOT, timeout=600, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    assert proc2.returncode == 0, proc2.stdout[-4000:]
    log0 = (two / "rank0.log").read_text()
    assert "rank 0 of 2" in log0
    l1 = _steplosses(proc.stderr + proc.stdout)
    l2 = _steplosses(log0)
    assert len(l1) == len(l2) == 2, (l1, l2)
    rel = abs(l2[0] - l1[0]) / abs(l1[0])
    w1, w2 = _pretrain_weights(str(one)), _pretrain_weights(str(two))
    assert set(w1) == set(w2)
    lr = 5e-4           # viewgen's lr, epoch 1's without the warmup
    keys = [k for k in w1 if w1[k].is_floating_point()
            and "running" not in k]
    d = torch.cat([(w1[k].double() - w2[k].double()).reshape(-1)
                   for k in keys])
    rms, top = float(d.square().mean().sqrt()) / lr, float(d.abs().max()) / lr
    print(f"first-step loss relative {rel:.2e}; weights after step 2 "
          f"{rms:.3e} lr rms, max |d| {top:.3e} lr")
    assert rel <= PRETRAIN_LOSS_RTOL
    assert rms <= PRETRAIN_WEIGHT_LR
    assert not os.path.exists(two / "rank1.log") or \
        " INFO " not in (two / "rank1.log").read_text()


# --- the refusals that remain ---------------------------------------------

@pytest.mark.parametrize("opt,key", [
    ("tp=2", "tp"), ("sp=2", "sp"), ("fsdp=True", "fsdp"),
    ("dataset_l.common.NAME=S3DIS", "dataset_l.common.NAME"),
    ("model.NAME=VariableSeg", "model.NAME")])
def test_what_is_not_ported_is_still_refused(opt, key, tmp_path):
    cfg = EasyConfig()
    cfg.load(SMOKE, recursive=True)
    cfg.update([opt])
    with pytest.raises(NotImplementedError, match=key):
        ttrain.refuse_unported(cfg)


@pytest.mark.parametrize("opt", [
    "optimizer.NAME=adahessian", "optimizer.NAME=lookahead_sgd",
    "optimizer.layer_decay=0.75", "step_per_update=4", "profile_epoch=1",
    "eval_device_cache=False", "wandb.use_wandb=True",
    "model.segmentor_args.dtype=bfloat16"])
def test_ported_switches_are_taken(opt):
    cfg = EasyConfig()
    cfg.load(SMOKE, recursive=True)
    cfg.update([opt])
    ttrain.refuse_unported(cfg)
