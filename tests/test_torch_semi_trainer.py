"""The port's trainer with every switch of the semi step on
(``cfgs/tooth_semi/smoke.yaml``, D = 48, depth 3, 256 points, through
``parse_and_run``), the switches still refused, and the unlabelled
batches' ``cur`` (per-point curvature) reaching ``Poly1FocalLoss_U_Cur``
as ``geot_tpu/engine/train.py:39-42`` passes it."""
import json
import os

import numpy as np
import pytest
import torch

from geot_tpu_torch.core.config import EasyConfig
from geot_tpu_torch.data import tooth_semi
from geot_tpu_torch.data.build import SEMI_KEYS, semi_keys
from geot_tpu_torch.engine import checkpoint as ckpt
from geot_tpu_torch.engine import train as ttrain
from geot_tpu_torch.engine.steps import make_semi_step
from geot_tpu_torch.optim import build_scheduler_from_cfg

from test_torch_semi_branches import CFG, batches
from test_torch_ema import _state, _tensors
from test_torch_trainer import SMOKE, _run, _run_dir
from torch_helpers import one_torch_thread  # noqa: F401

EVERY_FLAG = ["use_feat_loss=True", "feat_k=4", "use_identity_loss=True",
              "use_contrastive=True", "contrast_threshold=0.05",
              "pseudo_refine=True", "filter_outlier=True",
              "threed_anchors=64", "ema_eval=0.99",
              "skip_nonfinite_updates=True"]


@pytest.mark.parametrize("criterion_u", ["Poly1FocalLoss_U_corr",
                                         "Poly1FocalLoss_U_top2"])
def test_trainer_with_every_flag(tmp_path, criterion_u):
    """2 epochs (1 for top2) with validation each epoch and the test pass
    at the end: the reference's scalar tags of every auxiliary loss,
    ``val`` and ``val_raw``, no skipped step, the bank and the shadow in
    the checkpoint, and the best candidate's tree recorded."""
    epochs = 1 if criterion_u.endswith("top2") else 2
    res = _run(tmp_path, f"epochs={epochs}", "val_freq=1", "test_freq=2",
               f"criterion_u_args.NAME={criterion_u}", *EVERY_FLAG)
    for split in ("val", "val_raw", "test"):
        for k, v in res[split].items():
            assert np.isfinite(v) and 0.0 <= v <= 1.0, (split, k, v)
    run_dir = _run_dir(tmp_path)
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        tags = {}
        for d in map(json.loads, f):
            tags.setdefault(d["tag"], []).append(d["value"])
    for tag in ("train_loss", "manifold_loss_feat", "insT_identity_loss",
                "insT_threed_loss", "contrast_loss", "val_raw_whole_miou",
                "val_whole_miou", "test_whole_miou"):
        assert tag in tags and all(np.isfinite(tags[tag])), tag
    assert "skipped_steps" not in tags
    assert tags["contrast_loss"][0] > 0
    saved = torch.load(ckpt.discover_checkpoint(run_dir, "latest"),
                       weights_only=True)
    assert saved["state"]["ema_params"]
    assert int(saved["state"]["contrast"]["ptr"]) > 0
    assert saved["extra"]["ema_selected"] in (0.0, 1.0)
    assert res["best"]["ema_selected"] == saved["extra"]["ema_selected"]


def _ported(opt, key):
    """A switch ported since it was listed: the case keeps the id it was
    listed with."""
    return pytest.param(opt, None, id=f"{opt}-{key}")


@pytest.mark.parametrize("opt,key", [
    _ported("warmup_epochs=5", "warmup"),
    _ported("optimizer.NAME=adahessian", "adahessian"),
    _ported("optimizer.NAME=sgd", "sgd"),
    _ported("step_per_update=4", "step_per_update"),
    _ported("profile_epoch=1", "profile_epoch"),
    _ported("eval_device_cache=False", "eval_device_cache"),
    _ported("wandb.use_wandb=True", "wandb.use_wandb")])
def test_switches_still_unported_are_refused(opt, key):
    """The other half of the trainer's switches, all ported now: the
    trainer takes each and builds its step (``tests/test_torch_optim.py``,
    ``tests/test_torch_adahessian.py`` and
    ``tests/test_torch_trainer_switches.py`` hold them against
    ``geot_tpu``); with warmup the schedule rises from ``warmup_lr`` to the
    config's lr (``tests/test_torch_pretrain.py`` holds every schedule)."""
    cfg = EasyConfig()
    cfg.load(SMOKE, recursive=True)
    cfg.update([opt])
    assert key is None
    ttrain.refuse_unported(cfg)
    make_semi_step(cfg)
    if opt.startswith("warmup"):
        sched = build_scheduler_from_cfg(cfg)
        assert sched(1) == 1e-6 and sched(6) == float(cfg.lr)
        assert 1e-6 < sched(3) < float(cfg.lr)


def test_cur_gates_poly1focalloss_u_cur():
    """``cur`` in the unlabelled batch decides ``Poly1FocalLoss_U_Cur``'s
    mask: all below the threshold gives a zero loss, all above a positive
    one, and without ``cur`` the confidence gates."""
    cfg = dict(CFG, criterion_u_args={"NAME": "Poly1FocalLoss_U_Cur"},
               threshold=0.0)
    bl, bu = batches()
    losses = {}
    for tag, cur in (("lo", -1.0), ("hi", 1.0), ("none", None)):
        u = dict(bu) if cur is None else dict(
            bu, cur=np.full(bu["y"].shape, cur, np.float32))
        m = make_semi_step(cfg)(_state(), _tensors(bl), _tensors(u), 1e-3,
                                True)
        losses[tag] = float(m["unsup_loss"])
    assert losses["lo"] == 0.0
    assert losses["hi"] > 0 and losses["hi"] == losses["none"]


def test_trainer_passes_cur_when_the_dataset_has_it(tmp_path, monkeypatch):
    """A dataset whose unlabelled items carry ``cur``: the trainer's
    batches take it to the step (the keys ``semi_keys`` gives), and a
    dataset without it gives ``SEMI_KEYS`` alone."""
    real = tooth_semi.TeethSegSemiUDataset.__getitem__

    def with_cur(self, idx):
        item = real(self, idx)
        item["cur"] = np.linspace(-1, 1, len(item["y"]), dtype=np.float32)
        return item

    monkeypatch.setattr(tooth_semi.TeethSegSemiUDataset, "__getitem__",
                        with_cur)
    real_step = ttrain.make_semi_step
    seen = []

    def recording(cfg):
        step = real_step(cfg)

        def run(state, bl, bu, lr, use_teacher):
            seen.append(bu.get("cur"))
            return step(state, bl, bu, lr, use_teacher)
        return run

    monkeypatch.setattr(ttrain, "make_semi_step", recording)
    _run(tmp_path, "epochs=1", "val_freq=0", "test_freq=0",
         "criterion_u_args.NAME=Poly1FocalLoss_U_Cur")
    assert seen and all(c is not None and c.shape == (2, 256) for c in seen)
    assert semi_keys({"y": 0}) == SEMI_KEYS
    assert semi_keys({"cur": 0}) == SEMI_KEYS + ("cur",)
