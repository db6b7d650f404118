"""The training entry point (``geot_tpu/engine/train.py``) for the flagship
recipe, on one device:

    python -m geot_tpu_torch.engine.train \\
        --cfg cfgs/tooth_semi/transformer_finetune_fixmatch_ntm.yaml [k=v ...]

``parse_and_run`` reads the config (``default.yaml`` files of the parent
directories first, then the named file, then the ``k=v`` overrides), makes
or reuses a run directory (``<root_dir>/<task>/<tags>-<stamp>-<uuid>/``
with ``checkpoint/``, the log, ``cfg.yaml``, ``scalars.jsonl`` and
``step_times.jsonl``) and calls ``main``. ``device=cpu`` on the command
line runs on the CPU; the default is the card, and without one it raises.

``main`` runs a mode:
- ``train``: bootstrap the class-mean matrix ``cm``, then per epoch the
  supervised step (epochs up to ``supervised_epochs``) or the semi step
  with the teacher's pseudo labels (up to ``switch_ep``) or the student's;
  validate every ``val_freq`` epochs and at the last one, checkpoint
  (``latest``, ``best``, ``E<epoch>`` every ``save_freq``), and every
  ``test_freq`` epochs and at the last one score the test split with the
  best checkpoint's weights;
- ``finetune``: the same from the weights of a port checkpoint
  (``pretrained_path``), teacher included;
- ``resume``: continue a run from its checkpoint, whole state restored;
- ``val`` / ``test``: score a checkpoint's weights on that split.

``model_t`` builds the teacher (the ``_fast.yaml`` recipe: a student in the
serving topology, an exact teacher); ``num_votes > 0`` adds test-time
voting over the config's ``vote`` pipeline to ``val`` / ``test`` and a
``test_voting`` pass after each test pass. A compute ``dtype`` other than
float32 is for serving and the eval modes; the training modes refuse it.

``ema_eval`` keeps an EMA shadow of the student: validation scores it and
the raw weights (``val_raw``), the better of the two is the candidate for
``best`` (``extra["ema_selected"]``), and the test pass reloads that tree
from the best checkpoint; ``use_ema`` picks the tree that ``val`` / ``test``
/ ``finetune`` load (``auto``: the run's own selection for the eval modes,
the raw weights for finetune). Steps skipped by ``skip_nonfinite_updates``
are counted per epoch (``skipped_steps``).

SIGTERM or SIGINT during training means: finish the epoch, checkpoint, stop
(a second one stops at once). Metrics accumulate on the device and are
fetched once an epoch. Switches whose branch the port lacks raise
``NotImplementedError`` naming the key.
"""
from __future__ import annotations

import argparse
import copy
import logging
import os
import signal
import time
from typing import Any, Callable, Dict, Iterable

import numpy as np
import torch

from ..core.config import (EasyConfig, build_model_from_cfg, dump_yaml,
                           resolve_device)
from ..core.logger import (generate_exp_directory, resume_exp_directory,
                           setup_logger_dist)
from ..core.metrics import AverageMeter, cal_model_parm_nums
from ..core.random import set_random_seed
from ..data.build import (MODEL_KEYS, build_dataloader_from_cfg,
                          semi_keys, semi_pairs, to_device)
from ..data.transforms import build_transforms_from_cfg
from ..optim import build_scheduler_from_cfg
from .checkpoint import (ckpt_path, load_checkpoint, load_variables,
                         save_checkpoint)
from .eval import validate
from .profiler import StepTimer
from .state import SemiTrainState
from .steps import (make_cm_step, make_confusion_step, make_eval_step,
                    make_semi_step, make_supervised_step)
from .writer import SummaryWriter

EVAL_MODES = ("val", "test", "eval", "testing", "evaluation")

# epoch scalars under the reference's tags (geot_tpu/engine/train.py:418-433)
# -> the step's metric
REF_TAGS = {"train_loss": "loss", "train_loss_l": "sup_loss",
            "train_loss_u": "unsup_loss", "th_percentage": "over_th",
            "train_over_th_acc": "pseudo_acc", "teacher_acc": "teacher_acc",
            "student_acc": "student_acc", "over_th_wobg": "over_th_wobg",
            "over_acc_wobg": "over_acc_wobg",
            "manifold_loss_feat": "feat_loss",
            "insT_identity_loss": "identity_loss",
            "insT_threed_loss": "threed_loss",
            "contrast_loss": "contrast_loss"}
CLS_TAGS = {"train_over_th_acc_class": "pseudo_acc_classwise",
            "train_over_th_num_class": "over_th_classwise",
            "train_over_th_recall_class": "over_th_recall_classwise"}

def cal_mean_feature(cm_step: Callable, model: torch.nn.Module,
                     loader: Iterable, num_classes: int,
                     device: "str | torch.device") -> torch.Tensor:
    """Class-conditional mean of the model's softmax over ``loader``: row c
    is the mean softmax of the points labelled c (``geot_tpu``'s fix of the
    reference's row-indexing bug). Sums accumulate in float64 on the host;
    returns (C, C) float32 on ``device``."""
    total = np.zeros((num_classes, num_classes), dtype=np.float64)
    counts = np.zeros((num_classes,), dtype=np.float64)
    for batch in loader:
        sums, cnts = cm_step(model, to_device(batch, MODEL_KEYS, device))
        total += sums.double().cpu().numpy()
        counts += cnts.double().cpu().numpy()
    cm = total / np.maximum(counts[:, None], 1.0)
    return torch.from_numpy(cm.astype(np.float32)).to(device)


def cal_confusion(confusion_step: Callable, model: torch.nn.Module,
                  loader: Iterable, num_classes: int,
                  device: "str | torch.device") -> torch.Tensor:
    """The hard-label confusion matrix over ``loader``, each row divided by
    its own sum + 0.001 (``geot_tpu/engine/train.py:130``, the
    ``cm_bootstrap: confusion`` initialiser of ``cm``); (C, C) float32 on
    ``device``."""
    total = np.zeros((num_classes, num_classes), dtype=np.float64)
    for batch in loader:
        total += confusion_step(model, to_device(batch, MODEL_KEYS, device)
                                ).double().cpu().numpy()
    cm = total / (total.sum(1, keepdims=True) + 0.001)
    return torch.from_numpy(cm.astype(np.float32)).to(device)


def refuse_unported(cfg) -> None:
    """Raise ``NotImplementedError`` naming the first switch of ``cfg``
    whose branch of ``geot_tpu``'s trainer the port lacks, or a compute
    ``dtype`` other than float32 in a training mode."""
    model = cfg.get("model") or {}
    model_t = cfg.get("model_t") or {}
    mode = str(cfg.get("mode") or "train")
    training = mode not in EVAL_MODES

    def reduced(m):
        dtype = (m.get("segmentor_args") or {}).get("dtype")
        return dtype not in (None, "float32")

    refused = {
        "model.segmentor_args.dtype": training and reduced(model),
        "model_t.segmentor_args.dtype": training and reduced(model_t),
        "profile_epoch": int(cfg.get("profile_epoch", 0) or 0) > 0,
        "wandb.use_wandb": bool((cfg.get("wandb") or {}).get("use_wandb")),
        "jax_distributed": bool(cfg.get("jax_distributed")),
        "distributed": cfg.get("distributed") is True,
        "tp": int(cfg.get("tp", 1) or 1) > 1,
        "sp": int(cfg.get("sp", 1) or 1) > 1,
        "fsdp": bool(cfg.get("fsdp")),
        "step_per_update": int(cfg.get("step_per_update", 1) or 1) > 1,
        "eval_device_cache": cfg.get("eval_device_cache", True) is False,
        "pretrain_encoder_path": bool(cfg.get("pretrain_encoder_path")),
        "mode": mode == "finetune_encoder",
        "task": cfg.get("task") in ("partseg", "cls"),
        "model.generator_args": "generator_args" in model,
        "model.NAME": model.get("NAME") != "WholePartSeg",
        "model_t.NAME": model_t.get("NAME", "WholePartSeg") != "WholePartSeg",
        "dataset_u": not ("dataset_u" in cfg and "criterion_u_args" in cfg),
    }
    on = [k for k, v in refused.items() if v]
    if on:
        raise NotImplementedError(
            f"not ported: {on[0]}={_get(cfg, on[0])!r} (the port trains "
            f"the semi-supervised WholePartSeg recipe in float32 on one "
            f"device)")


def _get(cfg, dotted: str):
    for key in dotted.split("."):
        cfg = (cfg or {}).get(key)
    return cfg


def _port_weights(path: str, prefer_ema) -> Dict[str, torch.Tensor]:
    """The student weights of a port checkpoint (the EMA shadow's as
    ``load_variables`` picks them); any other file (a reference torch
    ``.pth``) is refused."""
    try:
        return load_variables(path, prefer_ema)
    except (KeyError, TypeError) as e:
        raise NotImplementedError(
            f"not ported: pretrained_path={path!r} is not a checkpoint of "
            f"this package (importing a reference torch .pth is not "
            f"ported)") from e


class _Timed:
    """Iterate ``it``, adding the seconds spent waiting for each item to
    ``self.seconds``: the host's data time in the loop."""

    def __init__(self, it: Iterable):
        self.it = iter(it)
        self.seconds = 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t = time.perf_counter()
        try:
            return next(self.it)
        finally:
            self.seconds += time.perf_counter() - t


def main(cfg, device: "str | torch.device" = "cuda") -> Dict[str, Any]:
    """Run ``cfg``'s mode on ``device``; returns the last ``val`` and
    ``test`` metrics, ``best`` and, after a signal, ``preempted_at``."""
    device = resolve_device(device)
    refuse_unported(cfg)
    mode = str(cfg.get("mode") or "train")
    eval_only = mode in EVAL_MODES
    # built first: it refuses the step's unported switches
    semi_step = None if eval_only else make_semi_step(cfg)
    setup_logger_dist(cfg.get("log_path"))
    logger = logging.getLogger()
    seed = int(cfg.get("seed", 0))
    set_random_seed(seed)
    writer = SummaryWriter(cfg.run_dir) if cfg.get("run_dir") else None
    num_classes = int(cfg.num_classes)
    tf = cfg.get("datatransforms")
    num_votes = int(cfg.get("num_votes", 0) or 0)
    vote_t = build_transforms_from_cfg("vote", tf) if num_votes else None
    if num_votes and vote_t is None:
        raise ValueError(f"num_votes={num_votes} needs a vote transform "
                         f"pipeline (datatransforms.vote)")

    def loader(batch_size, ds_cfg, split):
        return build_dataloader_from_cfg(int(batch_size), ds_cfg, tf,
                                         split=split, seed=seed)

    val_loader = loader(cfg.get("batch_size_val", 2), cfg.dataset_l, "val")
    test_loader = loader(cfg.get("batch_size_test", 2), cfg.dataset_l, "test")
    train_loader_l = loader(cfg.get("batch_size_l", cfg.get("batch_size", 2)),
                            cfg.dataset_l, "train")
    train_loader_u = loader(cfg.get("batch_size_u", 2), cfg.dataset_u,
                            "train")
    logger.info(f"datasets: train_l={len(train_loader_l.dataset)} "
                f"val={len(val_loader.dataset)} "
                f"test={len(test_loader.dataset)} "
                f"train_u={len(train_loader_u.dataset)}; device {device}")
    eval_step = make_eval_step()

    pretrained = cfg.get("pretrained_path")
    weights = None
    if pretrained and mode != "resume":
        if not os.path.isfile(str(pretrained)):
            msg = f"pretrained_path={pretrained} is not a file"
            if eval_only or mode == "finetune":
                raise FileNotFoundError(msg)
            logger.warning(msg + " (and mode=train does not read it)")
        else:
            # use_ema (geot_tpu/engine/train.py:267-272): auto loads the
            # tree the source run selected for the eval modes, the raw
            # weights for finetune; true / false force it
            use_ema = cfg.get("use_ema", "auto")
            weights = _port_weights(str(pretrained), (
                ("auto" if eval_only else False) if use_ema == "auto"
                else bool(use_ema)))
            if mode == "train":
                logger.warning(f"pretrained_path={pretrained} was NOT "
                               f"loaded: mode=train ignores it; use "
                               f"mode=finetune or mode=resume")
                weights = None
    elif eval_only and not pretrained:
        raise ValueError(f"mode={mode} (eval-only) requires pretrained_path")

    if eval_only:
        split = "test" if mode in ("test", "testing") else "val"
        model = build_model_from_cfg(cfg.model)
        model.load_state_dict(weights, strict=True)
        model.to(device)
        res = validate(eval_step, model, test_loader if split == "test"
                       else val_loader, cfg, logger, num_votes=num_votes,
                       data_transform=vote_t, tag=split)
        if writer:
            for k, v in res.items():
                writer.add_scalar(f"{mode}_{k}", v, 0)
            writer.close()
        return {split: res}

    model_t = cfg.get("model_t")
    state = SemiTrainState.create(
        cfg, seg_args=dict(cfg.model.segmentor_args), seed=seed,
        device=device, teacher_args=(dict(model_t.segmentor_args)
                                     if model_t else None))
    if weights is not None:
        state.model.load_state_dict(weights, strict=True)
        state.teacher.load_state_dict(weights, strict=True)
        if state.ema_params:
            state.seed_ema()
        logger.info(f"loaded weights from {pretrained}")
    logger.info(f"model params: "
                f"{cal_model_parm_nums(state.model) / 1e6:.3f} M")
    # the warm-up trains the student without the shadow, as geot_tpu's
    # semi trainer, whose supervised phase steps a TrainState view that
    # has none (geot_tpu/engine/train.py:538-541)
    sup_step = make_supervised_step(dict(cfg, ema_eval=None))
    schedule = build_scheduler_from_cfg(cfg)
    supervised_epochs = int(cfg.get("supervised_epochs", 0))
    switch_ep = int(cfg.get("switch_ep", 0))
    epochs = int(cfg.epochs)
    best: Dict[str, Any] = {"miou": 0.0, "dsc": 0.0, "acc": 0.0, "epoch": 0}
    results: Dict[str, Any] = {}
    start_epoch = int(cfg.get("start_epoch", 1))

    resume_missing: list = []
    if mode == "resume":
        if not (pretrained and os.path.isfile(str(pretrained))):
            raise FileNotFoundError(
                f"mode=resume requires pretrained_path pointing at a "
                f"checkpoint file; got {pretrained!r}")
        ckpt_epoch, extra = load_checkpoint(str(pretrained), state,
                                            missing_fields=resume_missing)
        start_epoch = ckpt_epoch + 1
        best.update(extra)
        logger.info(f"resumed from {pretrained} at epoch {ckpt_epoch}")
        if state.ema_params and "ema_params" in resume_missing:
            # a checkpoint from before the shadow (or saved with it off):
            # seed it from the restored weights, not the fresh init
            state.seed_ema()
            logger.info("ema_eval: seeded EMA shadow from restored weights")

    # cm from the current weights: fresh for train, loaded for finetune,
    # restored for a resume whose checkpoint lacks it (a whole-state resume
    # keeps its cm, so it continues as the uninterrupted run would)
    if mode != "resume" or "cm" in resume_missing:
        if cfg.get("cm_bootstrap", "mean_feature") == "confusion":
            state.cm = cal_confusion(make_confusion_step(num_classes),
                                     state.model, train_loader_l,
                                     num_classes, device)
        else:
            state.cm = cal_mean_feature(make_cm_step(), state.model,
                                        train_loader_l, num_classes, device)

    timer = StepTimer(os.path.join(cfg.run_dir, "step_times.jsonl")
                      if cfg.get("run_dir") else None)
    print_freq = int(cfg.get("print_freq", 0) or 0)
    test_model = None

    preempted = {"sig": None}
    orig_handlers: Dict[int, Any] = {}

    def _restore_handlers():
        while orig_handlers:
            s, h = orig_handlers.popitem()
            signal.signal(s, h)

    def _on_preempt(signum, frame):
        preempted["sig"] = signum
        _restore_handlers()           # a second signal stops at once
        logger.warning(f"signal {signum}: will checkpoint and stop after "
                       f"the current epoch (repeat to force-exit)")

    try:
        for s in (signal.SIGTERM, signal.SIGINT):
            orig_handlers[s] = signal.signal(s, _on_preempt)
    except ValueError:
        pass                          # not the main thread

    try:
        for epoch in range(start_epoch, epochs + 1):
            train_loader_l.set_epoch(epoch)
            lr = schedule(epoch)
            sums: Dict[str, torch.Tensor] = {}
            n = 0
            t0 = time.time()
            if epoch > supervised_epochs:
                train_loader_u.set_epoch(epoch)
                use_teacher = epoch <= switch_ep
                batches = _Timed(semi_pairs(train_loader_l, train_loader_u))
                run = (lambda b: semi_step(
                    state, to_device(b[0], MODEL_KEYS, device),
                    to_device(b[1], semi_keys(b[1]), device), lr,
                    use_teacher))
            else:
                batches = _Timed(train_loader_l)
                run = (lambda b: sup_step(
                    state, to_device(b, MODEL_KEYS, device), lr))
            for batch in batches:
                metrics = run(batch)
                # on the device: a fetch per step would make the host wait
                # for every step
                sums = {k: sums[k] + v if k in sums else v.clone()
                        for k, v in metrics.items()}
                n += 1
                timer.tick(state.step, epoch=epoch)
                if print_freq and n % print_freq == 0:
                    logger.info(f"epoch {epoch} step {n} dispatched "
                                f"({time.time() - t0:.1f}s)")
            # the epoch's one fetch of its metrics
            keys = list(sums)
            flat = (torch.cat([sums[k].reshape(-1).double() for k in keys])
                    .cpu().numpy() if keys else np.zeros(0))
            ep_mean, at = {}, 0
            for k in keys:
                size = sums[k].numel()
                ep_mean[k] = flat[at:at + size].reshape(sums[k].shape) / n
                at += size
            wall = time.time() - t0
            meters = {k: AverageMeter() for k in ("loss", "sup_loss",
                                                  "unsup_loss")}
            for k in meters:
                meters[k].update(float(ep_mean.get(k, float("nan"))))
            logger.info(f"epoch {epoch}/{epochs} lr={lr:.6f} "
                        f"loss={meters['loss'].avg:.5f} "
                        f"sup={meters['sup_loss'].avg:.5f} "
                        f"unsup={meters['unsup_loss'].avg:.5f} "
                        f"({wall:.1f}s, data {batches.seconds:.1f}s)")
            n_skip = round(float(ep_mean.get("skipped", 0.0)) * n)
            if n_skip:
                logger.warning(f"epoch {epoch}: {n_skip}/{n} steps skipped "
                               f"(non-finite loss/gradients)")
                if writer:
                    writer.add_scalar("skipped_steps", n_skip, epoch)
            if writer:
                writer.add_scalar("lr", lr, epoch)
                writer.add_scalar("epoch_seconds", wall, epoch)
                writer.add_scalar("data_seconds", batches.seconds, epoch)
                for tag, key in REF_TAGS.items():
                    if key in ep_mean:
                        writer.add_scalar(tag, float(ep_mean[key]), epoch)
                for tag, key in CLS_TAGS.items():
                    if key in ep_mean:
                        for j, v in enumerate(np.ravel(ep_mean[key])):
                            writer.add_scalar(f"{tag}_{j}", float(v), epoch)

            # a frequency of 0 or None turns the periodic pass off; the
            # last epoch always runs it
            val_freq = int(cfg.get("val_freq", 250) or 0)
            if (val_freq and epoch % val_freq == 0) or epoch == epochs:
                ema_on = bool(state.ema_params)
                res = validate(eval_step, state.eval_model(), val_loader,
                               cfg, logger)
                results["val"] = res
                # the candidate for best: the better of the EMA and raw
                # weights (geot_tpu/engine/train.py:601-636)
                sel, sel_tree = res, ("ema" if ema_on else "raw")
                if ema_on:
                    res_raw = validate(eval_step, state.model, val_loader,
                                       cfg, logger, tag="val_raw")
                    results["val_raw"] = res_raw
                    if writer:
                        for k, v in res_raw.items():
                            writer.add_scalar(f"val_raw_{k}", v, epoch)
                    if res_raw["whole_miou"] > sel["whole_miou"]:
                        sel, sel_tree = res_raw, "raw"
                is_best = (sel["whole_miou"] >= best["miou"]
                           or np.isnan(best["miou"]))
                if is_best and not np.isnan(sel["whole_miou"]):
                    best.update(miou=sel["whole_miou"], dsc=sel["whole_dsc"],
                                acc=sel["whole_acc"], epoch=epoch,
                                ema_selected=float(sel_tree == "ema"))
                if writer:
                    for k, v in res.items():
                        writer.add_scalar(f"val_{k}", v, epoch)
                    for k in ("miou", "dsc", "acc"):
                        writer.add_scalar(f"val_{k}", res[f"whole_{k}"],
                                          epoch)
                    for k in ("miou", "dsc", "acc"):
                        writer.add_scalar(f"best_val_{k}", best[k], epoch)
                if cfg.get("ckpt_dir"):
                    save_checkpoint(cfg, state, epoch, additional_dict=best,
                                    is_best=is_best,
                                    save_freq=cfg.get("save_freq"))

            test_freq = int(cfg.get("test_freq", 250) or 0)
            if (test_freq and epoch % test_freq == 0) or epoch == epochs:
                # the best validated weights, as the reference reloads them
                # before a test pass, of the tree that won there
                # (ema_selected); the training state is left as it is
                model = state.eval_model()
                best_path = (ckpt_path(cfg["ckpt_dir"],
                                       cfg.get("run_name", "run"), "best")
                             if cfg.get("ckpt_dir") else None)
                if best_path and os.path.exists(best_path):
                    if test_model is None:
                        test_model = copy.deepcopy(state.model)
                    test_model.load_state_dict(load_variables(
                        best_path, bool(best.get("ema_selected", 0))))
                    model = test_model
                    logger.info(f"test on the best checkpoint (epoch "
                                f"{best['epoch']})")
                res = validate(eval_step, model, test_loader, cfg, logger,
                               tag="test")
                results["test"] = res
                if writer:
                    for k, v in res.items():
                        writer.add_scalar(f"test_{k}", v, epoch)
                if num_votes:
                    res_v = validate(eval_step, model, test_loader, cfg,
                                     logger, num_votes=num_votes,
                                     data_transform=vote_t,
                                     tag="test_voting")
                    results["test_voting"] = res_v
                    if writer:
                        for k, v in res_v.items():
                            writer.add_scalar(f"test_{k}_voting", v, epoch)

            if preempted["sig"] is not None:
                if cfg.get("ckpt_dir"):
                    save_checkpoint(cfg, state, epoch, additional_dict=best,
                                    is_best=False)
                logger.warning(f"preempted (signal {preempted['sig']}) at "
                               f"epoch {epoch}: checkpoint saved; continue "
                               f"with mode=resume")
                results["preempted_at"] = epoch
                break
    finally:
        _restore_handlers()
        timer.close()
    results["best"] = best
    if writer:
        writer.close()
    return results


def parse_and_run(argv=None) -> Dict[str, Any]:
    """``--cfg <yaml> [k=v | --k v ...]``: load, override, set up the run
    directory, write ``cfg.yaml`` and run ``main`` on ``cfg.device``
    (default ``cuda``)."""
    parser = argparse.ArgumentParser("geot_tpu_torch segmentation training")
    parser.add_argument("--cfg", type=str, required=True)
    args, opts = parser.parse_known_args(argv)
    cfg = EasyConfig()
    cfg.load(args.cfg, recursive=True)
    cfg.update(opts)
    if cfg.get("seed") is None:
        cfg.seed = int(np.random.randint(1, 10000))
    refuse_unported(cfg)

    path = os.path.abspath(args.cfg)
    cfg.task_name = os.path.basename(os.path.dirname(path))
    cfg.cfg_basename = os.path.splitext(os.path.basename(path))[0]
    mode = cfg.get("mode", "train")
    tags = [cfg.task_name, mode, cfg.cfg_basename, f"seed{cfg.seed}"]
    cfg.root_dir = os.path.join(cfg.get("root_dir", "./log"), cfg.task_name)
    if cfg.get("run_dir"):
        cfg.run_name = cfg.get("run_name") or "-".join(tags)
        cfg.ckpt_dir = cfg.get("ckpt_dir") or os.path.join(cfg.run_dir,
                                                           "checkpoint")
        os.makedirs(cfg.ckpt_dir, exist_ok=True)
    elif mode == "resume" or mode in EVAL_MODES:
        resume_exp_directory(cfg, pretrained_path=cfg.get("pretrained_path"))
    else:
        generate_exp_directory(cfg, tags)
    # an evaluation in the run's directory keeps the run's cfg.yaml
    cfg_name = "cfg.yaml"
    if mode in EVAL_MODES and os.path.exists(os.path.join(cfg.run_dir,
                                                          "cfg.yaml")):
        cfg_name = f"cfg_{mode}.yaml"
    with open(os.path.join(cfg.run_dir, cfg_name), "w") as f:
        f.write(dump_yaml(cfg.dict()))
    return main(cfg, device=cfg.get("device", "cuda"))


if __name__ == "__main__":
    parse_and_run()
