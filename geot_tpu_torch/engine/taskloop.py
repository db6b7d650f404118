"""The supervised loop of the heritage tasks (``geot_tpu/engine/
taskloop.py:30-146``): classification (``engine.cls``) and part
segmentation (``engine.partseg``) differ only in the keys of their batches
and their evaluation protocol; loaders, the train state, the optimizer and
schedule, resume, the epoch loop and checkpoints are this one loop over the
trainer's pieces (``TrainState``, ``make_supervised_step``,
``make_eval_step``, ``save_checkpoint``).

``mode``: ``train`` (or ``finetune``, the same here, as in ``geot_tpu``)
trains ``cfg.epochs`` epochs, validates every ``val_freq`` epochs and at
the last one, and writes ``latest`` (and ``best``, by the ``primary``
metric, and ``E<epoch>`` every ``save_freq``) under ``cfg.ckpt_dir``;
``resume`` continues a checkpoint's run, whole state and ``best``
restored; ``val`` / ``test`` / ``eval`` / ``testing`` / ``evaluation``
score the weights of ``pretrained_path`` on the validation split and
refuse without one. The training split is ``dataset.train_split`` (a
training split whatever its name: shuffled, its tail dropped, the train
transforms), the validation split ``dataset.val_split``.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, Sequence

import torch

from ..core.config import resolve_device
from ..core.logger import setup_logger_dist
from ..core.metrics import cal_model_parm_nums
from ..core.random import set_random_seed
from ..data.build import build_dataloader_from_cfg
from ..optim import build_scheduler_from_cfg
from ..parallel import dist
from .checkpoint import load_checkpoint, load_variables, save_checkpoint
from .state import TrainState
from .steps import make_eval_step, make_supervised_step
from .writer import SummaryWriter


def run(cfg, *, task: str, batch_fn: Callable, evaluate_fn: Callable,
        primary: str, metric_names: Sequence[str],
        default_train_split: str = "train",
        default_val_split: str = "test",
        device: "str | torch.device" = "cuda") -> Dict[str, Any]:
    """Train (or score) one supervised task on ``device``.

    ``batch_fn(batch, device)`` gives a step's tensors of a collated batch;
    ``evaluate_fn(eval_step, model, loader, cfg, device) -> dict`` scores a
    split; ``primary`` selects the best checkpoint; ``metric_names`` are
    logged and written per validation. Returns the metrics in an eval
    mode, else ``{"best": best}``."""
    device = resolve_device(device)
    if dist.world() > 1:
        raise NotImplementedError(f"{task}: data parallel training of the "
                                  f"heritage tasks is not ported")
    setup_logger_dist(cfg.get("log_path"), dist.rank())
    logger = logging.getLogger()
    seed = int(cfg.get("seed", 0))
    set_random_seed(seed)
    run_dir = cfg.get("run_dir")
    writer = SummaryWriter(run_dir) if run_dir else None
    ds = cfg.dataset
    tf = cfg.get("datatransforms")
    train_loader = build_dataloader_from_cfg(
        int(cfg.get("batch_size", 8)), ds, tf,
        split=ds.get("train_split", default_train_split), seed=seed,
        dataloader_cfg=cfg.get("dataloader"), is_train=True, device=device)
    val_loader = build_dataloader_from_cfg(
        int(cfg.get("batch_size_val", cfg.get("batch_size", 8))), ds, tf,
        split=ds.get("val_split", default_val_split),
        dataloader_cfg=cfg.get("dataloader"), is_train=False, device=device)
    logger.info(f"{task} datasets: train={len(train_loader.dataset)} "
                f"val={len(val_loader.dataset)}; device {device}")

    state = TrainState.create(cfg, cfg.model, seed=seed, device=device)
    logger.info(f"model params: "
                f"{cal_model_parm_nums(state.model) / 1e6:.3f} M")
    eval_step = make_eval_step()

    from .train import EVAL_MODES

    mode = str(cfg.get("mode") or "train")
    if mode in EVAL_MODES:
        pretrained = cfg.get("pretrained_path")
        if not pretrained:
            # random weights would score as if trained
            raise FileNotFoundError(
                f"mode={mode} requires pretrained_path pointing at a "
                f"checkpoint; got {pretrained!r}")
        state.model.load_state_dict(load_variables(str(pretrained)),
                                    strict=True)
        metrics = evaluate_fn(eval_step, state.model, val_loader, cfg,
                              device)
        logger.info("eval: " + " ".join(f"{k} {metrics[k]:.2f}"
                                        for k in metric_names))
        if writer:
            for k in metric_names:
                writer.add_scalar(f"{mode}_{k}", metrics[k], 0)
            writer.close()
        return metrics

    train_step = make_supervised_step(cfg)
    schedule = build_scheduler_from_cfg(cfg)
    val_freq = int(cfg.get("val_freq", 1) or 1)
    epochs = int(cfg.epochs)
    best: Dict[str, Any] = {k: 0.0 for k in metric_names}
    best["epoch"] = 0
    start_epoch = 1
    if mode == "resume":
        pretrained = cfg.get("pretrained_path")
        if not (pretrained and os.path.isfile(str(pretrained))):
            raise FileNotFoundError(
                f"mode=resume requires pretrained_path pointing at a "
                f"checkpoint file; got {pretrained!r}")
        ckpt_epoch, extra = load_checkpoint(str(pretrained), state)
        start_epoch = ckpt_epoch + 1
        best.update(extra.get("best", {}))
        logger.info(f"resumed from {pretrained} at epoch {ckpt_epoch}")

    for epoch in range(start_epoch, epochs + 1):
        train_loader.set_epoch(epoch)
        lr = schedule(epoch)
        loss_sum, nb, t0 = None, 0, time.time()
        for batch in train_loader:
            m = train_step(state, batch_fn(batch, device), lr)
            # summed on the device: the epoch's one fetch is below
            loss_sum = m["loss"] if loss_sum is None else loss_sum + m["loss"]
            nb += 1
        loss = float(loss_sum) / max(nb, 1) if nb else float("nan")
        logger.info(f"epoch {epoch} loss {loss:.4f} lr {lr:.2e} "
                    f"({time.time() - t0:.1f}s)")
        if writer:
            writer.add_scalar("train/loss", loss, epoch)
            writer.add_scalar("train/lr", lr, epoch)
            writer.add_scalar("epoch_seconds", time.time() - t0, epoch)
        if epoch % val_freq == 0 or epoch == epochs:
            m = evaluate_fn(eval_step, state.eval_model(), val_loader, cfg,
                            device)
            is_best = m[primary] > best[primary]
            if is_best:
                best = {**m, "epoch": epoch}
            logger.info(f"epoch {epoch} val " + " ".join(
                f"{k} {m[k]:.2f}" for k in metric_names)
                + (" (best)" if is_best else ""))
            if writer:
                for k in metric_names:
                    writer.add_scalar(f"val/{k}", m[k], epoch)
            if cfg.get("ckpt_dir"):
                save_checkpoint(cfg, state, epoch,
                                additional_dict={"best": best},
                                is_best=is_best,
                                save_freq=cfg.get("save_freq"))
    logger.info("best: " + " ".join(f"{k} {best[k]:.2f}"
                                    for k in metric_names)
                + f" (epoch {best['epoch']})")
    if writer:
        writer.close()
    return {"best": best}
