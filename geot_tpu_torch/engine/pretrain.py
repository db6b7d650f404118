"""GeoT's pretraining stage, the multi-view generative pretraining of the
point encoder (``geot_tpu/engine/pretrain.py:44-214``):

    python -m geot_tpu_torch.engine.train --cfg cfgs/tooth_pretrain/viewgen.yaml

(the trainer dispatches here when ``model`` has ``generator_args``). It
trains a ``ViewGenBase`` (point encoder -> cross-attention view generator
-> convolutional decoder, foreground-weighted MSE against the renders of
``cfg.dataset``) with ``cfg.optimizer`` under ``cfg.sched`` (AdaHessian
refused: ``geot_tpu``'s pretraining step passes no Hessian diagonal, and
no ``step_per_update``, as there), validates the mean reconstruction
loss every ``val_freq`` epochs and at the last, and writes
``latest``, ``best`` (the lowest validation loss) and ``E<epoch>`` every
``save_freq`` through ``engine.checkpoint``. ``mode=resume`` continues
the run of ``pretrained_path`` (a checkpoint file) with its best loss.
The encoder trunk of such a checkpoint grafts into the flagship:
``pretrain_encoder_path=<checkpoint or run directory>`` on the flagship
recipe (``engine.checkpoint.load_pretrain_encoder``).

Data parallelism (``python -m geot_tpu_torch.engine.launch --nprocs N --
--cfg cfgs/tooth_pretrain/viewgen.yaml``; ``geot_tpu``'s dp mesh,
``engine/pretrain.py:119-171``): each rank loads ``batch_size / N`` rows of
every global train batch; BatchNorm takes the global batch's statistics
(SyncBN, ``models/layers/common.py``) and the step gathers the ranks'
sums of ``ViewGenBase.forward_sums``, so every rank holds the global
batch's loss;
the ranks' gradients are summed; validation scores the whole split on
every rank, and rank 0's value decides; only rank 0 writes scalars, logs
and checkpoints.
``GEOT_LOG_STEP_LOSS=1`` logs each step's loss at full precision, its
milliseconds and each rank's kernel launches in it.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable

import torch

from ..core.config import resolve_device
from ..core.logger import setup_logger_dist
from ..core.metrics import cal_model_parm_nums
from ..data.build import build_dataloader_from_cfg, to_device
from ..ops import LAUNCHES
from ..optim import build_scheduler_from_cfg, needs_hessian, set_learning_rate
from ..parallel import dist
from .checkpoint import load_checkpoint, save_checkpoint
from .state import TrainState
from .steps import _backward
from .train import _launches_by_rank
from .writer import SummaryWriter

BATCH_KEYS = ("pos", "x", "views", "imgs", "weight")


def pretrain_batch(batch: Dict[str, Any],
                   device: "str | torch.device") -> Dict[str, torch.Tensor]:
    """The entries of a collated batch that ``ViewGenBase`` reads, on
    ``device``."""
    return to_device(batch, [k for k in BATCH_KEYS if k in batch], device)


def make_pretrain_step(cfg: Dict[str, Any]) -> Callable:
    """``step(state, batch, lr) -> {"loss"}``: one update of a
    ``TrainState`` of a ``ViewGenBase`` in place (``pretrain.py:44-83``):
    the model's own loss in training mode (BatchNorm on batch statistics,
    which update the running ones; dropout and stochastic depth from the
    state's generator), over the global batch under data parallelism,
    gradients scaled by ``min(1, grad_norm_clip / (norm + 1e-6))`` of
    their global norm, then the optimizer at ``lr``. AdaHessian raises
    ``ValueError``: this step computes no Hessian diagonal."""
    if needs_hessian((cfg.get("optimizer") or {}).get("NAME", "adamw")):
        raise ValueError(
            f"optimizer.NAME={cfg['optimizer']['NAME']!r} needs the Hessian "
            f"diagonal, which the pretraining step does not compute (as in "
            f"geot_tpu/engine/pretrain.py:47-83)")
    clip = cfg.get("grad_norm_clip")

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             lr: float) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        sums, _ = model.forward_sums(batch, generator=state.generator)
        # the global batch's sums, and so its loss, on every rank
        loss = model.loss_of_sums(dist.gather(sums[None]).sum(0))
        state.opt.zero_grad(set_to_none=True)
        _backward(loss, [state.opt], state.generator)
        if clip is not None:
            torch.nn.utils.clip_grad_norm_(model.parameters(), float(clip))
        set_learning_rate(state.opt, lr)
        state.opt.step()
        state.step += 1
        return {"loss": loss.detach()}

    return step


def make_pretrain_eval_step() -> Callable:
    """``eval_step(model, batch) -> loss``: the model's loss in eval mode,
    without gradients."""

    def eval_step(model: torch.nn.Module,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            return model(batch)[0]

    return eval_step


def validate_pretrain(eval_step: Callable, model: torch.nn.Module,
                      loader: Iterable, device: "str | torch.device",
                      logger=None) -> float:
    """The mean of the batches' reconstruction losses over ``loader`` (the
    stage's quality signal: there are no labels), NaN for an empty one."""
    losses = [eval_step(model, pretrain_batch(b, device)) for b in loader]
    val = (float(torch.stack(losses).double().mean()) if losses
           else float("nan"))
    if logger is not None:
        logger.info(f"val: recon_loss={val:.6f}")
    return val


def main(cfg, device: "str | torch.device" = "cuda") -> Dict[str, Any]:
    """Pretrain ``cfg.model`` on ``device``; returns the last ``val_loss``
    and ``best`` (``loss``, ``epoch``)."""
    device = dist.rank_device(resolve_device(device))
    world, rank = dist.world(), dist.rank()
    setup_logger_dist(cfg.get("log_path"), rank)
    logger = logging.getLogger()
    writer = (SummaryWriter(cfg.run_dir) if cfg.get("run_dir")
              and dist.is_primary() else None)
    seed = int(cfg.get("seed", 0))
    tf = cfg.get("datatransforms")
    bs = int(cfg.get("batch_size", 2))
    # the train loader is sharded over the ranks, val is not
    train_loader = build_dataloader_from_cfg(bs, cfg.dataset, tf,
                                             split="train", seed=seed,
                                             num_shards=world,
                                             shard_index=rank,
                                             dataloader_cfg=cfg.get(
                                                 "dataloader"))
    val_loader = build_dataloader_from_cfg(
        int(cfg.get("batch_size_val", bs)), cfg.dataset, tf, split="val",
        seed=seed, dataloader_cfg=cfg.get("dataloader"))
    logger.info(f"datasets: train={len(train_loader.dataset)} "
                f"val={len(val_loader.dataset)}; device {device}"
                + (f"; rank {rank} of {world} ({dist.backend()})"
                   if world > 1 else ""))

    step = make_pretrain_step(cfg)
    # no step_per_update, as in geot_tpu's pretraining
    state = TrainState.create(dict(cfg, step_per_update=1), cfg.model,
                              seed=seed, device=device)
    logger.info(f"model params: "
                f"{cal_model_parm_nums(state.model) / 1e6:.3f} M")
    schedule = build_scheduler_from_cfg(cfg)
    eval_step = make_pretrain_eval_step()

    start_epoch = int(cfg.get("start_epoch", 1))
    best: Dict[str, Any] = {"loss": float("inf"), "epoch": 0}
    if cfg.get("mode") == "resume":
        path = cfg.get("pretrained_path")
        if not (path and os.path.isfile(str(path))):
            # never restart pretraining from scratch unasked
            raise FileNotFoundError(
                f"mode=resume requires pretrained_path pointing at a "
                f"checkpoint file; got {path!r}")
        ckpt_epoch, extra = load_checkpoint(str(path), state)
        start_epoch = ckpt_epoch + 1
        # the saved best, else the first validation after the resume
        # would replace a better best checkpoint
        best.update(extra)
        logger.info(f"resumed from {path} at epoch {ckpt_epoch} "
                    f"(best={best})")

    epochs = int(cfg.epochs)
    val_freq = int(cfg.get("val_freq", 10))
    step_log = bool(os.environ.get("GEOT_LOG_STEP_LOSS"))
    results: Dict[str, Any] = {}
    for epoch in range(start_epoch, epochs + 1):
        train_loader.set_epoch(epoch)
        lr = schedule(epoch)
        total, n, t0 = None, 0, time.time()
        for batch in train_loader:
            if step_log:
                before = dict(LAUNCHES)
                t_step = time.perf_counter()
            loss = step(state, pretrain_batch(batch, device), lr)["loss"]
            if step_log:
                # a host sync per step: the step's ms to it, and each
                # rank's kernel launches in it (the trainer's debug knob)
                logger.info(f"steploss {epoch}/{n + 1} {float(loss):.9f} "
                            f"ms {(time.perf_counter() - t_step) * 1e3:.3f}")
                logger.info(f"launches step {state.step} " + json.dumps(
                    _launches_by_rank(before, device)))
            # on the device: one fetch an epoch
            total = loss.double() if total is None else total + loss
            n += 1
        train_loss = float(total) / max(n, 1) if n else float("nan")
        logger.info(f"epoch {epoch}/{epochs} lr={lr:.6f} "
                    f"recon_loss={train_loss:.6f} "
                    f"({time.time() - t0:.1f}s)")
        if writer:
            writer.add_scalar("lr", lr, epoch)
            writer.add_scalar("train_loss", train_loss, epoch)
        if epoch % val_freq == 0 or epoch == epochs:
            val_loss = dist.broadcast_object(validate_pretrain(
                eval_step, state.model, val_loader, device, logger), device)
            results["val_loss"] = val_loss
            is_best = val_loss <= best["loss"]
            if is_best:
                best.update(loss=val_loss, epoch=epoch)
            if writer:
                writer.add_scalar("val_loss", val_loss, epoch)
            if cfg.get("ckpt_dir"):
                save_checkpoint(cfg, state, epoch, additional_dict=best,
                                is_best=is_best,
                                save_freq=cfg.get("save_freq"))
    results["best"] = best
    if writer:
        writer.close()
    return results


if __name__ == "__main__":
    from .train import parse_and_run

    parse_and_run()
    dist.shutdown()
