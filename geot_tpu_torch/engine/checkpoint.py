"""Checkpoints of the train state (``geot_tpu/engine/checkpoint.py:19-224,
355-404``).

A checkpoint is one ``torch.save`` file,
``<ckpt_dir>/<run_name>_ckpt_<tag>.pth``, holding ``{"state":
state.state_dict(), "epoch", "extra"}`` of a ``TrainState`` or a
``SemiTrainState``: ``latest`` after every save, ``best`` when the save is
the best so far, ``E<epoch>`` every ``save_freq`` epochs. Each file is written beside itself as ``.tmp`` and
swapped in with ``os.replace``, so a kill during a save leaves the previous
file whole. Files are read with ``torch.load(weights_only=True)``.
"""
from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from .state import SemiTrainState, TrainState


def ckpt_path(ckpt_dir: str, run_name: str, tag: str) -> str:
    return os.path.join(os.path.abspath(ckpt_dir),
                        f"{run_name}_ckpt_{tag}.pth")


def _write(payload: Dict[str, Any], dst: str) -> None:
    tmp = dst + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, dst)


def _copy(src: str, dst: str) -> None:
    tmp = dst + ".tmp"
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def save_checkpoint(cfg, state: "TrainState | SemiTrainState",
                    epoch: int,
                    additional_dict: Optional[Dict[str, Any]] = None,
                    is_best: bool = False,
                    save_freq: Optional[int] = None) -> str:
    """Write ``latest`` (and ``best``, and the ``E<epoch>`` milestone when
    ``epoch % save_freq == 0``) under ``cfg["ckpt_dir"]``; returns the
    path of ``latest``."""
    ckpt_dir = cfg["ckpt_dir"]
    run_name = cfg.get("run_name", "run")
    os.makedirs(ckpt_dir, exist_ok=True)
    latest = ckpt_path(ckpt_dir, run_name, "latest")
    _write({"state": state.state_dict(), "epoch": int(epoch),
            "extra": dict(additional_dict or {})}, latest)
    if is_best:
        _copy(latest, ckpt_path(ckpt_dir, run_name, "best"))
    if save_freq and epoch % save_freq == 0:
        mile = ckpt_path(ckpt_dir, run_name, f"E{epoch}")
        if not os.path.exists(mile):
            _copy(latest, mile)
    return latest


def _read(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(path: str, state: "TrainState | SemiTrainState",
                    missing_fields: Optional[List[str]] = None
                    ) -> Tuple[int, Dict[str, Any]]:
    """Restore ``state`` in place from a checkpoint written by
    ``save_checkpoint``; returns ``(epoch, extra)``.

    A partial checkpoint (say, weights only) restores what it holds: the
    absent top-level fields keep the state's fresh values, are logged, and
    are appended to ``missing_fields``, so the caller can re-derive them
    (the trainer bootstraps ``cm`` again). A missing teacher is seeded from
    the restored student. Model weights themselves must be complete: a
    partial ``model`` raises."""
    payload = _read(path)
    saved = dict(payload["state"])
    full = state.state_dict()
    # the EMA shadow may be empty on either side: empty in the checkpoint
    # and kept by the run counts as missing (the caller seeds it from the
    # restored weights); saved but not kept by the run is dropped
    if "ema_params" in saved:
        if not full["ema_params"]:
            saved["ema_params"] = {}
        elif not saved["ema_params"]:
            del saved["ema_params"]
    missing = [k for k in full if k not in saved]
    if missing_fields is not None:
        missing_fields.extend(missing)
    if "model" in saved:
        gaps = sorted(set(full["model"]) - set(saved["model"]))
        if gaps:
            raise ValueError(f"checkpoint {path} is missing model-weight "
                             f"entries {gaps[:5]}"
                             f"{'...' if len(gaps) > 5 else ''}: refusing a "
                             f"partial weight restore")
    if missing:
        seeded = []
        if "teacher" in missing and "model" in saved:
            saved["teacher"] = saved["model"]
            seeded.append("teacher")
        logging.getLogger(__name__).warning(
            f"partial checkpoint {os.path.basename(path)}: fields {missing} "
            f"absent; kept fresh values"
            + (f"; seeded {seeded} from the restored student" if seeded
               else ""))
        full.update(saved)
        saved = full
    state.load_state_dict(saved)
    return int(payload.get("epoch", 0)), dict(payload.get("extra", {}))


def variables_of(payload: Dict[str, Any],
                 prefer_ema: "bool | str" = "auto") -> Dict[str, torch.Tensor]:
    """The student's ``state_dict`` of a loaded checkpoint, its weights
    replaced by the EMA shadow's when ``prefer_ema`` and the checkpoint
    has one; ``"auto"`` takes the tree that the run's best-val selection
    recorded (``extra["ema_selected"]``), the shadow when there is no
    record (``geot_tpu/engine/checkpoint.py:374``)."""
    st = payload["state"]
    if prefer_ema == "auto":
        rec = (payload.get("extra") or {}).get("ema_selected")
        prefer_ema = True if rec is None else bool(rec)
    out = dict(st["model"])
    if prefer_ema and st.get("ema_params"):
        out.update(st["ema_params"])
    return out


def load_variables(path: str, prefer_ema: "bool | str" = "auto"
                   ) -> Dict[str, torch.Tensor]:
    """The student's ``state_dict`` (weights and BatchNorm statistics) of a
    checkpoint, on the CPU, without building a train state; the weights
    are the EMA shadow's as ``variables_of`` picks them."""
    return variables_of(_read(path), prefer_ema)


def discover_checkpoint(run_dir: str, prefer: str = "best") -> str:
    """The checkpoint in ``<run_dir>/checkpoint`` to use: ``*_ckpt_<prefer>``,
    else ``*_ckpt_latest``, else the newest other file by mtime (a
    milestone ``E100`` must not win over ``latest`` by its name)."""
    ckdir = os.path.join(run_dir, "checkpoint")
    entries = [f for f in os.listdir(ckdir) if f.endswith(".pth")
               and os.path.isfile(os.path.join(ckdir, f))]
    cands = ([f for f in entries if f.endswith(f"_ckpt_{prefer}.pth")]
             or [f for f in entries if f.endswith("_ckpt_latest.pth")]
             or sorted(entries, key=lambda f: os.path.getmtime(
                 os.path.join(ckdir, f)), reverse=True))
    if not cands:
        raise FileNotFoundError(f"no checkpoints under {ckdir}")
    return os.path.join(ckdir, cands[0])
