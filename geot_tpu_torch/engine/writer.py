"""Scalar logging and the run's tracker (``geot_tpu/engine/writer.py``).

``SummaryWriter`` writes one ``{"tag", "value", "step", "ts"}`` JSON line
per scalar in ``<run_dir>/scalars.jsonl``, and TensorBoard event files
under ``<run_dir>/tb`` when ``torch.utils.tensorboard`` imports.

``Wandb`` is the facade of ``wandb.use_wandb`` (``writer.py:71-101``):
the real ``wandb`` when it imports and its ``init`` succeeds, a no-op
otherwise. The run's config carries the experiment's config, ``run_path``
and the code's git sha and diff (``git_state``), and the config's YAML in
the run directory is saved as a run file.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Dict, Optional


def _make_tb(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter as TBWriter
    except ImportError:
        return None
    return TBWriter(log_dir=os.path.join(log_dir, "tb"))


class SummaryWriter:
    def __init__(self, log_dir: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a",
                       buffering=1)
        self._tb = _make_tb(log_dir) if tensorboard else None

    def add_scalar(self, tag: str, value, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step), "ts": time.time()})
                      + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def git_state(cwd: Optional[str] = None) -> Dict[str, str]:
    """``{"commit", "gitdiff"}`` of the code in ``cwd``: the sha of
    ``HEAD`` and the working tree's diff, or ``"n/a"`` and ``""`` outside
    a git checkout (``writer.py:52-66``)."""
    try:
        sha = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=cwd,
            stderr=subprocess.DEVNULL).decode("ascii").strip()
        diff = subprocess.check_output(
            ["git", "diff"], cwd=cwd, stderr=subprocess.DEVNULL).decode()
    except Exception:  # noqa: BLE001 - no git, or not a checkout
        sha, diff = "n/a", ""
    return {"commit": sha, "gitdiff": diff}


class Wandb:
    """The tracker facade: ``launch(cfg, use_wandb)`` starts a run of the
    real ``wandb`` (project ``cfg.wandb.project``, default ``geot_tpu``;
    name ``cfg.run_name``; ``resume="allow"``, ``sync_tensorboard``) and
    saves ``<run_dir>/cfg.yaml`` as a run file; without ``wandb``, or if
    it fails, ``run`` stays None and ``log`` does nothing."""

    run = None

    @classmethod
    def launch(cls, cfg, use_wandb: bool = False):
        if not use_wandb:
            return None
        config = {**dict(cfg), "run_path": os.getcwd(),
                  **git_state(os.path.dirname(os.path.abspath(__file__)))}
        try:
            import wandb

            cls.run = wandb.init(
                project=(cfg.get("wandb") or {}).get("project", "geot_tpu"),
                name=cfg.get("run_name"), config=config, resume="allow",
                sync_tensorboard=True)
            cfg_yaml = (os.path.join(cfg["run_dir"], "cfg.yaml")
                        if cfg.get("run_dir") else None)
            if cfg_yaml and os.path.exists(cfg_yaml):
                wandb.save(cfg_yaml)
        except Exception:  # noqa: BLE001 - the tracker never stops a run
            cls.run = None
        return cls.run

    @classmethod
    def log(cls, data: Dict[str, Any], step: Optional[int] = None):
        if cls.run is not None:
            cls.run.log(data, step=step)
