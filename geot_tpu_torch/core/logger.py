"""Run directories and logging (``geot_tpu/core/logger.py:13-69``): a run
lives in ``root_dir/<tags>-<stamp>-<uuid>/`` with its ``checkpoint/``
directory and ``<run_name>.log``."""
from __future__ import annotations

import logging
import os
import sys
import time
import uuid
from pathlib import Path
from typing import Optional


def setup_logger_dist(log_path: Optional[str] = None, rank: int = 0,
                      name: str = "geot"):
    """Rank 0 logs INFO to stdout and, given a path, to that file; other
    ranks log warnings only. The handlers are the root logger's whatever
    ``name``, which is taken and unused, as in ``geot_tpu``."""
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    root.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(filename)s:%(lineno)d] %(message)s",
        datefmt="%m/%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    root.addHandler(sh)
    if log_path and rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        fh = logging.FileHandler(log_path)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    return root


def generate_exp_directory(cfg, tags=None, additional_id=None) -> str:
    """Create ``run_dir = root_dir/<tags joined by '-'>-<stamp>-<uuid>``
    (``-<additional_id>`` after it, given one) and its ``checkpoint/``;
    set ``run_name``, ``run_dir``, ``ckpt_dir``, ``log_dir`` and
    ``log_path`` in ``cfg``."""
    tags = tags or ["exp"]
    run_name = "-".join(str(t) for t in tags if str(t))
    run_name = (f"{run_name}-{time.strftime('%Y%m%d-%H%M%S')}-"
                f"{uuid.uuid4().hex[:8]}")
    if additional_id is not None:
        run_name += f"-{additional_id}"
    cfg.run_name = run_name
    cfg.run_dir = os.path.join(cfg.get("root_dir", "./log"), run_name)
    cfg.ckpt_dir = os.path.join(cfg.run_dir, "checkpoint")
    cfg.log_dir = cfg.run_dir
    cfg.log_path = os.path.join(cfg.run_dir, f"{run_name}.log")
    Path(cfg.ckpt_dir).mkdir(parents=True, exist_ok=True)
    return cfg.run_dir


def resume_exp_directory(cfg, pretrained_path: Optional[str] = None) -> str:
    """The run directory of an existing checkpoint
    (``<run_dir>/checkpoint/<file>``), so a resumed or evaluated run writes
    beside the run it continues; a fresh one when the path does not
    exist. The log file is ``<run_name>-<mode>.log``."""
    if pretrained_path and os.path.exists(pretrained_path):
        ckpt_dir = os.path.dirname(os.path.abspath(pretrained_path))
        cfg.run_dir = os.path.dirname(ckpt_dir)
        cfg.ckpt_dir = ckpt_dir
        cfg.run_name = os.path.basename(cfg.run_dir)
    else:
        generate_exp_directory(cfg, tags=[cfg.get("mode", "resume")])
    cfg.log_dir = cfg.run_dir
    cfg.log_path = os.path.join(
        cfg.run_dir, f"{cfg.run_name}-{cfg.get('mode', 'resume')}.log")
    Path(cfg.run_dir).mkdir(parents=True, exist_ok=True)
    return cfg.run_dir
