"""The semi-supervised train state (``geot_tpu/engine/state.py:63-124``).

``geot_tpu`` threads one immutable pytree through a jitted step; here the
state is a set of modules and tensors that the step updates in place: the
student, the frozen teacher (a copy of the initial student, as in
``geot_tpu``, where ``steps.py`` never replaces it), the T-predictor, an
AdamW optimizer for each of student and T-predictor, the NTM matrix
``ema_t`` and the class-mean matrix ``cm`` (both identity at creation), the
step counter and the ``torch.Generator`` that draws the dropout and
stochastic-depth masks. The contrastive memory bank and the EMA shadow of
the weights for evaluation are not ported: the flagship has both off.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..core.config import (FLAGSHIP_SEG_ARGS, build_model_from_cfg,
                           resolve_device)
from ..models.segmentation.base_seg import init_weights
from ..optim import build_optimizer_from_cfg


@dataclass
class SemiTrainState:
    model: torch.nn.Module
    teacher: torch.nn.Module
    t_predictor: torch.nn.Module
    opt: torch.optim.Optimizer
    t_opt: torch.optim.Optimizer
    ema_t: torch.Tensor
    cm: torch.Tensor
    generator: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, cfg: Dict[str, Any],
               seg_args: Optional[Dict[str, Any]] = None, seed: int = 0,
               device: "str | torch.device" = "cuda") -> "SemiTrainState":
        """Student ``WholePartSeg(seg_args)`` (the flagship by default) and
        the T-predictor of ``cfg`` with weights drawn from ``seed``, the
        teacher a copy of the student, and the masks' generator seeded with
        ``seed``, all on ``device``."""
        device = resolve_device(device)
        model = build_model_from_cfg({"NAME": "WholePartSeg",
                                      "segmentor_args": seg_args or
                                      FLAGSHIP_SEG_ARGS})
        init_weights(model, torch.Generator().manual_seed(seed))
        t_predictor = build_model_from_cfg(cfg["t_predictor"])
        init_weights(t_predictor, torch.Generator().manual_seed(seed + 2))
        model, t_predictor = model.to(device), t_predictor.to(device)
        teacher = copy.deepcopy(model).eval().requires_grad_(False)
        opt_cfg = dict(cfg["optimizer"])
        C = int(cfg["num_classes"])
        eye = torch.eye(C, device=device)
        return cls(
            model=model, teacher=teacher, t_predictor=t_predictor,
            opt=build_optimizer_from_cfg(model, float(cfg["lr"]), **opt_cfg),
            t_opt=build_optimizer_from_cfg(t_predictor, float(cfg["lr"]),
                                           **opt_cfg),
            ema_t=eye.clone(), cm=eye.clone(),
            generator=torch.Generator(device=device).manual_seed(seed))

    def load(self, tensors: Dict[str, Any]) -> "SemiTrainState":
        """Take weights and matrices from a dict with the keys of
        ``engine.convert.semi_state_from_jax``: ``model``, ``teacher`` and
        ``t_predictor`` state_dicts, ``ema_t`` and ``cm``; each keeps the
        device and dtype it has in the state."""
        self.model.load_state_dict(tensors["model"], strict=True)
        self.teacher.load_state_dict(tensors["teacher"], strict=True)
        self.t_predictor.load_state_dict(tensors["t_predictor"], strict=True)
        self.ema_t = tensors["ema_t"].to(self.ema_t)
        self.cm = tensors["cm"].to(self.cm)
        return self
