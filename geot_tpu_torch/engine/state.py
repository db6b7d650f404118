"""The semi-supervised train state (``geot_tpu/engine/state.py:63-124``).

``geot_tpu`` threads one immutable pytree through a jitted step; here the
state is a set of modules and tensors that the step updates in place: the
student, the frozen teacher (built from its own arguments, ``model_t``, and
given the initial student's weights, as in ``geot_tpu``, where
``steps.py`` never replaces it), the T-predictor, an
AdamW optimizer for each of student and T-predictor, the NTM matrix
``ema_t`` and the class-mean matrix ``cm`` (both identity at creation), the
step counter and the ``torch.Generator`` that draws the dropout and
stochastic-depth masks. The contrastive memory bank and the EMA shadow of
the weights for evaluation are not ported: the flagship has both off.

``state_dict`` / ``load_state_dict`` carry the whole state, for
checkpoints: a restored run continues exactly where the saved one was.
"""
from __future__ import annotations

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
               device: "str | torch.device" = "cuda",
               teacher_args: Optional[Dict[str, Any]] = None
               ) -> "SemiTrainState":
        """Student ``WholePartSeg(seg_args)`` (the flagship by default) and
        the T-predictor of ``cfg`` with weights drawn from ``seed``; the
        teacher ``WholePartSeg(teacher_args)`` (the student's arguments by
        default: ``geot_tpu/engine/train.py:335`` builds ``model_t`` or
        else ``model``) with the student's initial weights, whose names do
        not depend on the topology; the masks' generator seeded with
        ``seed``; all on ``device``."""
        device = resolve_device(device)
        seg_args = seg_args or FLAGSHIP_SEG_ARGS
        model = build_model_from_cfg({"NAME": "WholePartSeg",
                                      "segmentor_args": seg_args})
        init_weights(model, torch.Generator().manual_seed(seed))
        t_predictor = build_model_from_cfg(cfg["t_predictor"])
        init_weights(t_predictor, torch.Generator().manual_seed(seed + 2))
        model, t_predictor = model.to(device), t_predictor.to(device)
        teacher = build_model_from_cfg({"NAME": "WholePartSeg",
                                        "segmentor_args": teacher_args or
                                        seg_args}).to(device)
        teacher.load_state_dict(model.state_dict())
        teacher.eval().requires_grad_(False)
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
        device and dtype it has in the state. Converted from a full-state
        checkpoint, the dict also holds both optimizers' moments by
        parameter name (``opt``, ``t_opt``: ``{"step", "exp_avg",
        "exp_avg_sq"}``) and ``step``, which are taken too."""
        self.model.load_state_dict(tensors["model"], strict=True)
        self.teacher.load_state_dict(tensors["teacher"], strict=True)
        self.t_predictor.load_state_dict(tensors["t_predictor"], strict=True)
        self.ema_t = tensors["ema_t"].to(self.ema_t)
        self.cm = tensors["cm"].to(self.cm)
        for key, opt, module in (("opt", self.opt, self.model),
                                 ("t_opt", self.t_opt, self.t_predictor)):
            if key in tensors:
                _load_moments(opt, module, tensors[key])
        if "step" in tensors:
            self.step = int(tensors["step"])
        return self

    def state_dict(self) -> Dict[str, Any]:
        """Everything a step reads or updates: the three modules' weights
        and buffers, both AdamW states, ``ema_t``, ``cm``, the mask
        generator's state and ``step``."""
        return {"model": self.model.state_dict(),
                "teacher": self.teacher.state_dict(),
                "t_predictor": self.t_predictor.state_dict(),
                "opt": self.opt.state_dict(),
                "t_opt": self.t_opt.state_dict(),
                "ema_t": self.ema_t, "cm": self.cm,
                "generator": self.generator.get_state(),
                "step": int(self.step)}

    def load_state_dict(self, sd: Dict[str, Any]) -> "SemiTrainState":
        """Restore ``state_dict()``'s output onto this state's devices. The
        teacher is the saved teacher."""
        self.model.load_state_dict(sd["model"], strict=True)
        self.teacher.load_state_dict(sd["teacher"], strict=True)
        self.t_predictor.load_state_dict(sd["t_predictor"], strict=True)
        self.opt.load_state_dict(sd["opt"])
        self.t_opt.load_state_dict(sd["t_opt"])
        self.ema_t = sd["ema_t"].to(self.ema_t)
        self.cm = sd["cm"].to(self.cm)
        self.generator.set_state(sd["generator"].cpu())
        self.step = int(sd["step"])
        return self


def _load_moments(opt: torch.optim.Optimizer, module: torch.nn.Module,
                  moments: Dict[str, Any]) -> None:
    """Set AdamW's per-parameter state from moments keyed by parameter
    name; every trainable parameter must have both."""
    names = {id(p): n for n, p in module.named_parameters()}
    for group in opt.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            if name not in moments["exp_avg"]:
                raise KeyError(f"no optimizer moments for {name!r}")
            opt.state[p] = {
                "step": torch.tensor(float(moments["step"])),
                "exp_avg": moments["exp_avg"][name].to(p),
                "exp_avg_sq": moments["exp_avg_sq"][name].to(p)}
