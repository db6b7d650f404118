"""The train states: ``TrainState``, the supervised one
(``geot_tpu/engine/state.py:29-60``), and ``SemiTrainState``, the
semi-supervised one (``:63-124``).

``TrainState`` holds the model, its optimizer, the step counter, the
``torch.Generator`` of the dropout and stochastic-depth masks and, under
``ema_eval``, the EMA shadow ``ema_params`` with its evaluation view
``eval_model()``; ``state_dict`` / ``load_state_dict`` carry all of it.

``geot_tpu`` threads one immutable pytree through a jitted step; here a
state is a set of modules and tensors that the step updates in place.
``SemiTrainState`` holds the student, the frozen teacher (built from its
own arguments, ``model_t``, and given the initial student's weights, as in
``geot_tpu``, where ``steps.py`` never replaces it), the T-predictor, an
optimizer for each of student and T-predictor (``cfg.optimizer``; the
student's accumulates ``step_per_update`` gradients an update, the
T-predictor's updates every step, as in ``geot_tpu``), the NTM matrix
``ema_t`` and the class-mean matrix ``cm`` (both identity at creation), the
step counter, the ``torch.Generator`` that draws the dropout and
stochastic-depth masks (and the contrast and anchor draws), the
contrastive memory bank ``contrast`` (``trans_dim`` wide, 4096 rows) and,
under ``ema_eval``, ``ema_params``: the EMA shadow of the student's
parameters, empty when the switch is off (``geot_tpu/engine/state.py:
63-124``). ``eval_model()`` is the evaluation view: the shadow's weights
with the student's live BatchNorm statistics (``eval_variables``).

``state_dict`` / ``load_state_dict`` carry the whole state, for
checkpoints: a restored run continues exactly where the saved one was.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from ..core.config import (FLAGSHIP_SEG_ARGS, build_model_from_cfg,
                           resolve_device)
from ..losses.contrast import ContrastState
from ..models.segmentation.base_seg import init_weights
from ..optim import build_optimizer_from_cfg

CONTRAST_QUEUE = 4096   # the bank's rows (geot_tpu/engine/state.py:87)


class _Shadowed:
    """The EMA shadow of ``model``'s parameters (``ema_params``, empty
    when off) and the evaluation view of it, for both train states."""

    def seed_ema(self) -> None:
        """Start the EMA shadow from the model's current weights: the
        shadow's module is a copy of the model, and ``ema_params`` its
        parameters (``geot_tpu/engine/state.py:19``)."""
        self._eval_model = copy.deepcopy(self.model).requires_grad_(False)
        self.ema_params = dict(self._eval_model.named_parameters())

    def eval_model(self) -> torch.nn.Module:
        """The weights to evaluate: the EMA shadow's with the model's live
        BatchNorm statistics when the shadow is kept, else the model
        (``geot_tpu/engine/state.py:46``)."""
        if not self.ema_params:
            return self.model
        with torch.no_grad():
            for (_, b), (_, live) in zip(self._eval_model.named_buffers(),
                                         self.model.named_buffers()):
                b.copy_(live)
        return self._eval_model

    def _load_shadow(self, saved: Dict[str, torch.Tensor]) -> None:
        """A saved shadow goes into a state that keeps one; a state that
        keeps one and is given none keeps its own (the caller seeds it)."""
        if self.ema_params and saved:
            _copy_into(self.ema_params, saved)


@dataclass
class TrainState(_Shadowed):
    model: torch.nn.Module
    opt: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0
    # name -> the shadow of the model parameter; {} when ema_eval is off
    ema_params: Dict[str, torch.Tensor] = field(default_factory=dict)
    _eval_model: Optional[torch.nn.Module] = None

    @classmethod
    def create(cls, cfg: Dict[str, Any], model_args: Dict[str, Any],
               seed: int = 0, device: "str | torch.device" = "cuda"
               ) -> "TrainState":
        """The model of ``model_args`` with weights drawn from ``seed``,
        the optimizer of ``cfg["optimizer"]`` at ``cfg["lr"]``
        accumulating ``cfg["step_per_update"]`` gradients an update, the
        masks' generator seeded with ``seed``, and under ``cfg["ema_eval"]``
        the shadow, a copy of the initial weights; all on ``device``."""
        device = resolve_device(device)
        model = build_model_from_cfg(model_args)
        init_weights(model, torch.Generator().manual_seed(seed))
        model = model.to(device)
        state = cls(model=model,
                    opt=build_optimizer_from_cfg(
                        model, float(cfg["lr"]), every_k=_every_k(cfg),
                        **dict(cfg["optimizer"])),
                    generator=torch.Generator(device=device).manual_seed(
                        seed))
        if cfg.get("ema_eval"):
            state.seed_ema()
        return state

    def load(self, tensors: Dict[str, Any]) -> "TrainState":
        """Take the weights from a dict with the keys of
        ``engine.convert.state_from_jax``: ``model``, and where present
        the optimizer's state by parameter name (``opt``), ``step`` and the
        EMA shadow (``ema_params``, only into a state that keeps one);
        each tensor keeps the device and dtype it has in the state."""
        self.model.load_state_dict(tensors["model"], strict=True)
        if "opt" in tensors:
            _load_opt(self.opt, self.model, tensors["opt"])
        if "step" in tensors:
            self.step = int(tensors["step"])
        self._load_shadow(tensors.get("ema_params"))
        return self

    def state_dict(self) -> Dict[str, Any]:
        """The model's weights and buffers, the optimizer's state, the mask
        generator's state, ``step`` and the EMA shadow."""
        return {"model": self.model.state_dict(),
                "opt": self.opt.state_dict(),
                "generator": self.generator.get_state(),
                "step": int(self.step),
                "ema_params": dict(self.ema_params)}

    def load_state_dict(self, sd: Dict[str, Any]) -> "TrainState":
        """Restore ``state_dict()``'s output onto this state's devices."""
        self.model.load_state_dict(sd["model"], strict=True)
        self.opt.load_state_dict(sd["opt"])
        self.generator.set_state(sd["generator"].cpu())
        self.step = int(sd["step"])
        self._load_shadow(sd["ema_params"])
        return self


@dataclass
class SemiTrainState(_Shadowed):
    model: torch.nn.Module
    teacher: torch.nn.Module
    t_predictor: torch.nn.Module
    opt: torch.optim.Optimizer
    t_opt: torch.optim.Optimizer
    ema_t: torch.Tensor
    cm: torch.Tensor
    generator: torch.Generator
    contrast: ContrastState
    step: int = 0
    # name -> the shadow of the student parameter; {} when ema_eval is off
    ema_params: Dict[str, torch.Tensor] = field(default_factory=dict)
    _eval_model: Optional[torch.nn.Module] = None

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
        ``seed``; the bank's rows drawn on the CPU from ``seed + 7``; under
        ``cfg["ema_eval"]`` the shadow, a copy of the initial weights; all
        on ``device``."""
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
        bank = ContrastState.create(torch.Generator().manual_seed(seed + 7),
                                    queue_size=CONTRAST_QUEUE,
                                    dim=int(seg_args.get("trans_dim", 384)))
        state = cls(
            model=model, teacher=teacher, t_predictor=t_predictor,
            opt=build_optimizer_from_cfg(model, float(cfg["lr"]),
                                         every_k=_every_k(cfg), **opt_cfg),
            t_opt=build_optimizer_from_cfg(t_predictor, float(cfg["lr"]),
                                           **opt_cfg),
            ema_t=eye.clone(), cm=eye.clone(),
            generator=torch.Generator(device=device).manual_seed(seed),
            contrast=ContrastState(bank.queue.to(device),
                                   bank.ptr.to(device)))
        if cfg.get("ema_eval"):
            state.seed_ema()
        return state

    def load(self, tensors: Dict[str, Any]) -> "SemiTrainState":
        """Take weights and matrices from a dict with the keys of
        ``engine.convert.semi_state_from_jax``: ``model``, ``teacher`` and
        ``t_predictor`` state_dicts, ``ema_t`` and ``cm``; each keeps the
        device and dtype it has in the state. Converted from a full-state
        checkpoint, the dict also holds both optimizers' states by
        parameter name (``opt``, ``t_opt``: ``opt_state_from_jax``'s
        dicts) and ``step``, which are taken too, and the bank
        (``contrast``: ``queue``, ``ptr``) and the EMA shadow
        (``ema_params``) when it has them (the shadow only into a state
        that keeps one)."""
        self.model.load_state_dict(tensors["model"], strict=True)
        self.teacher.load_state_dict(tensors["teacher"], strict=True)
        self.t_predictor.load_state_dict(tensors["t_predictor"], strict=True)
        self.ema_t = tensors["ema_t"].to(self.ema_t)
        self.cm = tensors["cm"].to(self.cm)
        for key, opt, module in (("opt", self.opt, self.model),
                                 ("t_opt", self.t_opt, self.t_predictor)):
            if key in tensors:
                _load_opt(opt, module, tensors[key])
        if "step" in tensors:
            self.step = int(tensors["step"])
        if "contrast" in tensors:
            self.contrast = ContrastState(
                tensors["contrast"]["queue"].to(self.contrast.queue),
                tensors["contrast"]["ptr"].to(self.contrast.ptr))
        self._load_shadow(tensors.get("ema_params"))
        return self

    def state_dict(self) -> Dict[str, Any]:
        """Everything a step reads or updates: the three modules' weights
        and buffers, both optimizers' states, ``ema_t``, ``cm``, the mask
        generator's state, ``step``, the bank and the EMA shadow."""
        return {"model": self.model.state_dict(),
                "teacher": self.teacher.state_dict(),
                "t_predictor": self.t_predictor.state_dict(),
                "opt": self.opt.state_dict(),
                "t_opt": self.t_opt.state_dict(),
                "ema_t": self.ema_t, "cm": self.cm,
                "generator": self.generator.get_state(),
                "step": int(self.step),
                "contrast": {"queue": self.contrast.queue,
                             "ptr": self.contrast.ptr},
                "ema_params": dict(self.ema_params)}

    def load_state_dict(self, sd: Dict[str, Any]) -> "SemiTrainState":
        """Restore ``state_dict()``'s output onto this state's devices. The
        teacher is the saved teacher. A saved shadow goes into a state
        that keeps one; a state that keeps one and is given none keeps its
        own (the caller seeds it)."""
        self.model.load_state_dict(sd["model"], strict=True)
        self.teacher.load_state_dict(sd["teacher"], strict=True)
        self.t_predictor.load_state_dict(sd["t_predictor"], strict=True)
        self.opt.load_state_dict(sd["opt"])
        self.t_opt.load_state_dict(sd["t_opt"])
        self.ema_t = sd["ema_t"].to(self.ema_t)
        self.cm = sd["cm"].to(self.cm)
        self.generator.set_state(sd["generator"].cpu())
        self.step = int(sd["step"])
        self.contrast = ContrastState(
            sd["contrast"]["queue"].to(self.contrast.queue),
            sd["contrast"]["ptr"].to(self.contrast.ptr))
        self._load_shadow(sd["ema_params"])
        return self


def _every_k(cfg: Dict[str, Any]) -> int:
    """The gradients an update of the trained model accumulates
    (``step_per_update``, ``geot_tpu/engine/train.py:241-244``)."""
    return int(cfg.get("step_per_update", 1) or 1)


def _copy_into(dst: Dict[str, torch.Tensor],
               src: Dict[str, torch.Tensor]) -> None:
    """Copy every tensor of ``src`` into ``dst``'s tensor of that name; the
    names must be the same."""
    if set(dst) != set(src):
        raise KeyError(f"EMA shadow names differ: "
                       f"{sorted(set(dst) ^ set(src))[:5]}")
    with torch.no_grad():
        for k, v in dst.items():
            v.copy_(src[k])


def _load_opt(opt, module: torch.nn.Module, conv: Dict[str, Any]) -> None:
    """Set a ``ChainOptimizer``'s per-parameter state from
    ``engine.convert.opt_state_from_jax``'s dict (entries keyed by
    parameter name); every trainable parameter must have every entry the
    optimizer's chain keeps."""
    names = {id(p): n for n, p in module.named_parameters()}
    for p in opt.params():
        name = names[id(p)]
        st = {"step": torch.tensor(float(conv["step"]))}
        for key in (k for tx in opt.chain for k in tx.init(p)):
            if name not in conv.get(key, {}):
                raise KeyError(f"no optimizer state {key!r} for {name!r}")
            st[key] = conv[key][name].to(p)
        if opt.every_k > 1:
            st["mini_step"] = int(conv.get("mini_step", 0))
            st["acc"] = (conv["acc"][name].to(p) if "acc" in conv
                         else torch.zeros_like(p))
        opt.state[p] = st
