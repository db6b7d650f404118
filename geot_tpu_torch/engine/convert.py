"""Weights and train state from ``geot_tpu`` to the port.

``params_from_jax`` takes the JAX package's ``{"params", "batch_stats"}``
tree of a ``WholePartSeg`` (nested dicts of numpy arrays; no JAX needed)
and returns the port's ``state_dict``, running statistics included.
``t_params_from_jax`` does the same for the ``Ins_T_mean`` T-predictor, and
``semi_state_from_jax`` for a ``SemiTrainState``: student, teacher,
T-predictor, ``ema_t``, ``cm``, the contrast bank and the EMA shadow,
and, from a full-state checkpoint, both optax AdamW states and ``step``. Dense kernels (in, out) become
Linear weights (out, in); flax BatchNorm ``scale``/``bias`` + ``mean``/
``var`` become ``weight``/``bias`` + ``running_mean``/``running_var``;
LayerNorm and GroupNorm ``scale`` becomes ``weight``.
"""
from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

# flax module path (below "segmentor") -> port module name, where it is not
# a plain rename of the path
_RENAME = {
    "encoder/conv1a": "encoder.first_conv.0",
    "encoder/bn1": "encoder.first_conv.1",
    "encoder/conv1b": "encoder.first_conv.3",
    "encoder/conv2a": "encoder.second_conv.0",
    "encoder/bn2": "encoder.second_conv.1",
    "encoder/conv2b": "encoder.second_conv.3",
    "pos_embed/fc1": "pos_embed.0",
    "pos_embed/fc2": "pos_embed.2",
    "seg_head/conv1": "seg_head.0",
    "seg_head/bn": "seg_head.1",
    "seg_head/conv2": "seg_head.3",
}
_PATTERNS = (
    (r"^blocks/block_(\d+)", r"blocks/blocks/\1"),
    (r"^propagation_(\d)/mlp/dense_(\d+)$", r"propogation_\1/mlp/layer\2/conv"),
    (r"^propagation_(\d)/mlp/bn_(\d+)$", r"propogation_\1/mlp/layer\2/bn/bn"),
    (r"^(dgcnn_pro_\d)/layer(\d)_conv$", r"\1/layer\2/0"),
    (r"^(dgcnn_pro_\d)/layer(\d)_gn$", r"\1/layer\2/1"),
)


def _module_name(path: str) -> str:
    if path in _RENAME:
        return _RENAME[path]
    for pat, rep in _PATTERNS:
        path = re.sub(pat, rep, path)
    return path.replace("/", ".")


def _walk(tree: Dict[str, Any], prefix: str = ""):
    """Yield (module path, {leaf name: array}) for every dict of leaves."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, dict)}
    if leaves:
        yield prefix, leaves
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}/{k}" if prefix else k)


def _float(a) -> torch.Tensor:
    """float32, or float64 where the array is float64 (``geot_tpu`` with
    x64 on)."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(
        a, dtype=np.float64 if a.dtype == np.float64 else np.float32))


def params_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``geot_tpu`` WholePartSeg variables -> port ``state_dict``, in
    float32 (float64 leaves stay float64)."""
    params = variables["params"]["segmentor"]
    stats = variables.get("batch_stats", {}).get("segmentor", {})
    stats_by_path = dict(_walk(stats))
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        sd["segmentor." + key] = _float(arr)

    for path, leaves in _walk(params):
        if path == "":            # T_linear / T_revision / sigma
            for name, arr in leaves.items():
                put(name if name == "sigma" else f"{name}.weight", arr)
            continue
        mod = _module_name(path)
        if "kernel" in leaves:    # Dense
            put(f"{mod}.weight", np.asarray(leaves["kernel"]).T)
            if "bias" in leaves:
                put(f"{mod}.bias", leaves["bias"])
            continue
        put(f"{mod}.weight", leaves["scale"])
        put(f"{mod}.bias", leaves["bias"])
        if path in stats_by_path:  # BatchNorm
            put(f"{mod}.running_mean", stats_by_path[path]["mean"])
            put(f"{mod}.running_var", stats_by_path[path]["var"])
            sd[f"segmentor.{mod}.num_batches_tracked"] = torch.tensor(0)
    return sd


def t_params_from_jax(t_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``Ins_T_mean`` params (``{"T_predictor": {"fc": (C, 2C, C)}}``) ->
    the port's ``InsTMean`` state_dict; the layout is the same."""
    return {"T_predictor.fc": _float(t_params["T_predictor"]["fc"])}


def _adam_state(opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """The ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside an
    optax state written as nested dicts (``flax.serialization``)."""
    if {"count", "mu", "nu"} <= set(opt_state):
        return opt_state
    found = [_adam_state(v) for v in opt_state.values()
             if isinstance(v, dict)]
    found = [f for f in found if f is not None]
    if len(found) > 1:
        raise ValueError("more than one Adam state in the optimizer state")
    return found[0] if found else None


def _moments(opt_state: Dict[str, Any], convert) -> Dict[str, Any]:
    """optax Adam moments -> ``{"step", "exp_avg", "exp_avg_sq"}`` keyed by
    the port's parameter names, through the weights' own converter."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer "
                         "state")
    return {"step": int(np.asarray(adam["count"])),
            "exp_avg": convert(adam["mu"]),
            "exp_avg_sq": convert(adam["nu"])}


def semi_state_from_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """A ``geot_tpu`` ``SemiTrainState`` as a dict of numpy trees (keys
    ``params``, ``batch_stats``, ``t_params``, ``teacher_params``,
    ``teacher_batch_stats``, ``ema_t``, ``cm``, and where present
    ``contrast`` (a ``ContrastState`` or a dict with ``queue`` and
    ``ptr``) and ``ema_params`` (empty when the run kept no shadow); a
    full-state checkpoint, as ``geot_tpu.engine.checkpoint._restore``
    reads it, also has ``opt_state``, ``t_opt_state`` and ``step``) ->
    what ``engine.state.SemiTrainState.load`` takes. The optimizer moments
    are matched to parameters by name, never by position: torch keeps them
    in param-group order, optax in tree order. Floating leaves come as
    float32, or float64 where they are float64."""
    out = {
        "model": params_from_jax({"params": state["params"],
                                  "batch_stats": state["batch_stats"]}),
        "teacher": params_from_jax({"params": state["teacher_params"],
                                    "batch_stats":
                                    state["teacher_batch_stats"]}),
        "t_predictor": t_params_from_jax(state["t_params"]),
        "ema_t": _float(state["ema_t"]),
        "cm": _float(state["cm"]),
    }
    if "opt_state" in state:
        out["opt"] = _moments(state["opt_state"], lambda tree: params_from_jax(
            {"params": tree, "batch_stats": {}}))
    if "t_opt_state" in state:
        out["t_opt"] = _moments(state["t_opt_state"], t_params_from_jax)
    if "step" in state:
        out["step"] = int(np.asarray(state["step"]))
    if "contrast" in state:
        c = state["contrast"]
        queue, ptr = ((c["queue"], c["ptr"]) if isinstance(c, dict)
                      else (c.queue, c.ptr))
        out["contrast"] = {"queue": _float(queue),
                           "ptr": torch.tensor(int(np.asarray(ptr)))}
    if state.get("ema_params"):
        out["ema_params"] = params_from_jax({"params": state["ema_params"],
                                             "batch_stats": {}})
    return out
