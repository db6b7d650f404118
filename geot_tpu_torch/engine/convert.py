"""Weights and train state from ``geot_tpu`` to the port.

``params_from_jax`` takes the JAX package's ``{"params", "batch_stats"}``
tree of a ``WholePartSeg`` (nested dicts of numpy arrays; no JAX needed)
and returns the port's ``state_dict``, running statistics included.
``t_params_from_jax`` does the same for the ``Ins_T_mean`` T-predictor, and
``semi_state_from_jax`` for the parts of a ``SemiTrainState`` that a step
reads besides the optimizers: student, teacher, T-predictor, ``ema_t`` and
``cm``. Dense kernels (in, out) become
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


def params_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``geot_tpu`` WholePartSeg variables -> port ``state_dict``."""
    params = variables["params"]["segmentor"]
    stats = variables.get("batch_stats", {}).get("segmentor", {})
    stats_by_path = dict(_walk(stats))
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        sd["segmentor." + key] = torch.from_numpy(
            np.array(arr, dtype=np.float32))

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
    return {"T_predictor.fc": torch.from_numpy(np.array(
        t_params["T_predictor"]["fc"], dtype=np.float32))}


def semi_state_from_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """A ``geot_tpu`` ``SemiTrainState`` as a dict of numpy trees (keys
    ``params``, ``batch_stats``, ``t_params``, ``teacher_params``,
    ``teacher_batch_stats``, ``ema_t``, ``cm``) -> what
    ``engine.state.SemiTrainState.load`` takes."""
    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    return {
        "model": params_from_jax({"params": state["params"],
                                  "batch_stats": state["batch_stats"]}),
        "teacher": params_from_jax({"params": state["teacher_params"],
                                    "batch_stats":
                                    state["teacher_batch_stats"]}),
        "t_predictor": t_params_from_jax(state["t_params"]),
        "ema_t": f32(state["ema_t"]),
        "cm": f32(state["cm"]),
    }
