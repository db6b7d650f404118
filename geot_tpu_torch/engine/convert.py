"""Weights and train state from ``geot_tpu`` to the port.

``params_from_jax`` takes the JAX package's ``{"params", "batch_stats"}``
tree of a ``WholePartSeg``, ``BaseSeg``, ``PointMLPPartSegmentor`` or
``ViewGenBase`` (nested dicts of numpy arrays; no JAX needed) and returns
the port's ``state_dict``, running statistics included.
``t_params_from_jax`` does the same for the ``Ins_T_mean`` T-predictor;
``state_from_jax`` for a supervised or pretraining ``TrainState``: the
weights, the EMA shadow and, from a full-state checkpoint, the optax
optimizer state (``opt_state_from_jax``) and ``step``; and
``semi_state_from_jax`` for a ``SemiTrainState``: all of that for the
student, and the teacher, the T-predictor and its optimizer state,
``ema_t``, ``cm`` and the contrast bank. Dense kernels (in,
out) become Linear weights (out, in) and convolution kernels (H, W, in,
out) OIHW weights; flax BatchNorm ``scale``/``bias`` + ``mean``/``var``
become ``weight``/``bias`` + ``running_mean``/``running_var``; LayerNorm
and GroupNorm ``scale`` becomes ``weight``; other parameters keep their
names.
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


# the zoo's shared MLPs (``convs``: flax ``dense_{i}``/``bn_{i}``) are the
# port's ``SharedMLP`` (``layer{i}.conv``/``layer{i}.bn.bn``)
_SHARED_MLP = ((r"(^|/)convs/dense_(\d+)$", r"\1convs/layer\2/conv"),
               (r"(^|/)convs/bn_(\d+)$", r"\1convs/layer\2/bn/bn"))


def _module_name(path: str, trunks=("segmentor/",)) -> str:
    """The port's module name of a flax module path: below a trunk root
    (``segmentor/``; ``encoder/`` of a ``ViewGenBase`` whose encoder is the
    transformer trunk; ``""`` for that encoder alone) the flagship's
    renames, everywhere else the flax path with dots."""
    for root in trunks:
        if path.startswith(root):
            sub = path[len(root):]
            if sub in _RENAME:
                return (root + _RENAME[sub]).replace("/", ".")
            for pat, rep in _PATTERNS:
                sub = re.sub(pat, rep, sub)
            path = root + sub
            break
    for pat, rep in _SHARED_MLP:
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
    """``geot_tpu`` model variables -> port ``state_dict``, in float32
    (float64 leaves stay float64). The model is a ``WholePartSeg`` (the
    flagship or ``PointTransformer_seg``), a ``BaseSeg``, a
    ``PointMLPPartSegmentor``, a ``ViewGenBase`` (any encoder, generator
    and decoder) or a generation encoder; their port modules carry the
    flax names, but for the transformer trunk's renames. Convolution
    kernels (H, W, in, out) become OIHW weights."""
    params = variables["params"]
    trunks = (("",) if "pos_embed" in params else ("segmentor/",) + (
        ("encoder/",) if "pos_embed" in (params.get("encoder") or {})
        else ()))
    stats_by_path = dict(_walk(variables.get("batch_stats", {})))
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        sd[key] = _float(arr)

    for path, leaves in _walk(params):
        if path == "segmentor":   # T_linear / T_revision / sigma
            for name, arr in leaves.items():
                put(f"segmentor.{name}" if name == "sigma"
                    else f"segmentor.{name}.weight", arr)
            continue
        mod = _module_name(path, trunks)
        if "kernel" in leaves:    # Dense, Conv, ConvTranspose
            kernel = np.asarray(leaves["kernel"])
            put(f"{mod}.weight", kernel.transpose(3, 2, 0, 1)
                if kernel.ndim == 4 else kernel.T)
            if "bias" in leaves:
                put(f"{mod}.bias", leaves["bias"])
        elif "scale" in leaves:   # a normalisation
            put(f"{mod}.weight", leaves["scale"])
            put(f"{mod}.bias", leaves["bias"])
            if path in stats_by_path:  # BatchNorm
                put(f"{mod}.running_mean", stats_by_path[path]["mean"])
                put(f"{mod}.running_var", stats_by_path[path]["var"])
                sd[f"{mod}.num_batches_tracked"] = torch.tensor(0)
        else:                     # raw parameters (affine_alpha, ...)
            for name, arr in leaves.items():
                put(f"{mod}.{name}", arr)
    return sd


def t_params_from_jax(t_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``Ins_T_mean`` params (``{"T_predictor": {"fc": (C, 2C, C)}}``) ->
    the port's ``InsTMean`` state_dict; the layout is the same."""
    return {"T_predictor.fc": _float(t_params["T_predictor"]["fc"])}


# per-parameter trees of the optax states the port converts: field ->
# the port's state entry (``optim.factory.ChainOptimizer``)
_PER_PARAM = {
    "ScaleByAdamState": {"mu": "exp_avg", "nu": "exp_avg_sq"},
    "TraceState": {"trace": "momentum_buffer"},
    "LookaheadState": {"slow": "slow"},
    "AdahessianState": {"exp_avg": "exp_avg",
                        "exp_hessian_diag_sq": "exp_hessian_diag_sq"},
}
# the field sets of optax states written as dicts (flax.serialization),
# which lose their type's name
_FIELDS = {
    frozenset({"count", "mu", "nu"}): "ScaleByAdamState",
    frozenset({"trace"}): "TraceState",
    frozenset({"count", "slow"}): "LookaheadState",
    frozenset({"count", "exp_avg", "exp_hessian_diag_sq"}):
        "AdahessianState",
    frozenset({"mini_step", "gradient_step", "inner_opt_state",
               "acc_grads", "skip_state"}): "MultiStepsState",
    frozenset({"count", "hyperparams", "inner_state"}):
        "InjectHyperparamsState",
    frozenset({"count", "hyperparams", "hyperparams_states",
               "inner_state"}): "InjectStatefulHyperparamsState",
    frozenset({"inner_state"}): "MaskedState",
    frozenset({"nu"}): "ScaleByRmsState",
    frozenset({"count", "v_row", "v_col", "v"}): "FactoredState",
    frozenset({"count", "momentum"}): "ScaleBySGDPState",
    frozenset({"count", "grad_sum", "grad_sum_sq", "x0"}): "MadgradState",
}


def _fields(node) -> "tuple[str, Dict[str, Any]] | None":
    """(type name, fields) of an optax state node: a NamedTuple, or a dict
    whose keys are a known state's fields; None for a chain's container
    (a tuple, or a dict keyed ``"0"``, ``"1"``, ...)."""
    if hasattr(node, "_asdict"):
        return type(node).__name__, node._asdict()
    if isinstance(node, dict) and node and not all(
            k.isdigit() for k in node):
        name = _FIELDS.get(frozenset(node))
        if name is None:
            raise ValueError(f"optimizer state with fields {sorted(node)} "
                             f"does not convert to the port")
        return name, node
    return None


def opt_state_from_jax(opt_state, convert) -> Dict[str, Any]:
    """A ``geot_tpu`` optax state (objects, or dicts as a checkpoint holds
    it) -> the port's optimizer state by parameter name: ``step`` (the
    updates applied: ``inject_hyperparams``'s count), each per-parameter
    entry as ``{name: tensor}`` through ``convert`` (the weights' own
    converter), and under ``MultiSteps`` ``mini_step`` and ``acc``. The
    states converted: ``ScaleByAdamState``, ``TraceState``,
    ``MultiStepsState``, ``LookaheadState`` and ``AdahessianState`` (with
    the wrappers ``inject_hyperparams``, ``chain`` and ``masked``); any
    other raises ``ValueError`` naming its type."""
    out: Dict[str, Any] = {}

    def walk(node):
        found = _fields(node)
        if found is None:
            children = (node.values() if isinstance(node, dict)
                        else node if isinstance(node, (tuple, list)) else ())
            for child in children:
                walk(child)
            return
        name, f = found
        if not f:                     # EmptyState
            return
        if name == "MultiStepsState":
            out["mini_step"] = int(np.asarray(f["mini_step"]))
            out["acc"] = convert(f["acc_grads"])
            walk(f["inner_opt_state"])
        elif name.startswith("Inject"):
            out["step"] = int(np.asarray(f["count"]))
            walk(f["inner_state"])
        elif name == "MaskedState":
            walk(f["inner_state"])
        elif name in _PER_PARAM:
            for field, key in _PER_PARAM[name].items():
                if key in out:
                    raise ValueError(f"more than one {name} in the "
                                     f"optimizer state")
                out[key] = convert(f[field])
            if "count" in f:
                out.setdefault("step", int(np.asarray(f["count"])))
        else:
            raise ValueError(f"optimizer state {name} does not convert to "
                             f"the port (converted: ScaleByAdamState, "
                             f"TraceState, MultiStepsState, LookaheadState, "
                             f"AdahessianState)")

    walk(opt_state)
    if "step" not in out:
        raise ValueError("no update count in the optimizer state")
    return out


def state_from_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """A ``geot_tpu`` ``TrainState`` as a dict of numpy trees (keys
    ``params``, ``batch_stats``, and where present ``ema_params`` (empty
    when the run kept no shadow), ``opt_state`` and ``step``) -> what
    ``engine.state.TrainState.load`` takes: ``model``, and ``ema_params``,
    the optimizer state ``opt`` and ``step`` where the state has them. The
    optimizer's entries are matched to parameters by name, never by
    position: the port keeps them in param-group order, optax in tree
    order.
    Floating leaves come as float32, or float64 where they are float64."""
    out = {"model": params_from_jax({"params": state["params"],
                                     "batch_stats": state["batch_stats"]})}
    if "opt_state" in state:
        out["opt"] = opt_state_from_jax(
            state["opt_state"], lambda tree: params_from_jax(
                {"params": tree, "batch_stats": {}}))
    if "step" in state:
        out["step"] = int(np.asarray(state["step"]))
    if state.get("ema_params"):
        out["ema_params"] = params_from_jax({"params": state["ema_params"],
                                             "batch_stats": {}})
    return out


def semi_state_from_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """A ``geot_tpu`` ``SemiTrainState`` as a dict of numpy trees:
    ``state_from_jax``'s keys plus ``t_params``, ``teacher_params``,
    ``teacher_batch_stats``, ``ema_t``, ``cm``, and where present
    ``contrast`` (a ``ContrastState`` or a dict with ``queue`` and
    ``ptr``); a full-state checkpoint, as
    ``geot_tpu.engine.checkpoint._restore`` reads it, also has
    ``t_opt_state``) -> what ``engine.state.SemiTrainState.load`` takes."""
    out = state_from_jax(state)
    out.update({
        "teacher": params_from_jax({"params": state["teacher_params"],
                                    "batch_stats":
                                    state["teacher_batch_stats"]}),
        "t_predictor": t_params_from_jax(state["t_params"]),
        "ema_t": _float(state["ema_t"]),
        "cm": _float(state["cm"]),
    })
    if "t_opt_state" in state:
        out["t_opt"] = opt_state_from_jax(state["t_opt_state"],
                                          t_params_from_jax)
    if "contrast" in state:
        c = state["contrast"]
        queue, ptr = ((c["queue"], c["ptr"]) if isinstance(c, dict)
                      else (c.queue, c.ptr))
        out["contrast"] = {"queue": _float(queue),
                           "ptr": torch.tensor(int(np.asarray(ptr)))}
    return out
