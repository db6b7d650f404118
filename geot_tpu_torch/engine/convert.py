"""Weights and train state from ``geot_tpu`` to the port.

``params_from_jax`` takes the JAX package's ``{"params", "batch_stats"}``
tree of a model (nested dicts of numpy arrays; no JAX needed) and returns
the port's ``state_dict``, running statistics included; a leaf it cannot
place raises, naming it. ``t_params_from_jax`` does the same for the
``Ins_T_mean`` and ``Ins_T`` T-predictors;
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


# the shared MLPs (flax ``dense_{i}``/``bn_{i}``) of the zoo (``convs``)
# and of VoteNet's modules (``mlp_module``, ``mlp_{i}``, ``post_mlp``) are
# the port's ``SharedMLP`` (``layer{i}.conv``/``layer{i}.bn.bn``)
_SHARED = r"(^|/)(convs|mlp_module|mlp_\d+|post_mlp)"
_SHARED_MLP = ((_SHARED + r"/dense_(\d+)$", r"\1\2/layer\3/conv"),
               (_SHARED + r"/bn_(\d+)$", r"\1\2/layer\3/bn/bn"))


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


# the raw parameters (not a layer's kernel, bias or scale) of geot_tpu's
# models: PointMLP's affine, the cls-token encoders' token and position,
# sig_t's and sig_t_mean's matrices, PReLU's slope (``create_act``); the
# seg_T family's T_linear, T_revision and sigma sit at the segmentor's root
_RAW = ("affine_alpha", "affine_beta", "cls_token", "cls_pos", "fc",
        "negative_slope")
_SEG_T_ROOT = ("T_linear", "T_revision", "sigma")


def _unplaced(path: str, names) -> ValueError:
    leaves = ", ".join(f"{path}/{n}" if path else n for n in sorted(names))
    return ValueError(f"no place in the port for the leaves {leaves}")


def params_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``geot_tpu`` model variables -> port ``state_dict``, in float32
    (float64 leaves stay float64). The model is a ``WholePartSeg`` or
    ``WholePartSeg_ntm`` (over any ``PointTransformer_seg*``), a
    ``BaseSeg``, ``DistillBaseSeg``, ``VariableSeg`` or ``BasePartSeg``
    (with any head), a ``BaseCls`` (the cls-token encoders included), a
    ``PointMLPPartSegmentor``, a ``ViewGenBase`` (any encoder, generator
    and decoder), one of their encoders, a patch embedding or ``sig_t``;
    their port modules carry the flax names, but for the transformer
    trunk's renames. So does any module of the layer surface and
    VoteNet's SA modules (``ASSA``, the factory blocks, the ``Mlp``
    family, ``KMeansEmbed``, the graph convs, ``TransformerEncoder``,
    ``PointnetSAModuleVotes`` and its kin), alone or inside a model. Convolution kernels (H, W, in, out) become OIHW
    weights. A leaf that has no place in the port (a layer with leaves
    other than its own, a raw parameter the port's models lack, running
    statistics without their normalisation) raises ``ValueError`` naming
    it."""
    params = variables["params"]
    trunks = (("",) if "pos_embed" in params else ("segmentor/",) + (
        ("encoder/",) if "pos_embed" in (params.get("encoder") or {})
        else ()))
    stats_by_path = dict(_walk(variables.get("batch_stats", {})))
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        # a layer at the tree's root (a bare Dense or norm) has no prefix
        sd[key.lstrip(".")] = _float(arr)

    placed_stats = set()
    for path, leaves in _walk(params):
        if path == "segmentor":   # T_linear / T_revision / sigma
            if set(leaves) - set(_SEG_T_ROOT):
                raise _unplaced(path, set(leaves) - set(_SEG_T_ROOT))
            for name, arr in leaves.items():
                put(f"segmentor.{name}" if name == "sigma"
                    else f"segmentor.{name}.weight", arr)
            continue
        mod = _module_name(path, trunks)
        if "kernel" in leaves:    # Dense, Conv, ConvTranspose
            if set(leaves) - {"kernel", "bias"}:
                raise _unplaced(path, set(leaves) - {"kernel", "bias"})
            kernel = np.asarray(leaves["kernel"])
            put(f"{mod}.weight", kernel.transpose(3, 2, 0, 1)
                if kernel.ndim == 4 else kernel.T)
            if "bias" in leaves:
                put(f"{mod}.bias", leaves["bias"])
        elif "scale" in leaves:   # a normalisation
            if set(leaves) - {"scale", "bias"}:
                raise _unplaced(path, set(leaves) - {"scale", "bias"})
            put(f"{mod}.weight", leaves["scale"])
            put(f"{mod}.bias", leaves["bias"])
            if path in stats_by_path:  # BatchNorm
                put(f"{mod}.running_mean", stats_by_path[path]["mean"])
                put(f"{mod}.running_var", stats_by_path[path]["var"])
                sd[f"{mod}.num_batches_tracked".lstrip(".")] = \
                    torch.tensor(0)
                placed_stats.add(path)
        else:                     # raw parameters (affine_alpha, ...)
            if set(leaves) - set(_RAW):
                raise _unplaced(path, set(leaves) - set(_RAW))
            for name, arr in leaves.items():
                put(f"{mod}.{name}" if mod else name, arr)
    if set(stats_by_path) - placed_stats:
        path = sorted(set(stats_by_path) - placed_stats)[0]
        raise _unplaced(f"batch_stats/{path}", stats_by_path[path])
    return sd


def t_params_from_jax(t_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``Ins_T_mean`` or ``Ins_T`` params (``{"T_predictor": {"fc": ...}}``:
    ``sig_t_mean``'s (C, 2C, C) or ``sig_t``'s (C C, C)) -> the port's
    ``InsTMean`` / ``InsT`` state_dict; the layouts are the same. Any other
    leaf raises ``ValueError`` naming it."""
    pred = t_params.get("T_predictor")
    if set(t_params) != {"T_predictor"} or not isinstance(pred, dict) \
            or set(pred) != {"fc"}:
        names = [f"T_predictor/{k}" for k in (pred or {}) if k != "fc"] + [
            k for k in t_params if k != "T_predictor"]
        raise _unplaced("", names or ["T_predictor/fc (missing)"])
    return {"T_predictor.fc": _float(pred["fc"])}


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
