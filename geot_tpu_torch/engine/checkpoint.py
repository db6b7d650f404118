"""Checkpoints of the train state (``geot_tpu/engine/checkpoint.py:19-224,
355-404``).

A checkpoint is one ``torch.save`` file,
``<ckpt_dir>/<run_name>_ckpt_<tag>.pth``, holding ``{"state":
state.state_dict(), "epoch", "extra"}`` of a ``TrainState`` or a
``SemiTrainState``: ``latest`` after every save, ``best`` when the save is
the best so far, ``E<epoch>`` every ``save_freq`` epochs. Each file is written beside itself as ``.tmp`` and
swapped in with ``os.replace``, so a kill during a save leaves the previous
file whole. Files are read with ``torch.load(weights_only=True)``.

A reference GeoT checkpoint (a ``PointTransformer_seg_T`` torch ``.pth``,
``geot_tpu/engine/checkpoint.py:404-578``) is told from the port's own by
its content, never by its name: a port checkpoint holds ``state.model``.
``load_torch_pth`` reads one, ``convert_torch_seg_t`` gives the port's
``WholePartSeg`` state_dict of it (the port's parameter names are the
reference's), ``graft_state_dict`` merges weights by name as the trainer's
finetune loads do, and ``convert_cli`` writes a state_dict file that
``engine.predict.read_weights`` reads. ``load_pretrain_encoder`` grafts
the encoder trunk of a pretraining checkpoint (``engine.pretrain``) into
a segmentation model.
"""
from __future__ import annotations

import argparse
import logging
import os
import pickle
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel import dist
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
    path of ``latest``. Under data parallelism every rank calls it, rank 0
    writes (the ranks' states are equal), and no rank returns before the
    files are in place, so any rank may read them next
    (``geot_tpu/engine/checkpoint.py`` ``_sync_processes``)."""
    ckpt_dir = cfg["ckpt_dir"]
    run_name = cfg.get("run_name", "run")
    latest = ckpt_path(ckpt_dir, run_name, "latest")
    if dist.is_primary():
        os.makedirs(ckpt_dir, exist_ok=True)
        _write({"state": state.state_dict(), "epoch": int(epoch),
                "extra": dict(additional_dict or {})}, latest)
        if is_best:
            _copy(latest, ckpt_path(ckpt_dir, run_name, "best"))
        if save_freq and epoch % save_freq == 0:
            mile = ckpt_path(ckpt_dir, run_name, f"E{epoch}")
            if not os.path.exists(mile):
                _copy(latest, mile)
    dist.barrier()
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


def is_port_checkpoint(payload: Any) -> bool:
    """True for the payload of a checkpoint that ``save_checkpoint`` wrote:
    it holds ``state.model``."""
    state = payload.get("state") if isinstance(payload, dict) else None
    return isinstance(state, dict) and "model" in state


def read_weights_file(path: str) -> Any:
    """``torch.load`` of a weights file with ``weights_only=True``; None
    when the file pickles more than tensors and plain containers (a
    reference checkpoint's optimizer or argument objects), which this
    package never writes."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return None


# --- reference torch checkpoints --------------------------------------------

def _strip_prefixes(key: str) -> str:
    """A reference key without its ``module.`` (DataParallel) and
    ``model.`` prefixes (``geot_tpu/engine/checkpoint.py:404``)."""
    for p in ("module.", "model."):
        if key.startswith(p):
            key = key[len(p):]
    return key


def _model_state(ckpt: Any) -> Dict[str, Any]:
    """The state_dict of a reference checkpoint: its ``model`` entry, or the
    file itself when it is a bare state_dict."""
    return ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt


def load_torch_pth(path: str, with_epoch: bool = False):
    """A reference ``.pth`` checkpoint's model state_dict (``{"model": sd,
    "epoch": e, ...}`` or a bare state_dict), as CPU tensors; with
    ``with_epoch`` also its epoch (0 for a bare state_dict).

    Reference checkpoints pickle more than tensors (optimizer and argument
    objects), so this reads with ``torch.load(weights_only=False)``, as
    ``geot_tpu`` does: only on this path, for a file the caller names as
    the model's weights. Unpickling runs code of the file's choosing."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
          for k, v in _model_state(ckpt).items()}
    if with_epoch:
        epoch = int(ckpt.get("epoch", 0)) if isinstance(ckpt, dict) else 0
        return sd, epoch
    return sd


def _as_float(t: torch.Tensor) -> torch.Tensor:
    """float32, or float64 where the tensor is float64 (as
    ``engine.convert.params_from_jax``)."""
    t = torch.as_tensor(t).detach().cpu()
    return t.clone() if t.dtype == torch.float64 else t.float().clone()


def convert_torch_seg_t(state_dict: Dict[str, Any], depth: int = 12
                        ) -> Dict[str, torch.Tensor]:
    """The port's ``WholePartSeg`` state_dict of a reference
    ``PointTransformer_seg_T`` state_dict (``geot_tpu/engine/checkpoint.py:
    414 convert_torch_seg_t``, then ``params_from_jax``): the entries
    ``geot_tpu`` reads, under the same names, Conv1d/Conv2d k = 1 weights
    (out, in, 1[, 1]) as Linear weights (out, in), BatchNorm counters 0.
    A missing entry raises ``KeyError``; ``reduce_dim`` and the NTM head
    (``T_linear``, ``T_revision``, ``sigma``) are taken when present, and
    everything else in the file is ignored."""
    sd = {_strip_prefixes(k): v for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    pfx = "segmentor."

    def dense(name, has_bias=True):
        w = torch.as_tensor(sd[pfx + name + ".weight"])
        out[pfx + name + ".weight"] = _as_float(w.reshape(w.shape[0], -1))
        if has_bias and pfx + name + ".bias" in sd:
            out[pfx + name + ".bias"] = _as_float(sd[pfx + name + ".bias"])

    def norm(name):
        for leaf in ("weight", "bias"):
            out[f"{pfx}{name}.{leaf}"] = _as_float(sd[f"{pfx}{name}.{leaf}"])

    def bn(name):
        norm(name)
        for leaf in ("running_mean", "running_var"):
            out[f"{pfx}{name}.{leaf}"] = _as_float(sd[f"{pfx}{name}.{leaf}"])
        out[f"{pfx}{name}.num_batches_tracked"] = torch.tensor(0)

    for i in (0, 3):
        dense(f"encoder.first_conv.{i}")
    bn("encoder.first_conv.1")
    for i in (0, 3):
        dense(f"encoder.second_conv.{i}")
    bn("encoder.second_conv.1")
    if pfx + "reduce_dim.weight" in sd:
        dense("reduce_dim")
    dense("pos_embed.0")
    dense("pos_embed.2")
    for i in range(depth):
        b = f"blocks.blocks.{i}."
        norm(b + "norm1")
        norm(b + "norm2")
        for name in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            dense(b + name)
    norm("norm")
    for level in range(3):
        for j in range(2):
            dense(f"propogation_{level}.mlp.layer{j}.conv", has_bias=False)
            bn(f"propogation_{level}.mlp.layer{j}.bn.bn")
    for name in ("dgcnn_pro_1", "dgcnn_pro_2"):
        for layer in ("layer1", "layer2"):
            dense(f"{name}.{layer}.0", has_bias=False)
            norm(f"{name}.{layer}.1")
    dense("seg_head.0")
    bn("seg_head.1")
    dense("seg_head.3")
    if pfx + "T_linear.weight" in sd:
        for name in ("T_linear.weight", "T_revision.weight", "sigma"):
            out[pfx + name] = _as_float(sd[pfx + name])
    return out


def seg_t_depth(model_cfg: Dict[str, Any]) -> Optional[int]:
    """The transformer depth of a ``WholePartSeg`` config (the seg_T family,
    whose weights a reference ``.pth`` holds); None for other models."""
    if model_cfg.get("NAME") != "WholePartSeg":
        return None
    return int((model_cfg.get("segmentor_args") or {}).get("depth", 12))


def seg_t_weights(path: str, depth: int, payload: Any = None
                  ) -> Dict[str, torch.Tensor]:
    """``convert_torch_seg_t`` of the reference checkpoint or state_dict
    at ``path``. ``payload``: the file as ``read_weights_file`` read it;
    None (it pickles more than tensors) reads it with ``load_torch_pth``."""
    sd = load_torch_pth(path) if payload is None else _model_state(payload)
    return convert_torch_seg_t(sd, depth)


def graft_state_dict(model_sd: Dict[str, torch.Tensor],
                     loaded: Dict[str, torch.Tensor],
                     only_subtree: Optional[str] = None
                     ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """``model_sd`` with the entries of ``loaded`` whose name and shape it
    shares (``geot_tpu/engine/checkpoint.py:224 graft_variables``, on the
    port's flat names). ``only_subtree``: graft only names that contain it
    (``"encoder"`` for ``mode=finetune_encoder``). Returns ``(state_dict,
    skipped)``; ``skipped`` lists the entries of ``loaded`` the model lacks
    (``(unexpected)``), those of another shape, and the model's entries
    that ``loaded`` lacks (``(missing from checkpoint)``), which keep their
    values."""
    merged = dict(model_sd)
    skipped: List[str] = []
    for k, v in loaded.items():
        if only_subtree is not None and only_subtree not in k:
            continue
        if k not in model_sd:
            skipped.append(f"{k} (unexpected)")
        elif tuple(v.shape) == tuple(model_sd[k].shape):
            merged[k] = v
        else:
            skipped.append(f"{k} (shape {tuple(v.shape)} vs "
                           f"{tuple(model_sd[k].shape)})")
    skipped += [f"{k} (missing from checkpoint)" for k in model_sd
                if k not in loaded
                and (only_subtree is None or only_subtree in k)]
    return merged, skipped


def _pretrain_checkpoint(path: str) -> str:
    """The checkpoint file that ``pretrain_encoder_path`` names: the file
    itself, or ``discover_checkpoint``'s pick (``best`` first) of a run
    directory of the port."""
    if os.path.isfile(path):
        return path
    if not os.path.isdir(path):
        raise FileNotFoundError(f"pretrain_encoder_path={path} does not "
                                f"exist")
    ckdir = os.path.join(path, "checkpoint")
    if os.path.isdir(ckdir) and any(f.endswith(".pth")
                                    for f in os.listdir(ckdir)):
        return discover_checkpoint(path)
    raise ValueError(
        f"pretrain_encoder_path={path} is a directory but not a run "
        f"directory of geot_tpu_torch (no <run>/checkpoint/*.pth): the "
        f"port reads its own pretraining checkpoints, not geot_tpu's orbax "
        f"directories")


def load_pretrain_encoder(model_sd: Dict[str, torch.Tensor],
                          pretrain_path: str,
                          segmentor_key: str = "segmentor"
                          ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Graft the point-encoder trunk of a pretraining checkpoint into a
    segmentation model's ``state_dict`` (``geot_tpu/engine/checkpoint.py:
    302-360``): the checkpoint's ``encoder.*`` entries (weights and
    BatchNorm statistics) go into ``segmentor.*`` of a ``WholePartSeg``, or
    into ``encoder.*`` of a zoo ``BaseSeg``; the rest of the model keeps
    its values. ``pretrain_path`` is a checkpoint file that
    ``engine.pretrain`` wrote, or its run directory. Returns
    ``(state_dict, skipped)``: ``skipped`` lists the checkpoint's encoder
    entries that the model lacks or holds in another shape (never the
    model's entries the checkpoint lacks: the decoder and head keep their
    fresh values by design). A model with neither top-level module, a
    checkpoint without ``encoder`` entries, or one none of whose entries
    match raises ``ValueError``."""
    path = _pretrain_checkpoint(str(pretrain_path))
    payload = read_weights_file(path)
    if not is_port_checkpoint(payload):
        raise ValueError(f"{path}: not a checkpoint of geot_tpu_torch's "
                         f"trainer")
    loaded = variables_of(payload, prefer_ema=False)
    tops = {k.split(".", 1)[0] for k in model_sd}
    target = (segmentor_key if segmentor_key in tops
              else "encoder" if "encoder" in tops else None)
    if target is None:
        raise ValueError(f"model has neither a '{segmentor_key}' nor an "
                         f"'encoder' top-level module to graft {path} into "
                         f"(modules: {sorted(tops)})")
    trunk = {f"{target}.{k[len('encoder.'):]}": v for k, v in loaded.items()
             if k.startswith("encoder.")}
    if not trunk:
        raise ValueError(f"{path}: checkpoint has no 'encoder' module to "
                         f"transfer (a geot_tpu_torch.engine.pretrain "
                         f"checkpoint is expected)")
    merged, skipped = graft_state_dict(model_sd, trunk)
    skipped = [k for k in skipped if not k.endswith("(missing from "
                                                    "checkpoint)")]
    if all(merged[k] is model_sd[k] for k in model_sd):
        raise ValueError(f"{path}: no pretrain-encoder entry matched the "
                         f"model (first skips: {skipped[:3]}): another "
                         f"encoder family than this segmentor's?")
    return merged, skipped


def convert_cli(argv=None) -> str:
    """``python -m geot_tpu_torch.engine.checkpoint <in.pth> <out.pt>
    [--depth 12]``: a reference ``PointTransformer_seg_T`` checkpoint as
    the port's ``WholePartSeg`` state_dict file, which ``load_model``,
    ``predict``/``serve --ckpt`` and ``pretrained_path`` read (the
    counterpart of ``geot-convert``, ``geot_tpu/engine/checkpoint.py:541``,
    whose orbax output the port does not read). Runs on the CPU."""
    p = argparse.ArgumentParser(
        description="Convert a reference GeoT .pth checkpoint to a "
                    "geot_tpu_torch state_dict file")
    p.add_argument("pth", help="reference .pth checkpoint")
    p.add_argument("out", help="output state_dict file")
    p.add_argument("--depth", type=int, default=12,
                   help="transformer depth of the checkpoint (default 12)")
    args = p.parse_args(argv)
    sd, epoch = load_torch_pth(args.pth, with_epoch=True)
    out_sd = convert_torch_seg_t(sd, depth=args.depth)
    out = os.path.abspath(args.out)
    _write(out_sd, out)
    n = sum(v.numel() for k, v in out_sd.items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked")))
    print(f"converted {args.pth} (epoch {epoch}) -> {out} "
          f"({n / 1e6:.3f} M params)")
    return out


if __name__ == "__main__":
    convert_cli()
