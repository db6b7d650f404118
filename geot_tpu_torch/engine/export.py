"""Ahead-of-time export of the segmentation forward for serving, the
counterpart of ``geot_tpu/engine/export.py``.

``export_forward`` runs ``torch.export.export`` on the forward ``(pos (B,
N, 3) float32, cls (B, 1) int64) -> logits (B, N, C)`` of a built model in
eval mode and saves the program with ``torch.export.save``. The kernels
reach the graph as the custom ops ``geot::fps`` and ``geot::knn_small_k``
(``geot_tpu_torch.ops``), so a program exported on the card launches them
when it runs, and counts its launches in ``ops.LAUNCHES``.

Loading an artifact (``load_exported``, ``load_forward``) needs ``torch``
and ``geot_tpu_torch.ops``, which registers the two ops, and no model code
and no config: no ``geot_tpu_torch.models`` module is imported. That is the
port's counterpart of ``geot_tpu``'s "callable without the model code".

    from geot_tpu_torch.engine.export import export_forward, load_forward
    export_forward(model, state_dict, n_points=16000, out="model.pt2")
    fwd = load_forward("model.pt2")          # serving side
    logits = fwd(pos, cls)                   # (B, N, 3), (B, 1) -> (B, N, C)

    python -m geot_tpu_torch.engine.export --cfg <yaml> --ckpt <file>
        --out model.pt2 [--n_points 16000] [--batch 1] [k=v ...]

``embed_params=False`` keeps the weights out of the artifact: the program
then takes ``(state_dict, pos, cls)``, as ``geot_tpu``'s takes ``(variables,
pos, cls)``.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch

from .. import ops  # noqa: F401  (registers geot::fps, geot::knn_small_k)


class _Forward(torch.nn.Module):
    """``(pos, cls) -> logits`` of a segmentation model."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, pos: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
        out = self.model({"pos": pos, "x": pos, "cls": cls})
        return out[0] if isinstance(out, (tuple, list)) else out


class _FunctionalForward(torch.nn.Module):
    """``(state_dict, pos, cls) -> logits``: the weights are an input."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, state: Dict[str, torch.Tensor], pos: torch.Tensor,
                cls: torch.Tensor) -> torch.Tensor:
        out = torch.func.functional_call(
            self.model, state, ({"pos": pos, "x": pos, "cls": cls},))
        return out[0] if isinstance(out, (tuple, list)) else out


def export_forward(model: torch.nn.Module,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None,
                   n_points: int = 16000, batch: int = 1,
                   out: Optional[str] = None, embed_params: bool = True):
    """Export ``model``'s eval forward at ``(batch, n_points)``.

    ``state_dict`` is loaded into ``model`` first when given (otherwise the
    model's own weights are used). The example inputs are made on the
    model's device, so a model on the card gives a program for the card.
    Returns the ``torch.export.ExportedProgram``, or ``out`` after saving
    it there."""
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model.eval()
    device = next(model.parameters()).device
    pos = torch.zeros((batch, n_points, 3), dtype=torch.float32,
                      device=device)
    cls = torch.zeros((batch, 1), dtype=torch.long, device=device)
    with torch.no_grad():
        # one eager forward first: what the forward caches on the device
        # (the stratified fill's schedule) is then a constant of the
        # program on the device, not a copy from the host on every call
        model({"pos": pos, "x": pos, "cls": cls})
        if embed_params:
            ep = torch.export.export(_Forward(model), (pos, cls),
                                     strict=False)
        else:
            state = {k: v.detach() for k, v in model.state_dict().items()}
            ep = torch.export.export(_FunctionalForward(model),
                                     (state, pos, cls), strict=False)
    if out is None:
        return ep
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.export.save(ep, out)
    return out


def load_exported(src) -> "torch.export.ExportedProgram":
    """The ``ExportedProgram`` saved at ``src`` (a path or a file-like
    object); ``input_specs(ep)`` gives its input shapes."""
    return torch.export.load(src)


def input_specs(ep) -> list:
    """``(shape, dtype)`` of each user input of ``ep`` that is a tensor, in
    order (a ``state_dict`` input contributes one per entry)."""
    names = set(ep.graph_signature.user_inputs)
    specs = []
    for node in ep.graph.nodes:
        if node.op == "placeholder" and node.name in names:
            val = node.meta["val"]
            specs.append((tuple(int(d) for d in val.shape), val.dtype))
    return specs


def load_forward(src) -> Callable:
    """The exported forward as a callable module: ``fwd(pos, cls)`` (or
    ``fwd(state_dict, pos, cls)`` for an ``embed_params=False`` export)."""
    return load_exported(src).module()


def export_cli(argv=None):
    """``python -m geot_tpu_torch.engine.export --cfg <yaml> --ckpt <file>
    --out <file>``: build the configured model, load the checkpoint (a
    checkpoint of the port's trainer, with its EMA weights as ``use_ema``
    picks them, a state_dict file or a reference ``.pth``) and export it
    on ``device`` (``k=v`` override; the card by default)."""
    import argparse

    from ..core.config import EasyConfig, build_model_from_cfg, \
        resolve_device
    from .checkpoint import (is_port_checkpoint, read_weights_file,
                             seg_t_depth, variables_of)
    from .predict import read_weights

    p = argparse.ArgumentParser("geot_tpu_torch AOT export")
    p.add_argument("--cfg", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--n_points", type=int, default=16000)
    p.add_argument("--batch", type=int, default=1)
    args, opts = p.parse_known_args(argv)
    cfg = EasyConfig()
    cfg.load(args.cfg, recursive=True)
    cfg.update(opts)
    device = resolve_device(cfg.get("device", "cuda"))
    model = build_model_from_cfg(dict(cfg.model))
    payload = read_weights_file(args.ckpt)
    if is_port_checkpoint(payload):
        use_ema = cfg.get("use_ema", "auto")
        weights = variables_of(payload, "auto" if use_ema == "auto"
                               else bool(use_ema))
    else:
        weights = read_weights(args.ckpt, seg_t_depth(dict(cfg.model)))
    model.load_state_dict(weights, strict=True)
    path = export_forward(model.to(device), n_points=args.n_points,
                          batch=args.batch, out=args.out)
    print(f"exported to {path} ({os.path.getsize(path)} bytes)")
    return path


if __name__ == "__main__":
    export_cli()
