"""Scan-level inference, the serving path
(``geot_tpu/engine/predict.py:29-290``).

    model = load_model()                      # flagship, seeded weights, CUDA
    labels, logits = predict_scan(model, points, jaw=0)
    for name, points, labels, jaw in predict_stream(model, scans): ...

Pipeline: unit-sphere normalise -> sample ``num_points`` with numpy's
``default_rng(seed).choice`` (the same draw as ``geot_tpu``) -> forward ->
softmax -> 3-NN upsample to the full scan -> uint8 class ids.

``model`` may be one ``WholePartSeg`` or a tuple of them (an ensemble,
``load_model`` with several checkpoints): the members' softmax is
averaged. ``predict_scan`` can add test-time votes.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from ..core.config import FLAGSHIP_SEG_ARGS, build_model_from_cfg, \
    resolve_device
from ..data.tooth_semi import FDI_LABEL_MAP, pc_norm
from ..models.segmentation.base_seg import init_weights
from .checkpoint import variables_of
from .eval import _upsample_pred, get_pred_whole, pad_to_bucket, \
    tta_vote_logits

# contiguous class id -> FDI code of the lower/upper jaw
_ID2FDI_LOWER = {0: 0, **{v: k for k, v in FDI_LABEL_MAP.items() if 30 < k < 50}}
_ID2FDI_UPPER = {0: 0, **{v: k for k, v in FDI_LABEL_MAP.items() if 10 < k < 30}}
_FDI_LUT_LOWER = np.array([_ID2FDI_LOWER[i]
                           for i in range(max(_ID2FDI_LOWER) + 1)], np.int32)
_FDI_LUT_UPPER = np.array([_ID2FDI_UPPER[i]
                           for i in range(max(_ID2FDI_UPPER) + 1)], np.int32)

Models = Union[torch.nn.Module, Sequence[torch.nn.Module]]


def map_pred_to_fdi(pred, jaw: int):
    """Contiguous class-id predictions -> python list of FDI codes."""
    lut = _FDI_LUT_LOWER if jaw == 0 else _FDI_LUT_UPPER
    return np.take(lut, np.asarray(pred, dtype=np.int64)).tolist()


def read_weights(path: str) -> Dict[str, torch.Tensor]:
    """A ``WholePartSeg`` state_dict from ``path``: a file written by
    ``torch.save`` of a state_dict (e.g. of ``engine.convert
    .params_from_jax``) or a checkpoint of the port's trainer (its
    student, with the EMA weights when the run's best-val selection chose
    them: ``use_ema: auto``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state" in sd and "model" in sd["state"]:
        sd = variables_of(sd, "auto")
    return sd


def load_model(seg_args: Optional[Dict[str, Any]] = None,
               ckpt: "str | Sequence[str] | None" = None, seed: int = 0,
               device: "str | torch.device" = "cuda") -> Models:
    """``WholePartSeg`` in eval mode on ``device``.

    ``seg_args`` defaults to the flagship; weights come from ``ckpt``
    (``read_weights``) or, without one, from a ``torch.Generator`` seeded
    with ``seed``. A list of checkpoints, or a comma-separated string of
    them, gives an ensemble: a tuple of models, one per member
    (``geot_tpu/engine/predict.py:load_model_and_params``)."""
    if isinstance(ckpt, str) and "," in ckpt:
        ckpt = [p for p in ckpt.split(",") if p]
    if isinstance(ckpt, (list, tuple)):
        members = tuple(load_model(seg_args, p, seed, device) for p in ckpt)
        return members[0] if len(members) == 1 else members
    device = resolve_device(device)
    model = build_model_from_cfg({"NAME": "WholePartSeg",
                                  "segmentor_args": seg_args or
                                  FLAGSHIP_SEG_ARGS})
    if ckpt:
        model.load_state_dict(read_weights(ckpt))
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def _members(model: Models):
    return tuple(model) if isinstance(model, (list, tuple)) else (model,)


def _mean_probs(members, batch) -> torch.Tensor:
    """The members' softmax averaged, (B, N, C)."""
    probs = None
    for m in members:
        p = torch.softmax(m(batch)[0], dim=-1)
        probs = p if probs is None else probs + p
    return probs / len(members)


def _logits(members, batch) -> torch.Tensor:
    """One member's logits, or an ensemble's mean probabilities as
    log-probabilities (softmax and argmax then see the average)."""
    if len(members) == 1:
        return members[0](batch)[0]
    return torch.log(_mean_probs(members, batch) + 1e-12)


@torch.no_grad()
def predict_scan(model: Models, points: np.ndarray, jaw: int = 0,
                 num_points: int = 16000,
                 seed: "int | np.random.Generator" = 0, num_votes: int = 0,
                 vote_transform=None):
    """points (P, 3) raw scan -> (full-res predictions (P,) np.uint8,
    sampled logits (N, C) on the model's device).

    ``seed`` seeds the sample's draw; a numpy ``Generator`` is drawn from
    as it is (``np.random.default_rng`` passes it through), so a caller can
    follow ``predict_stream``'s draw order. ``num_votes > 0`` averages the
    softmax over that many extra passes on positions transformed by
    ``vote_transform`` (the config's ``vote`` pipeline), drawn from the
    same generator after the sample."""
    members = _members(model)
    device = next(members[0].parameters()).device
    points_norm, center, scale = pc_norm(points.astype(np.float32))
    rng = np.random.default_rng(seed)
    sel = rng.choice(len(points_norm), num_points,
                     replace=len(points_norm) < num_points)
    pos_host = np.ascontiguousarray(points_norm[sel][None])
    pos = torch.from_numpy(pos_host).to(device)
    cls = torch.full((1, 1), jaw, dtype=torch.long, device=device)
    logits = _logits(members, {"pos": pos, "x": pos, "cls": cls})
    if num_votes:
        if vote_transform is None:
            raise ValueError("num_votes > 0 needs a vote transform pipeline "
                             "(datatransforms.vote)")
        logits = tta_vote_logits(
            logits, pos_host[0], num_votes, vote_transform, rng,
            lambda vpos: _logits(members, {"pos": vpos[None],
                                           "x": vpos[None], "cls": cls}))
    preds = get_pred_whole(logits, pos, [points], [center], [scale])
    return preds[0], logits[0]


def _pinned(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host tensor of ``a`` that a non-blocking copy to ``device`` can
    read: pinned for a CUDA device."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if device.type == "cuda" else t


@torch.no_grad()
def predict_stream(model: Models, items: Iterable, num_points: int = 16000,
                   seed: int = 0, inflight: int = 8, bucket: int = 8192):
    """Pipelined multi-scan inference (``geot_tpu/engine/predict.py:204``):
    ``items`` yields ``(name, points (P, 3), jaw)``; yields ``(name,
    points, preds (P,) np.uint8, jaw)`` in input order.

    One numpy generator seeded with ``seed`` draws every scan's sample in
    turn. Each scan's host work (normalise, sample, pad) runs while the
    card still works on up to ``inflight`` earlier scans: inputs go up from
    pinned host buffers and the uint8 labels come back into pinned buffers,
    both with non-blocking copies, and a scan's labels are read only once
    its copy's event has completed."""
    members = _members(model)
    device = next(members[0].parameters()).device
    rng = np.random.default_rng(seed)
    pending: collections.deque = collections.deque()

    def drain(n):
        while len(pending) > n:
            name, points, jaw, host, done, _ = pending.popleft()
            if done is not None:
                done.synchronize()
            yield name, points, host.numpy()[:len(points)], jaw

    for name, points, jaw in items:
        points = np.asarray(points, dtype=np.float32)
        points_norm, center, scale = pc_norm(points)
        sel = rng.choice(len(points_norm), num_points,
                         replace=len(points_norm) < num_points)
        up = [_pinned(a, device) for a in (
            points_norm[sel][None], pad_to_bucket(points, bucket),
            np.asarray(center, np.float32), np.float32(scale))]
        pos, full, c, s = (t.to(device, non_blocking=True) for t in up)
        cls = torch.full((1, 1), jaw, dtype=torch.long, device=device)
        probs = _mean_probs(members, {"pos": pos, "x": pos, "cls": cls})[0]
        pred = _upsample_pred(probs, pos[0], full, c, s).to(torch.uint8)
        host = _pinned(np.empty(pred.shape, np.uint8), device)
        host.copy_(pred, non_blocking=True)
        done = None
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        # the pinned inputs stay referenced until the scan is drained
        pending.append((name, points, jaw, host, done, up))
        yield from drain(inflight)
    yield from drain(0)
