"""Scan-level inference, the serving path, and the predict CLI
(``geot_tpu/engine/predict.py``).

    model = load_model()                      # flagship, seeded weights, CUDA
    labels, logits = predict_scan(model, points, jaw=0)
    for name, points, labels, jaw in predict_stream(model, scans): ...

    python -m geot_tpu_torch.engine.predict --cfg <yaml> --input <scan.obj |
        scan.npy | DIR> [--ckpt <file>[,<file> ...]] [--output <labels.json |
        DIR>] [--ply out.ply] [--votes N] [--jaw 0|1] [--fast] [--seed S]
        [k=v ...]

Pipeline: unit-sphere normalise -> sample ``num_points`` with numpy's
``default_rng(seed).choice`` (the same draw as ``geot_tpu``) -> forward ->
softmax -> 3-NN upsample to the full scan -> uint8 class ids -> FDI codes.

``load_model`` builds whatever a config's ``model`` names (``WholePartSeg``,
``BaseSeg``, ``PointMLPPartSegmentor``). ``model`` may be one model or a
tuple of them (an ensemble, ``load_model`` with several checkpoints): the
members' softmax is averaged. ``predict_scan`` can add test-time votes.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import time
from typing import Any, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from ..core.config import FLAGSHIP_SEG_ARGS, EasyConfig, \
    build_model_from_cfg, resolve_device
from ..data.io import load_obj_vertices
from ..data.tooth_semi import FDI_LABEL_MAP, pc_norm
from ..models.segmentation.base_seg import init_weights
from .checkpoint import (is_port_checkpoint, read_weights_file,
                         seg_t_depth, seg_t_weights, variables_of)
from .eval import _upsample_pred, get_pred_whole, pad_to_bucket, \
    tta_vote_logits
from .steps import _logits_of

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


def read_weights(path: str, depth: Optional[int] = 12
                 ) -> Dict[str, torch.Tensor]:
    """A model's state_dict from ``path``, by the file's content:
    - a checkpoint of the port's trainer (it holds ``state.model``): its
      student, with the EMA weights when the run's best-val selection chose
      them (``use_ema: auto``);
    - for a seg_T model (``depth``, the transformer's depth, not None): any
      other file is a reference GeoT checkpoint or state_dict, read by
      ``load_torch_pth`` and converted by ``convert_torch_seg_t`` (a
      state_dict file of the port, from ``torch.save``, ``convert_cli`` or
      ``engine.convert.params_from_jax``, carries the reference's names and
      converts to itself);
    - for another model (``depth=None``): a state_dict file of the port. A
      reference ``.pth`` holds seg_T weights only."""
    payload = read_weights_file(path)
    if is_port_checkpoint(payload):
        return variables_of(payload, "auto")
    if depth is not None:
        return seg_t_weights(path, depth, payload)
    if not isinstance(payload, dict):
        raise ValueError(f"{path} is neither a checkpoint nor a state_dict "
                         f"file of this package (a reference .pth holds "
                         f"PointTransformer_seg_T weights only)")
    return payload


def load_model(seg_args: Optional[Dict[str, Any]] = None,
               ckpt: "str | Sequence[str] | None" = None, seed: int = 0,
               device: "str | torch.device" = "cuda",
               model_cfg: Optional[Dict[str, Any]] = None) -> Models:
    """The model of ``model_cfg`` (a config's ``model``: ``WholePartSeg``,
    ``BaseSeg`` or ``PointMLPPartSegmentor``) in eval mode on ``device``
    (``geot_tpu/engine/predict.py:46 load_model_and_params``). Without
    ``model_cfg`` it is a ``WholePartSeg`` of ``seg_args``, by default the
    flagship's.

    Weights come from ``ckpt`` (``read_weights``: a port checkpoint, a
    state_dict file, or a reference ``.pth`` for the seg_T family) or,
    without one, from a ``torch.Generator`` seeded with ``seed``. A list of
    checkpoints, or a comma-separated string of them, gives an ensemble: a
    tuple of models, one per member."""
    if model_cfg is not None and seg_args is not None:
        raise ValueError("pass seg_args or model_cfg, not both")
    if model_cfg is None:
        model_cfg = {"NAME": "WholePartSeg",
                     "segmentor_args": seg_args or FLAGSHIP_SEG_ARGS}
    if isinstance(ckpt, str) and "," in ckpt:
        ckpt = [p for p in ckpt.split(",") if p]
    if isinstance(ckpt, (list, tuple)):
        members = tuple(load_model(ckpt=p, seed=seed, device=device,
                                   model_cfg=model_cfg) for p in ckpt)
        return members[0] if len(members) == 1 else members
    device = resolve_device(device)
    model = build_model_from_cfg(model_cfg)
    if ckpt:
        model.load_state_dict(read_weights(ckpt, seg_t_depth(model_cfg)))
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def _members(model: Models):
    return tuple(model) if isinstance(model, (list, tuple)) else (model,)


def _mean_probs(members, batch) -> torch.Tensor:
    """The members' softmax averaged, (B, N, C)."""
    probs = None
    for m in members:
        p = torch.softmax(_logits_of(m(batch)), dim=-1)
        probs = p if probs is None else probs + p
    return probs / len(members)


def _logits(members, batch) -> torch.Tensor:
    """One member's logits, or an ensemble's mean probabilities as
    log-probabilities (softmax and argmax then see the average)."""
    if len(members) == 1:
        return _logits_of(members[0](batch))
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


def _iter_scan_files(root: str, jaw: Optional[int] = None):
    """``(name, points, jaw)`` of every ``.obj`` and ``.npy`` scan in
    ``root``, by name; the jaw is ``jaw`` or, without it, lower (0) when
    the file name says ``lower``, else upper (1)."""
    names = sorted(n for n in os.listdir(root)
                   if os.path.splitext(n)[1].lower() in (".obj", ".npy"))
    for n in names:
        path = os.path.join(root, n)
        pts = (np.load(path) if n.lower().endswith(".npy")
               else load_obj_vertices(path))
        yield n, pts, (jaw if jaw is not None
                       else 0 if "lower" in n.lower() else 1)


def main(argv=None):
    """The predict CLI (``geot_tpu/engine/predict.py:300-402``): one scan
    to a labels JSON (and a coloured PLY), or a directory of scans streamed
    through ``predict_stream`` to a directory of per-scan JSON (and PLY)
    files. ``k=v`` overrides go to the config; ``device=cpu`` runs on the
    CPU. Returns the labels of one scan, or the number of scans written."""
    parser = argparse.ArgumentParser("GeoT inference (PyTorch/CUDA)")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--ckpt", default=None,
                        help="a checkpoint of the port's trainer, a "
                             "state_dict file or a reference GeoT .pth; "
                             "comma-separate several for a mean-softmax "
                             "ensemble; seeded random weights without one")
    parser.add_argument("--input", required=True,
                        help=".obj scan, .npy (P, 3), or a DIRECTORY of "
                             "scans (streamed)")
    parser.add_argument("--output", default="labels.json")
    parser.add_argument("--ply", default=None,
                        help="coloured PLY out; in directory mode any "
                             "value writes one PLY per scan beside its "
                             "JSON")
    parser.add_argument("--votes", type=int, default=0,
                        help="test-time voting passes over the config's "
                             "vote pipeline; single-scan mode only")
    parser.add_argument("--jaw", type=int, default=None,
                        help="0 lower / 1 upper; from the file name if "
                             "absent")
    parser.add_argument("--fast", action="store_true",
                        help="stratified-FPS pyramid (fast_pyramid=1024) + "
                             "fast_graph")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights without --ckpt")
    args, opts = parser.parse_known_args(argv)

    cfg = EasyConfig()
    cfg.load(args.cfg, recursive=True)
    cfg.update(opts)
    if args.fast:
        cfg.model.segmentor_args.fast_pyramid = 1024
        cfg.model.segmentor_args.fast_graph = True
    device = cfg.get("device", "cuda")
    num_points = int(cfg.get("num_points", 16000))

    def model():
        return load_model(ckpt=args.ckpt, seed=args.seed, device=device,
                          model_cfg=dict(cfg.model))

    if os.path.isdir(args.input):
        if args.votes:
            parser.error("--votes is single-scan only (the streaming path "
                         "runs one pass per scan)")
        models = model()
        os.makedirs(args.output, exist_ok=True)
        t0, n_done = time.time(), 0
        for name, points, pred, jaw in predict_stream(
                models, _iter_scan_files(args.input, jaw=args.jaw),
                num_points=num_points):
            labels = map_pred_to_fdi(pred, jaw)
            stem = os.path.splitext(name)[0]
            with open(os.path.join(args.output, stem + ".json"), "w") as f:
                json.dump({"labels": labels,
                           "jaw": "lower" if jaw == 0 else "upper",
                           "n_points": len(labels)}, f)
            if args.ply:
                from ..utils.vis3d import save_ply

                save_ply(os.path.join(args.output, stem + ".ply"), points,
                         labels=pred)
            n_done += 1
        dt = time.time() - t0
        print(f"wrote {n_done} scans to {args.output} in {dt:.2f}s "
              f"({n_done / max(dt, 1e-9):.1f} scans/s end-to-end)")
        return n_done

    jaw = args.jaw
    if jaw is None:
        # the file name only: a 'lower' in a directory name does not count
        jaw = 0 if "lower" in os.path.basename(args.input).lower() else 1
    points = (np.load(args.input) if args.input.lower().endswith(".npy")
              else load_obj_vertices(args.input))
    models = model()
    t0 = time.time()
    vote_t = None
    if args.votes:
        from ..data.transforms import build_transforms_from_cfg

        vote_t = build_transforms_from_cfg("vote", cfg.get("datatransforms"))
        if vote_t is None:
            parser.error("--votes needs a vote transform pipeline in the "
                         "config (datatransforms.vote)")
    pred, _ = predict_scan(models, points, jaw=jaw, num_points=num_points,
                           num_votes=args.votes, vote_transform=vote_t)
    dt = time.time() - t0
    labels = map_pred_to_fdi(pred, jaw)
    with open(args.output, "w") as f:
        json.dump({"labels": labels, "jaw": "lower" if jaw == 0 else "upper",
                   "n_points": len(labels), "seconds": dt}, f)
    print(f"wrote {args.output}: {len(labels)} labels in {dt:.2f}s")
    if args.ply:
        from ..utils.vis3d import save_ply

        save_ply(args.ply, points, labels=pred)
        print(f"wrote {args.ply}")
    return labels


if __name__ == "__main__":
    main()
