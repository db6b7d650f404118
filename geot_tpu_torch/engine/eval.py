"""Full-resolution prediction and validation
(``geot_tpu/engine/eval.py:26-300``): softmax the logits of the sample,
3-NN + inverse-distance interpolate them to every point of the raw scan and
take the argmax; for validation, count a (C, C) confusion matrix per scan on
the device and turn it into IoU, DSC and accuracy on the host. Test-time
voting (``tta_vote_logits``) averages the softmax over extra passes on
transformed positions.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops import three_nn


def pad_to_bucket(points: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad (P, 3) points to the next multiple of ``bucket``."""
    P = len(points)
    padded = np.zeros((-(-P // bucket) * bucket, 3), dtype=np.float32)
    padded[:P] = points
    return padded


def _upsample_pred(probs: torch.Tensor, pos: torch.Tensor,
                   full_points: torch.Tensor, center: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """probs (N, C) softmax; pos (N, 3) normalised sample; full (P, 3) raw.
    Returns argmax predictions (P,) on the full scan."""
    pos_world = pos * scale + center
    dist, idx = three_nn(full_points[None], pos_world[None])
    dist, idx = dist[0], idx[0].long()
    recip = 1.0 / (dist + 1e-8)
    weight = recip / recip.sum(dim=1, keepdim=True)
    logit_whole = (probs[idx] * weight[..., None]).sum(dim=1)
    return logit_whole.argmax(dim=-1)


# full scans are zero-padded to a multiple of this many points
BUCKET = 8192


@torch.no_grad()
def get_pred_whole(logits: torch.Tensor, pos: torch.Tensor, full_points_list,
                   centers, scales) -> List[np.ndarray]:
    """Per-sample full-resolution class ids (uint8: 17 classes fit a byte,
    and the copy to the host is 8x smaller than int64), computed on the
    device of ``logits``.

    logits (B, N, C) raw; pos (B, N, 3); full_points_list: list of (P_i, 3)
    numpy arrays."""
    device = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    preds = []
    for i, full in enumerate(full_points_list):
        full = np.asarray(full, dtype=np.float32)
        padded = torch.from_numpy(pad_to_bucket(full, BUCKET)).to(device)
        center = torch.from_numpy(
            np.asarray(centers[i], dtype=np.float32)).to(device)
        scale = torch.tensor(np.float32(scales[i]), device=device)
        pred = _upsample_pred(probs[i], pos[i], padded, center, scale)
        preds.append(pred.to(torch.uint8).cpu().numpy()[:len(full)])
    return preds


def tta_vote_logits(logits: torch.Tensor, pos_host: np.ndarray,
                    num_votes: int, transform, rng: np.random.Generator,
                    run_on_pos: Callable[[torch.Tensor], torch.Tensor]
                    ) -> torch.Tensor:
    """The reference's test-time voting (``geot_tpu/engine/eval.py:81``):
    the softmax of ``logits`` plus that of ``num_votes`` passes of
    ``run_on_pos`` over ``transform``-ed copies of ``pos_host``, averaged and
    returned as log-probabilities. The transform draws from ``rng`` on the
    host and sees ``pos_host`` as the caller has it: the batched (B, N, 3)
    positions in ``validate`` (one draw for the batch), one (N, 3) scan in
    ``predict_scan``."""
    probs = torch.softmax(logits, dim=-1)
    for _ in range(num_votes):
        voted = transform({"pos": np.asarray(pos_host).copy()}, rng)
        vpos = torch.from_numpy(np.ascontiguousarray(voted["pos"]))
        probs = probs + torch.softmax(
            run_on_pos(vpos.to(logits.device)), dim=-1)
    return torch.log(probs / (num_votes + 1) + 1e-12)


def _upsample_cm(probs: torch.Tensor, pos: torch.Tensor,
                 full_points: torch.Tensor, center: torch.Tensor,
                 scale: torch.Tensor, labels: torch.Tensor,
                 n_valid: int, num_classes: int = 17) -> torch.Tensor:
    """The full-resolution upsample of one scan and its (C, C) int32
    confusion matrix (rows the label, columns the prediction), on the
    device of ``probs``. ``full_points`` and ``labels`` are padded to a
    bucket; rows from ``n_valid`` on are padding and are not counted
    (``eval.py:105-119``)."""
    pred = _upsample_pred(probs, pos, full_points, center, scale)
    flat = labels.long() * num_classes + pred
    valid = torch.arange(pred.shape[0], device=pred.device) < n_valid
    flat = torch.where(valid, flat, num_classes * num_classes)
    cm = torch.bincount(flat, minlength=num_classes * num_classes + 1)
    return cm[:-1].to(torch.int32).reshape(num_classes, num_classes)


def _metrics_from_cm(cm: np.ndarray):
    """(accuracy, mIoU, mDSC) of a (C, C) label x prediction confusion
    matrix, in float64 (``eval.py:122``): the gum class 0 is excluded and
    classes absent from the labels are skipped; NaN where nothing is left
    to average."""
    cm = np.asarray(cm, dtype=np.float64)
    row, col, diag = cm.sum(1), cm.sum(0), np.diag(cm)
    ious, dscs = [], []
    for c in range(1, cm.shape[0]):
        if row[c] == 0:
            continue
        union = row[c] + col[c] - diag[c]
        iou = diag[c] / union if union > 0 else 0.0
        ious.append(iou)
        dscs.append(2 * iou / (1 + iou))
    total = cm.sum()
    acc = float(diag.sum() / total) if total else float("nan")
    miou = float(np.mean(ious)) if ious else float("nan")
    mdsc = float(np.mean(dscs)) if dscs else float("nan")
    return acc, miou, mdsc


def _eval_cache(loader, device: torch.device, bucket: int,
                keep: bool = True) -> List[Dict]:
    """The loader's batches as device tensors: each batch's model inputs
    and sampled labels, and per scan the padded full-resolution points and
    labels with their normalisation. With ``keep`` (``eval_device_cache``,
    the default) built on the first call and kept on the loader, keyed by
    device: val and test batches are the same every epoch (no
    ``set_epoch``, deterministic transforms); without, loaded and copied
    to the device on every call (``geot_tpu/engine/eval.py:174``)."""
    stored = getattr(loader, "_geot_eval_cache", None)
    if keep and stored is not None and stored[0] == device:
        return stored[1]

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    cache = []
    for batch in loader:
        entry = {"model_batch": {k: put(batch[k]) for k in ("pos", "x",
                                                             "cls")},
                 "pos_host": np.asarray(batch["pos"]),
                 "y": put(batch["y"]), "samples": []}
        for i, full in enumerate(batch["points"]):
            full = np.asarray(full, dtype=np.float32)
            padded = pad_to_bucket(full, bucket)
            lab = np.zeros((len(padded),), dtype=np.int64)
            lab[:len(full)] = np.asarray(batch["labels"][i])
            entry["samples"].append({
                "full": put(padded), "labels": put(lab),
                "center": put(np.asarray(batch["center"][i], np.float32)),
                "scale": put(np.float32(batch["scale"][i])),
                "n_valid": len(full),
                "side": int(np.asarray(batch["cls"][i]).reshape(-1)[0])})
        cache.append(entry)
    if keep:
        loader._geot_eval_cache = (device, cache)
    return cache


@torch.no_grad()
def validate(eval_step: Callable, model: torch.nn.Module, val_loader,
             cfg: Optional[Dict[str, Any]] = None,
             logger: Optional[logging.Logger] = None, num_votes: int = 0,
             data_transform=None, bucket: int = BUCKET,
             tag: str = "val") -> Dict[str, float]:
    """Whole-scan metrics of ``model`` over ``val_loader``
    (``geot_tpu/engine/eval.py:144``): per scan, the full-resolution
    confusion matrix gives accuracy, mIoU and mDSC; they are averaged over
    the mandible (``cls`` 0) scans, the maxillary (``cls`` 1) scans and all
    scans, plus ``sampled_acc``, the accuracy on the sampled points.

    ``num_votes > 0`` averages the softmax over that many extra passes on
    positions transformed by ``data_transform`` (the config's ``vote``
    pipeline), drawn from one numpy generator seeded with ``cfg.seed``
    (``tta_vote_logits``); without a transform it raises, where
    ``geot_tpu`` would quietly not vote.

    Everything runs on the device of ``model`` and is fetched to the host
    once, at the end."""
    if num_votes and data_transform is None:
        raise ValueError("num_votes > 0 needs a vote transform pipeline "
                         "(datatransforms.vote)")
    cfg = cfg or {}
    num_classes = int(cfg.get("num_classes", 17))
    vote_rng = np.random.default_rng(int(cfg.get("seed", 0)))
    param = next(model.parameters())

    def model_batch(batch):
        # the model reads its own float dtype; the upsample float32 points
        return {k: v.to(param.dtype) if v.is_floating_point() else v
                for k, v in batch.items()}

    cms, sides, accs = [], [], []
    for entry in _eval_cache(val_loader, param.device, bucket,
                             bool(cfg.get("eval_device_cache", True))):
        pos = entry["model_batch"]["pos"]
        logits = eval_step(model, model_batch(entry["model_batch"]))
        if num_votes:
            def run(vpos, batch=entry["model_batch"]):
                return eval_step(model, model_batch(dict(batch, pos=vpos,
                                                         x=vpos)))

            logits = tta_vote_logits(logits, entry["pos_host"], num_votes,
                                     data_transform, vote_rng, run)
        if logits.shape[-1] != num_classes:
            raise ValueError(f"cfg.num_classes={num_classes} != model "
                             f"classes {logits.shape[-1]}")
        accs.append((logits.argmax(-1) == entry["y"]).float().mean())
        probs = torch.softmax(logits, dim=-1)
        for i, s in enumerate(entry["samples"]):
            cms.append(_upsample_cm(probs[i], pos[i], s["full"],
                                    s["center"], s["scale"], s["labels"],
                                    s["n_valid"], num_classes))
            sides.append(s["side"])
    # one copy to the host: the confusion matrices and the sampled
    # accuracies in one float64 vector (counts below 2^53 are exact)
    C2 = num_classes * num_classes
    host = torch.cat([torch.stack(cms).reshape(-1).double(),
                      torch.stack(accs).double()]).cpu().numpy() \
        if cms else np.zeros((0,))
    cm_host = host[:len(cms) * C2].reshape(-1, num_classes, num_classes)
    acc_host = host[len(cms) * C2:]
    per_side: Dict[int, Dict[str, List[float]]] = {
        0: {"miou": [], "dsc": [], "acc": []},
        1: {"miou": [], "dsc": [], "acc": []}}
    for cm, side in zip(cm_host, sides):
        acc, miou, mdsc = _metrics_from_cm(cm)
        side_d = per_side[0 if side == 0 else 1]
        side_d["miou"].append(miou)
        side_d["dsc"].append(mdsc)
        side_d["acc"].append(acc)

    def mean(vals):
        return float(np.mean(vals)) if len(vals) else float("nan")

    out = {}
    for name, side in (("mandible", 0), ("maxillary", 1)):
        for k in ("miou", "dsc", "acc"):
            out[f"{name}_{k}"] = mean(per_side[side][k])
    n = len(sides)
    for k in ("miou", "dsc", "acc"):
        total = sum(per_side[0][k]) + sum(per_side[1][k])
        out[f"whole_{k}"] = total / n if n else float("nan")
    out["sampled_acc"] = mean(acc_host)
    if logger is not None:
        logger.info(f"{tag}: " + " ".join(f"{k}={v:.4f}"
                                          for k, v in out.items()))
    return out
