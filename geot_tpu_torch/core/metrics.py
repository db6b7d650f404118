"""The metric helpers of the training loops and the heritage protocols
(``geot_tpu/core/metrics.py:9-215``): ``AverageMeter``, the accumulating
``ConfusionMatrix``, the per-scan tooth metrics, ShapeNetPart's and
PartNet's part-IoU protocols, ``PSNR`` and the parameter counts. All on
numpy arrays on the host, as there."""
from __future__ import annotations

import math

import numpy as np
import torch


class AverageMeter:
    """Running average (``geot_tpu/core/metrics.py:9``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class ConfusionMatrix:
    """Accumulated per-class true positives, unions and label counts, and
    from them OA, mAcc and mIoU in percent; labels equal to
    ``ignore_index`` are left out."""

    def __init__(self, num_classes: int, ignore_index: int | None = None):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.tp = np.zeros(num_classes, dtype=np.int64)
        self.union = np.zeros(num_classes, dtype=np.int64)
        self.count = np.zeros(num_classes, dtype=np.int64)
        self.total = 0

    def reset(self):
        self.tp[:] = 0
        self.union[:] = 0
        self.count[:] = 0
        self.total = 0

    def update(self, pred, true):
        pred = np.asarray(pred).reshape(-1)
        true = np.asarray(true).reshape(-1)
        if self.ignore_index is not None:
            keep = true != self.ignore_index
            pred, true = pred[keep], true[keep]
        self.total += true.size
        for c in range(self.num_classes):
            pc = pred == c
            tc = true == c
            inter = int(np.logical_and(pc, tc).sum())
            self.tp[c] += inter
            self.union[c] += int(pc.sum()) + int(tc.sum()) - inter
            self.count[c] += int(tc.sum())

    @property
    def overall_accuracy(self) -> float:
        return float(self.tp.sum()) / max(self.total, 1)

    def all_metrics(self):
        """(OA, mAcc, mIoU, per-class IoU, per-class accuracy), percent;
        the means skip the classes that never occur."""
        with np.errstate(divide="ignore", invalid="ignore"):
            ious = np.where(self.union > 0,
                            self.tp / np.maximum(self.union, 1), np.nan)
            accs = np.where(self.count > 0,
                            self.tp / np.maximum(self.count, 1), np.nan)
        miou = float(np.nanmean(ious)) * 100.0
        macc = float(np.nanmean(accs)) * 100.0
        oa = self.overall_accuracy * 100.0
        return oa, macc, miou, ious * 100.0, accs * 100.0


def get_mious(tp, union, count):
    """(mIoU, mAcc, per-class IoU, per-class accuracy) in percent from the
    accumulated counts."""
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = tp / np.maximum(union, 1)
        acc = tp / np.maximum(count, 1)
    return (float(np.nanmean(iou)) * 100, float(np.nanmean(acc)) * 100,
            iou * 100, acc * 100)


def seg_metrics_whole(pred: np.ndarray, label: np.ndarray):
    """(acc, miou, mdsc) of one full-resolution scan: IoU and DSC averaged
    over the classes of the ground truth but the gum (class 0), accuracy
    over every point."""
    pred = np.asarray(pred).reshape(-1)
    label = np.asarray(label).reshape(-1)
    ious, dscs = [], []
    for c in np.unique(label):
        if c == 0:
            continue
        inter = np.logical_and(pred == c, label == c).sum()
        union = np.logical_or(pred == c, label == c).sum()
        iou = inter / union if union > 0 else 0.0
        ious.append(iou)
        dscs.append(2 * iou / (1 + iou))
    acc = float((pred == label).sum()) / label.size
    miou = float(np.mean(ious)) if ious else float("nan")
    mdsc = float(np.mean(dscs)) if dscs else float("nan")
    return acc, miou, mdsc


def IoU_from_confusions(confusions: np.ndarray) -> np.ndarray:
    """Per-class IoU of stacked confusion matrices (..., C, C), float32; a
    class absent from a matrix takes that matrix's mean IoU."""
    confusions = np.asarray(confusions, dtype=np.float64)
    tp = np.diagonal(confusions, axis1=-2, axis2=-1)
    tp_fn = confusions.sum(axis=-1)
    tp_fp = confusions.sum(axis=-2)
    iou = tp / (tp_fp + tp_fn - tp + 1e-6)
    absent = tp_fn < 1e-3
    counts = np.sum(~absent, axis=-1, keepdims=True)
    miou = iou.sum(axis=-1, keepdims=True) / (counts + 1e-6)
    return (iou + absent * miou).astype(np.float32)


def partnet_metrics(num_classes, num_parts, objects, preds, targets):
    """PartNet's shape and part mIoU: ``preds`` are per-shape
    (num_parts, num_points) logits, argmaxed over parts 1.. (part 0 is
    "other" and the points labelled 0 are left out). Returns (per-class
    shape IoU, per-class part IoU, their means)."""
    shape_iou_tot = np.zeros(num_classes)
    shape_iou_cnt = np.zeros(num_classes)
    inter = [np.zeros(num_parts[c]) for c in range(num_classes)]
    union = [np.full(num_parts[c], 1e-6) for c in range(num_classes)]
    for obj, pred, gt in zip(objects, preds, targets):
        obj = int(obj)
        lab = np.argmax(np.asarray(pred)[1:, :], axis=0) + 1
        lab[np.asarray(gt) == 0] = 0
        tot = cnt = 0.0
        for j in range(1, num_parts[obj]):
            gm = np.asarray(gt) == j
            pm = lab == j
            if gm.any() or pm.any():
                i = np.sum(gm & pm)
                u = np.sum(gm | pm)
                tot += i / u
                cnt += 1
                inter[obj][j] += i
                union[obj][j] += u
        if cnt:
            shape_iou_tot[obj] += tot / cnt
            shape_iou_cnt[obj] += 1
    ms_iou = [shape_iou_tot[c] / max(shape_iou_cnt[c], 1e-6)
              for c in range(num_classes)]
    mp_iou = [float(np.mean(inter[c][1:] / union[c][1:]))
              for c in range(num_classes)]
    return ms_iou, mp_iou, float(np.mean(ms_iou)), float(np.mean(mp_iou))


def shapenetpart_metrics(num_classes, num_parts, objects, preds, targets,
                         masks):
    """ShapeNetPart's accuracy and class- and instance-average mIoU from
    per-shape (parts, points) logits over the masked points: (acc,
    per-class mIoU, class average, instance average)."""
    total_correct = total_seen = 0.0
    confs = []
    objects = np.asarray(objects, dtype=np.int64)
    for obj, pred, gt, mask in zip(objects, preds, targets, masks):
        parts = num_parts[int(obj)]
        lab = np.argmax(np.asarray(pred), axis=0)[np.asarray(mask)]
        gt = np.asarray(gt)[np.asarray(mask)]
        total_correct += np.sum(lab == gt)
        total_seen += lab.size
        cm = np.bincount(gt * parts + lab, minlength=parts * parts)
        confs.append(cm.reshape(parts, parts))
    obj_mious = []
    for c in range(num_classes):
        idx = np.where(objects == c)[0]
        if len(idx) == 0:
            continue
        stacked = np.stack([confs[i] for i in idx])
        obj_mious.append(np.mean(IoU_from_confusions(stacked), axis=-1))
    objs_average = [float(np.mean(m)) for m in obj_mious]
    instance_average = float(np.mean(np.hstack(obj_mious)))
    class_average = float(np.mean(objs_average))
    acc = total_correct / max(total_seen, 1e-6)
    return acc, objs_average, class_average, instance_average


def PSNR(mse, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio of an MSE, in dB."""
    return 10.0 * math.log10((peak ** 2) / mse)


def cal_model_parm_nums(module: torch.nn.Module) -> int:
    """Number of parameter elements of a module
    (``geot_tpu/core/metrics.py:193``)."""
    return sum(p.numel() for p in module.parameters())


def cal_model_parm_nums_separate(module: torch.nn.Module):
    """(total, encoder, generator, decoder) parameter elements: those whose
    name holds ``encoder``, ``generator`` and ``decoder``."""
    named = [(n, p.numel()) for n, p in module.named_parameters()]

    def count(word):
        return sum(k for n, k in named if word is None or word in n)

    return (count(None), count("encoder"), count("generator"),
            count("decoder"))
