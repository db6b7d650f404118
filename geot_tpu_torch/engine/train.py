"""The training entry point (``geot_tpu/engine/train.py``) for the flagship
semi-supervised recipe, the supervised tooth zoo and the heritage tasks,
on one device:

    python -m geot_tpu_torch.engine.train \\
        --cfg cfgs/tooth_semi/transformer_finetune_fixmatch_ntm.yaml [k=v ...]
    python -m geot_tpu_torch.engine.train --cfg cfgs/tooth_sup/pointnet2.yaml
    python -m geot_tpu_torch.engine.train --cfg cfgs/scanobjectnn/pointnet2cls.yaml

``parse_and_run`` reads the config (``default.yaml`` files of the parent
directories first, then the named file, then the ``k=v`` overrides), makes
or reuses a run directory (``<root_dir>/<task>/<tags>-<stamp>-<uuid>/``
with ``checkpoint/``, the log, ``cfg.yaml``, ``scalars.jsonl`` and
``step_times.jsonl``) and calls ``main``. ``device=cpu`` on the command
line runs on the CPU; the default is the card, and without one it raises.

A config with ``dataset_u`` and ``criterion_u_args`` runs semi-supervised
(``semi_mode``, ``geot_tpu/engine/train.py:177``): a ``SemiTrainState``
of a ``WholePartSeg`` or ``WholePartSeg_ntm`` student (and teacher) over
``PointTransformer_seg_T``. A model with ``generator_args`` (a
``ViewGenBase``, ``cfgs/tooth_pretrain/viewgen.yaml``) runs GeoT's
pretraining stage, ``engine.pretrain.main``. ``task: cls`` runs
classification (``engine.cls.main``) and ``task: partseg`` part
segmentation (``engine.partseg.main``), the heritage tasks of
``cfgs/scanobjectnn`` and ``cfgs/shapenetpart`` (``geot_tpu/engine/
train.py:767-774``), through ``engine.taskloop``. Any other trains
supervised:
a ``TrainState`` of ``cfg.model`` (``WholePartSeg`` or ``WholePartSeg_ntm``
over any ``PointTransformer_seg*``, ``BaseSeg``, ``DistillBaseSeg``,
``VariableSeg`` or ``PointMLPPartSegmentor``), no teacher, T-predictor,
NTM or ``cm``, and every epoch supervised. ``pretrain_encoder_path`` (a
pretraining checkpoint or its run directory) grafts the pretrained encoder
trunk into the model before training
(``engine.checkpoint.load_pretrain_encoder``);
in semi mode the teacher starts from the grafted student. A ``plateau``
schedule is fed each validation's selected ``whole_miou``.

Data parallelism: ``python -m geot_tpu_torch.engine.launch --nprocs N --
--cfg ...`` starts N ranks (``engine.launch``), or a config's
``jax_distributed`` dict names the rendezvous (``parallel/dist.py``). Each
rank loads ``batch_size / N`` rows of every global train batch and runs the
step of ``engine.steps`` over the global batch; validation and test score
the whole split on every rank; only rank 0 writes scalars, logs, step
times and checkpoints, and every rank waits for a checkpoint before it can
read it. ``distributed: False`` keeps one process. One process never uses
more than its one device (``launch`` is the way to use several cards).

``main`` runs a mode:
- ``train``: in semi mode, bootstrap the class-mean matrix ``cm``, then
  per epoch the supervised step (epochs up to ``supervised_epochs``) or
  the semi step with the teacher's pseudo labels (up to ``switch_ep``) or
  the student's; in supervised mode the supervised step every epoch;
  validate every ``val_freq`` epochs and at the last one, checkpoint
  (``latest``, ``best``, ``E<epoch>`` every ``save_freq``), and every
  ``test_freq`` epochs and at the last one score the test split with the
  best checkpoint's weights;
- ``finetune``: the same from the weights of ``pretrained_path``, teacher
  included; ``finetune_encoder`` takes the encoder's weights only;
- ``resume``: continue a run from its checkpoint, whole state restored;
- ``val`` / ``test``: score a checkpoint's weights on that split.

``pretrained_path`` is a checkpoint of the port's trainer or a reference
GeoT ``.pth`` (told apart by content; ``_pretrained_weights``). A reference
file is read in every mode, ``train`` too, as ``geot_tpu`` reads one; its
weights are grafted by name (``engine.checkpoint.graft_state_dict``).

``model_t`` builds the teacher (the ``_fast.yaml`` recipe: a student in the
serving topology, an exact teacher); ``num_votes > 0`` adds test-time
voting over the config's ``vote`` pipeline to ``val`` / ``test`` and a
``test_voting`` pass after each test pass. A compute ``dtype`` other than
float32 is for serving and the eval modes; the training modes refuse it.

``ema_eval`` keeps an EMA shadow of the model (the student): validation
scores it and the raw weights (``val_raw``), the better of the two is the
candidate for ``best`` (``extra["ema_selected"]``), and the test pass
reloads that tree from the best checkpoint; ``use_ema`` picks the tree
that ``val`` / ``test`` / ``finetune`` load (``auto``: the run's own
selection for the eval modes, the raw weights for finetune). Steps skipped
by ``skip_nonfinite_updates`` are counted per epoch (``skipped_steps``).

``cfg.optimizer`` is any optimizer of ``geot_tpu``'s factory, with the
``lookahead`` prefix and ``layer_decay`` (``optim.factory``);
``step_per_update: k`` accumulates k gradients an update of the trained
model (the T-predictor updates every step); ``profile_epoch: N`` writes a
``torch.profiler`` Chrome trace of epoch N (the host's operators and the
card's kernels) to ``<run_dir>/trace/`` on rank 0; ``wandb.use_wandb``
starts the tracker on rank 0 (``engine.writer.Wandb``: a no-op without
``wandb``); ``eval_device_cache: False`` copies the validation and test
batches to the device on every pass instead of once.

SIGTERM or SIGINT during training means: finish the epoch, checkpoint, stop
(a second one stops at once). Metrics accumulate on the device and are
fetched once an epoch. What the port does not train (a training
``dtype``, ``tp``, ``sp``, ``fsdp``, and model or dataset names its
registries lack) raises ``NotImplementedError`` naming the key.
"""
from __future__ import annotations

import argparse
import copy
import inspect
import json
import logging
import os
import signal
import time
from typing import Any, Callable, Dict, Iterable

import numpy as np
import torch

from ..core.config import (EasyConfig, build_model_from_cfg, dump_yaml,
                           resolve_device)
from ..core.logger import (generate_exp_directory, resume_exp_directory,
                           setup_logger_dist)
from ..core.metrics import AverageMeter, cal_model_parm_nums
from ..core.random import set_random_seed
from ..data.build import (MODEL_KEYS, build_dataloader_from_cfg,
                          semi_keys, semi_pairs, to_device)
from ..data.transforms import build_transforms_from_cfg
from ..ops import LAUNCHES
from ..optim import build_scheduler_from_cfg
from ..parallel import dist
from .checkpoint import (ckpt_path, graft_state_dict, is_port_checkpoint,
                         load_checkpoint, load_pretrain_encoder,
                         load_variables, read_weights_file, save_checkpoint,
                         seg_t_depth, seg_t_weights, variables_of)
from .eval import validate
from .profiler import StepTimer
from .state import SemiTrainState, TrainState
from .steps import (make_cm_step, make_confusion_step, make_eval_step,
                    make_semi_step, make_supervised_step)
from .writer import SummaryWriter, Wandb

EVAL_MODES = ("val", "test", "eval", "testing", "evaluation")
# the model NAMEs the trainer builds (cfg.model.NAME)
TRAINED_MODELS = ("WholePartSeg", "WholePartSeg_ntm", "BaseSeg",
                  "DistillBaseSeg", "VariableSeg", "PointMLPPartSegmentor",
                  "ViewGenBase", "BaseCls", "DistillCls", "BasePartSeg")
# the semi recipe's student and teacher wrappers, and the segmentor whose
# forward gives the NTM update its sigma (geot_tpu/engine/semi.py:114-134
# fails without one)
SEMI_MODELS = ("WholePartSeg", "WholePartSeg_ntm")
SEMI_SEGMENTOR = "PointTransformer_seg_T"
# the config sections that name datasets
DATASET_KEYS = ("dataset", "dataset_l", "dataset_u")

# epoch scalars under the reference's tags (geot_tpu/engine/train.py:418-433)
# -> the step's metric
REF_TAGS = {"train_loss": "loss", "train_loss_l": "sup_loss",
            "train_loss_u": "unsup_loss", "th_percentage": "over_th",
            "train_over_th_acc": "pseudo_acc", "teacher_acc": "teacher_acc",
            "student_acc": "student_acc", "over_th_wobg": "over_th_wobg",
            "over_acc_wobg": "over_acc_wobg",
            "manifold_loss_feat": "feat_loss",
            "insT_identity_loss": "identity_loss",
            "insT_threed_loss": "threed_loss",
            "contrast_loss": "contrast_loss"}
CLS_TAGS = {"train_over_th_acc_class": "pseudo_acc_classwise",
            "train_over_th_num_class": "over_th_classwise",
            "train_over_th_recall_class": "over_th_recall_classwise"}

def cal_mean_feature(cm_step: Callable, model: torch.nn.Module,
                     loader: Iterable, num_classes: int,
                     device: "str | torch.device") -> torch.Tensor:
    """Class-conditional mean of the model's softmax over ``loader``: row c
    is the mean softmax of the points labelled c (``geot_tpu``'s fix of the
    reference's row-indexing bug). Sums accumulate in float64 on the host;
    returns (C, C) float32 on ``device``."""
    total = np.zeros((num_classes, num_classes), dtype=np.float64)
    counts = np.zeros((num_classes,), dtype=np.float64)
    for batch in loader:
        sums, cnts = cm_step(model, to_device(batch, MODEL_KEYS, device))
        total += sums.double().cpu().numpy()
        counts += cnts.double().cpu().numpy()
    total, counts = _summed_over_ranks(total, device), \
        _summed_over_ranks(counts, device)
    cm = total / np.maximum(counts[:, None], 1.0)
    return torch.from_numpy(cm.astype(np.float32)).to(device)


def cal_confusion(confusion_step: Callable, model: torch.nn.Module,
                  loader: Iterable, num_classes: int,
                  device: "str | torch.device") -> torch.Tensor:
    """The hard-label confusion matrix over ``loader``, each row divided by
    its own sum + 0.001 (``geot_tpu/engine/train.py:130``, the
    ``cm_bootstrap: confusion`` initialiser of ``cm``); (C, C) float32 on
    ``device``."""
    total = np.zeros((num_classes, num_classes), dtype=np.float64)
    for batch in loader:
        total += confusion_step(model, to_device(batch, MODEL_KEYS, device)
                                ).double().cpu().numpy()
    total = _summed_over_ranks(total, device)
    cm = total / (total.sum(1, keepdims=True) + 0.001)
    return torch.from_numpy(cm.astype(np.float32)).to(device)


def _summed_over_ranks(a: np.ndarray, device) -> np.ndarray:
    """A host array summed over the ranks (each rank's loader holds its
    shard of the split)."""
    if dist.world() == 1:
        return a
    t = dist.all_reduce_sum_(torch.from_numpy(a).to(device))
    return t.cpu().numpy()


def _rank0_metrics(res: Dict[str, float], device) -> Dict[str, float]:
    """Rank 0's values of a metrics dict on every rank, so that every rank
    makes rank 0's best-checkpoint choices."""
    if dist.world() == 1:
        return res
    keys = sorted(res)
    t = torch.tensor([float(res[k]) for k in keys], dtype=torch.float64,
                     device=device)
    dist.broadcast_(t)
    return dict(zip(keys, t.tolist()))


def _state_tensors(state) -> list:
    """The tensors a step updates: the model's weights and buffers and, in
    a semi state, the T-predictor's, ``ema_t`` and ``cm``."""
    out = list(state.model.state_dict().values())
    if isinstance(state, SemiTrainState):
        out += list(state.t_predictor.state_dict().values())
        out += [state.ema_t, state.cm]
    return out


def _launches_by_rank(before: Dict[str, int], device) -> list:
    """Each rank's kernel launches since ``before`` (a copy of
    ``ops.LAUNCHES``), in rank order: every rank fills its own row of a
    zero table and one all-reduce sums them."""
    names = list(before)
    rows = torch.zeros(dist.world(), len(names), dtype=torch.float64,
                       device=device)
    rows[dist.rank()] = torch.tensor(
        [LAUNCHES[k] - before[k] for k in names], dtype=torch.float64)
    dist.all_reduce_sum_(rows)
    return [{k: int(v) for k, v in zip(names, row)} for row in rows.tolist()]


def _draw_seed(device) -> int:
    """A run seed for a config without one, drawn on rank 0 once the
    process group has started and sent to every rank, so that every rank
    builds the same weights and draws (``geot_tpu/engine/train.py:706``
    draws it before the runtime joins)."""
    return dist.broadcast_object(int(np.random.randint(1, 10000)),
                                 dist.rank_device(device))


def refuse_unported(cfg) -> None:
    """Raise ``NotImplementedError`` naming the first key of ``cfg`` that
    the port does not train: a switch whose branch of ``geot_tpu``'s
    trainer the port lacks, a compute ``dtype`` other than float32 in a
    training mode, a model or dataset name the port's registries lack, a
    pretraining dataset (no labels) outside the pretraining stage, or a
    combination that ``geot_tpu``'s own trainer fails on (a model name
    in a role it cannot fill, an argument its module does not take, a
    semi-supervised model without the NTM's ``sigma``). ``parse_and_run``
    calls it before it makes a run directory."""
    model = cfg.get("model") or {}
    model_t = cfg.get("model_t") or {}
    mode = str(cfg.get("mode") or "train")
    training = mode not in EVAL_MODES
    semi = semi_mode(cfg)

    def reduced(m):
        dtype = (m.get("segmentor_args") or {}).get("dtype")
        return dtype not in (None, "float32")

    port = "not ported"
    refused = [
        ("model.segmentor_args.dtype", training and reduced(model), port),
        ("model_t.segmentor_args.dtype", training and reduced(model_t),
         port),
        ("tp", int(cfg.get("tp", 1) or 1) > 1, port),
        ("sp", int(cfg.get("sp", 1) or 1) > 1, port),
        ("fsdp", bool(cfg.get("fsdp")), port),
        ("model.NAME", model.get("NAME") not in TRAINED_MODELS
         or (semi and model.get("NAME") not in SEMI_MODELS), port),
        ("model_t.NAME", model_t.get("NAME", "WholePartSeg") not in
         SEMI_MODELS, port),
        *((k, True, port) for k in _unported_names(model, "model")),
        *((k, True, port) for k in _unported_names(model_t, "model_t")),
        *((k, True, port) for key in DATASET_KEYS
          for k in _unported_datasets(cfg.get(key), key)),
        *((k, True, "the dataset's items carry renders and no labels; "
           "geot_tpu's trainer fails on its batches outside pretraining")
          for key in DATASET_KEYS
          if "generator_args" not in model
          for k in _pretrain_only_datasets(cfg.get(key), key)),
        *((f"{key}.segmentor_args.NAME", True,
           "geot_tpu's NTM update needs the segmentor's sigma")
          for key, m in (("model", model), ("model_t", model_t))
          if semi and m.get("NAME") in SEMI_MODELS
          and (m.get("segmentor_args") or {}).get("NAME") != SEMI_SEGMENTOR),
        ("t_predictor.NAME", semi and (cfg.get("t_predictor") or {}).get(
            "NAME") != "Ins_T_mean",
         "the semi step calls the T-predictor with (softmax, cm)"),
        *((k, True, why) for k, why in _misplaced(model, "model",
                                                   training)),
        *((k, True, "geot_tpu's module takes no such argument")
          for k in _unknown_args(model, "model")),
    ]
    on = [(k, why) for k, v, why in refused if v]
    if on:
        key, why = on[0]
        raise NotImplementedError(
            f"{why}: {key}={_get(cfg, key)!r} (the port trains "
            f"{', '.join(TRAINED_MODELS)} in float32, data parallel "
            f"only; semi-supervised {' or '.join(SEMI_MODELS)} over "
            f"{SEMI_SEGMENTOR} with Ins_T_mean)")


# the compositions whose encoder gives per-level features, and those whose
# encoder gives one global feature
_SEG_COMPOSITIONS = ("BaseSeg", "BasePartSeg", "DistillBaseSeg",
                     "VariableSeg")
_CLS_COMPOSITIONS = ("BaseCls", "DistillCls")


def _misplaced(model, prefix: str, training: bool):
    """(dotted key, reason) of each model name that ``cfg.model``'s
    composition cannot use where it stands, judged from the port's
    classes (the same roles as ``geot_tpu``'s): a seg composition's
    encoder needs ``forward_seg_feat``, its decoder an
    ``encoder_channel_list``, and a trained head (B, N, C) logits (not
    ``MultiSegHead``'s stack: ``geot_tpu``'s ``MultiShapeCrossEntropy``
    fails on its loader's (B, 1) categories, and its evaluation indexes
    the stack's first axis as the batch); a cls composition's encoder a
    global ``forward_cls_feat`` (not the token encoders' (tokens,
    centers))."""
    from ..core.config import MODELS
    from .. import models  # noqa: F401  (registers the model classes)

    def cls_of(key):
        return MODELS.get((model.get(key) or {}).get("NAME"))

    name = model.get("NAME")
    enc, dec, head = (cls_of("encoder_args"), cls_of("decoder_args"),
                      cls_of("cls_args"))
    if name in _SEG_COMPOSITIONS:
        if enc is not None and not hasattr(enc, "forward_seg_feat"):
            yield (f"{prefix}.encoder_args.NAME",
                   "the encoder gives no per-level features")
        if dec is not None and "encoder_channel_list" not in \
                inspect.signature(dec).parameters:
            yield f"{prefix}.decoder_args.NAME", "it is not a decoder"
        if head is not None and training and getattr(head, "STACKED",
                                                     False):
            yield (f"{prefix}.cls_args.NAME", "geot_tpu's trainer cannot "
                   "train a per-category stack of logits")
    if name in _CLS_COMPOSITIONS and enc is not None and not getattr(
            enc, "GLOBAL_CLS_FEAT", hasattr(enc, "forward_cls_feat")):
        yield (f"{prefix}.encoder_args.NAME",
               "the encoder gives no global feature")


def _unknown_args(tree, prefix: str):
    """The dotted keys of the arguments that a named module of the model
    config does not take (a module that takes ``**kwargs`` takes any;
    ``generator_args`` is the trainer's key for the pretraining stage)."""
    from ..core.config import MODELS
    from .. import models  # noqa: F401  (registers the model classes)

    cls = MODELS.get((tree or {}).get("NAME"))
    if cls is not None:
        params = inspect.signature(cls).parameters
        if not any(p.kind is p.VAR_KEYWORD for p in params.values()):
            for key in tree:
                if key not in params and key not in (
                        "NAME", "pretrained_path", "generator_args"):
                    yield f"{prefix}.{key}"
    for key, value in (tree or {}).items():
        if isinstance(value, dict):
            yield from _unknown_args(value, f"{prefix}.{key}")


def semi_mode(cfg) -> bool:
    """True when ``cfg`` names an unlabelled set and its criterion
    (``geot_tpu/engine/train.py:177``)."""
    return "dataset_u" in cfg and "criterion_u_args" in cfg


def _unported_names(tree, prefix: str):
    """The dotted keys of every ``NAME`` below ``tree`` (a model config)
    that the port's model registry lacks."""
    from ..core.config import MODELS
    from .. import models  # noqa: F401  (registers the model classes)

    for key, value in (tree or {}).items():
        if key == "NAME" and value not in MODELS:
            yield f"{prefix}.NAME"
        elif isinstance(value, dict):
            yield from _unported_names(value, f"{prefix}.{key}")


def _unported_datasets(tree, prefix: str):
    """The dotted keys of every ``NAME`` in a dataset config (``common``
    and the splits) that the port's ``DATASETS`` lacks."""
    from ..data.build import DATASETS

    for key, value in (tree or {}).items():
        if isinstance(value, dict) and value.get("NAME") is not None \
                and value["NAME"] not in DATASETS:
            yield f"{prefix}.{key}.NAME"


def _pretrain_only_datasets(tree, prefix: str):
    """The dotted keys of every ``NAME`` in a dataset config whose dataset
    serves only the pretraining stage (``PRETRAIN_ONLY``: renders and
    views, no labels)."""
    from ..data.build import DATASETS

    for key, value in (tree or {}).items():
        if isinstance(value, dict) and getattr(
                DATASETS.get(value.get("NAME")), "PRETRAIN_ONLY", False):
            yield f"{prefix}.{key}.NAME"


def _get(cfg, dotted: str):
    for key in dotted.split("."):
        cfg = (cfg or {}).get(key)
    return cfg


def _pretrained_weights(cfg, path: str, mode: str, eval_only: bool,
                        logger) -> "Dict[str, torch.Tensor] | None":
    """The weights that ``pretrained_path`` gives this mode
    (``geot_tpu/engine/train.py:248-300``), or None:
    - a checkpoint of the port's trainer (it holds ``state.model``; the
      counterpart of ``geot_tpu``'s checkpoint directories) gives the
      student (its EMA shadow as ``use_ema`` picks it) to the eval modes,
      ``finetune`` and ``finetune_encoder``; ``mode=train`` does not read
      it;
    - any other file is a reference GeoT ``.pth``, read in every mode and
      converted to the seg_T family's state_dict; a file that does not
      convert (another model, a missing entry) is logged and the run
      trains from scratch, as in ``geot_tpu``."""
    payload = read_weights_file(path)
    if is_port_checkpoint(payload):
        if not (eval_only or mode in ("finetune", "finetune_encoder")):
            return None
        # use_ema (geot_tpu/engine/train.py:267-272): auto loads the tree
        # the source run selected for the eval modes, the raw weights for
        # finetune; true / false force it
        use_ema = cfg.get("use_ema", "auto")
        return variables_of(payload, ("auto" if eval_only else False)
                            if use_ema == "auto" else bool(use_ema))
    try:
        depth = seg_t_depth(cfg.model)
        if depth is None:
            raise ValueError(f"model.NAME={cfg.model.get('NAME')!r} is not "
                             f"of the PointTransformer_seg_T family")
        weights = seg_t_weights(path, depth, payload)
    except Exception as e:  # noqa: BLE001 - as geot_tpu: report, go on
        logger.warning(f"pretrain load failed ({e}); training from "
                       f"scratch")
        return None
    logger.info(f"loaded torch pretrain from {path}")
    return weights


def _load_pretrained(model: torch.nn.Module, weights, pretrained: str,
                     mode: str, eval_only: bool, logger) -> None:
    """Graft ``weights`` into ``model`` by name: the whole model, or the
    encoder only for ``mode=finetune_encoder``. An entry that keeps its
    fresh value (missing from the file, or of another shape) is fatal in
    an eval mode and logged otherwise; entries the model lacks are
    logged."""
    subtree = "encoder" if mode == "finetune_encoder" else None
    merged, skipped = graft_state_dict(model.state_dict(), weights, subtree)
    if skipped:
        bad = [k for k in skipped if not k.endswith("(unexpected)")]
        if bad and eval_only:
            raise ValueError(
                f"checkpoint {pretrained} does not cover the model: "
                f"{len(bad)} entries kept their fresh values "
                f"({bad[:5]}{'...' if len(bad) > 5 else ''})")
        logger.warning(f"checkpoint graft skipped {len(skipped)} entries: "
                       f"{skipped[:5]}{'...' if len(skipped) > 5 else ''}")
    model.load_state_dict(merged, strict=True)


class _Timed:
    """Iterate ``it``, adding the seconds spent waiting for each item to
    ``self.seconds``: the host's data time in the loop."""

    def __init__(self, it: Iterable):
        self.it = iter(it)
        self.seconds = 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t = time.perf_counter()
        try:
            return next(self.it)
        finally:
            self.seconds += time.perf_counter() - t


def _start_profile(cfg, device: torch.device, logger, epoch: int):
    """A started ``torch.profiler`` of the host's operators and, on the
    card, its kernels (``geot_tpu/engine/train.py:468-478``)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    logger.info(f"profiling epoch {epoch}")
    return prof


def _stop_profile(prof, cfg, logger, epoch: int) -> str:
    """Stop ``prof`` and write its Chrome trace to
    ``<run_dir>/trace/epoch<N>.json``; returns the path."""
    prof.stop()
    trace_dir = os.path.join(cfg.get("run_dir") or ".", "trace")
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"epoch{epoch}.json")
    prof.export_chrome_trace(path)
    logger.info(f"profile of epoch {epoch} -> {path}")
    return path


def main(cfg, device: "str | torch.device" = "cuda") -> Dict[str, Any]:
    """Run ``cfg``'s mode on ``device``; returns the last ``val`` and
    ``test`` metrics, ``best`` and, after a signal, ``preempted_at``."""
    device = resolve_device(device)
    refuse_unported(cfg)
    if cfg.get("distributed", "auto") is not False:
        dist.init(cfg, device)
    if "generator_args" in (cfg.get("model") or {}):
        # the pretraining stage (geot_tpu/engine/train.py:763-766)
        from .pretrain import main as pretrain_main
        return pretrain_main(cfg, device)
    device = dist.rank_device(device)
    primary = dist.is_primary()
    world, rank = dist.world(), dist.rank()
    mode = str(cfg.get("mode") or "train")
    eval_only = mode in EVAL_MODES
    semi = semi_mode(cfg)
    # built first: it refuses the step's unported switches
    semi_step = make_semi_step(cfg) if semi and not eval_only else None
    setup_logger_dist(cfg.get("log_path"), rank)
    logger = logging.getLogger()
    seed = int(cfg.get("seed", 0))
    set_random_seed(seed)
    # one writer: the scalars are rank 0's
    writer = (SummaryWriter(cfg.run_dir) if cfg.get("run_dir") and primary
              else None)
    if primary:
        # geot_tpu/engine/train.py:172-174
        Wandb.launch(cfg, bool((cfg.get("wandb") or {}).get("use_wandb")))
    num_classes = int(cfg.num_classes)
    tf = cfg.get("datatransforms")
    num_votes = int(cfg.get("num_votes", 0) or 0)
    vote_t = build_transforms_from_cfg("vote", tf) if num_votes else None
    if num_votes and vote_t is None:
        raise ValueError(f"num_votes={num_votes} needs a vote transform "
                         f"pipeline (datatransforms.vote)")

    def loader(batch_size, ds_cfg, split):
        # train loaders are sharded over the ranks; val and test are not,
        # so every rank scores the whole split alike
        # (geot_tpu/engine/train.py:188-208)
        shards = world if split == "train" else 1
        return build_dataloader_from_cfg(int(batch_size), ds_cfg, tf,
                                         split=split, seed=seed,
                                         num_shards=shards,
                                         shard_index=rank % shards,
                                         dataloader_cfg=cfg.get("dataloader"))

    val_loader = loader(cfg.get("batch_size_val", 2), cfg.dataset_l, "val")
    test_loader = loader(cfg.get("batch_size_test", 2), cfg.dataset_l, "test")
    train_loader_l = loader(cfg.get("batch_size_l", cfg.get("batch_size", 2)),
                            cfg.dataset_l, "train")
    train_loader_u = (loader(cfg.get("batch_size_u", 2), cfg.dataset_u,
                             "train") if semi else None)
    logger.info(f"datasets: train_l={len(train_loader_l.dataset)} "
                f"val={len(val_loader.dataset)} "
                f"test={len(test_loader.dataset)}"
                + (f" train_u={len(train_loader_u.dataset)}" if semi
                   else "") + f"; device {device}"
                + (f"; rank {rank} of {world} ({dist.backend()})"
                   if world > 1 else ""))
    eval_step = make_eval_step()

    pretrained = cfg.get("pretrained_path")
    weights = None
    if pretrained and os.path.isfile(str(pretrained)) and mode != "resume":
        weights = _pretrained_weights(cfg, str(pretrained), mode, eval_only,
                                      logger)
    if weights is None and pretrained and mode != "resume":
        # nothing was loaded: the path is missing, does not convert, or is
        # a port checkpoint that mode=train does not read
        msg = (f"pretrained_path={pretrained} was NOT loaded (exists="
               f"{os.path.exists(str(pretrained))}, mode={mode}; mode=train "
               f"reads only a reference .pth; use mode=finetune, "
               f"finetune_encoder or resume)")
        if eval_only or (mode == "finetune"
                         and not os.path.isfile(str(pretrained))):
            raise FileNotFoundError(msg)
        logger.warning(msg)
    elif eval_only and not pretrained:
        raise ValueError(f"mode={mode} (eval-only) requires pretrained_path")

    if eval_only:
        split = "test" if mode in ("test", "testing") else "val"
        model = build_model_from_cfg(cfg.model)
        _load_pretrained(model, weights, str(pretrained), mode, eval_only,
                         logger)
        model.to(device)
        res = _rank0_metrics(validate(
            eval_step, model, test_loader if split == "test" else
            val_loader, cfg, logger, num_votes=num_votes,
            data_transform=vote_t, tag=split), device)
        if writer:
            for k, v in res.items():
                writer.add_scalar(f"{mode}_{k}", v, 0)
            writer.close()
        return {split: res}

    model_t = cfg.get("model_t")
    if semi:
        state = SemiTrainState.create(
            cfg, seg_args=dict(cfg.model.segmentor_args), seed=seed,
            device=device, teacher_args=(dict(model_t.segmentor_args)
                                         if model_t else None),
            model_name=cfg.model.NAME,
            teacher_name=model_t.NAME if model_t else None)
    else:
        state = TrainState.create(cfg, cfg.model, seed=seed, device=device)
    pep = cfg.get("pretrain_encoder_path")
    if pep:
        # the pretraining stage's encoder trunk, grafted before the
        # teacher takes the student's weights, so both start from it
        # (geot_tpu/engine/train.py:226-246, 335-346)
        merged, pep_skipped = load_pretrain_encoder(
            state.model.state_dict(), str(pep))
        state.model.load_state_dict(merged, strict=True)
        logger.info(f"grafted pretrain encoder from {pep}"
                    + (f" ({len(pep_skipped)} anomalies: "
                       f"{pep_skipped[:3]})" if pep_skipped else ""))
    if weights is not None:
        _load_pretrained(state.model, weights, str(pretrained), mode,
                         eval_only, logger)
        logger.info(f"loaded weights from {pretrained}")
    if pep or weights is not None:
        if semi:
            state.teacher.load_state_dict(state.model.state_dict(),
                                          strict=True)
        if state.ema_params:
            state.seed_ema()
    logger.info(f"model params: "
                f"{cal_model_parm_nums(state.model) / 1e6:.3f} M")
    # a semi run's warm-up trains the student without the shadow, as
    # geot_tpu's semi trainer, whose supervised phase steps a TrainState
    # view that has none (geot_tpu/engine/train.py:538-541)
    sup_step = make_supervised_step(dict(cfg, ema_eval=None) if semi
                                    else cfg)
    schedule = build_scheduler_from_cfg(cfg)
    supervised_epochs = int(cfg.get("supervised_epochs", 0))
    switch_ep = int(cfg.get("switch_ep", 0))
    epochs = int(cfg.epochs)
    best: Dict[str, Any] = {"miou": 0.0, "dsc": 0.0, "acc": 0.0, "epoch": 0}
    results: Dict[str, Any] = {}
    start_epoch = int(cfg.get("start_epoch", 1))

    resume_missing: list = []
    if mode == "resume":
        if not (pretrained and os.path.isfile(str(pretrained))):
            raise FileNotFoundError(
                f"mode=resume requires pretrained_path pointing at a "
                f"checkpoint file; got {pretrained!r}")
        ckpt_epoch, extra = load_checkpoint(str(pretrained), state,
                                            missing_fields=resume_missing)
        start_epoch = ckpt_epoch + 1
        best.update(extra)
        logger.info(f"resumed from {pretrained} at epoch {ckpt_epoch}")
        if state.ema_params and "ema_params" in resume_missing:
            # a checkpoint from before the shadow (or saved with it off):
            # seed it from the restored weights, not the fresh init
            state.seed_ema()
            logger.info("ema_eval: seeded EMA shadow from restored weights")

    # cm from the current weights: fresh for train, loaded for finetune,
    # restored for a resume whose checkpoint lacks it (a whole-state resume
    # keeps its cm, so it continues as the uninterrupted run would)
    if semi and (mode != "resume" or "cm" in resume_missing):
        if cfg.get("cm_bootstrap", "mean_feature") == "confusion":
            state.cm = cal_confusion(make_confusion_step(num_classes),
                                     state.model, train_loader_l,
                                     num_classes, device)
        else:
            state.cm = cal_mean_feature(make_cm_step(), state.model,
                                        train_loader_l, num_classes, device)

    # every rank starts from the same state (a fresh one from the seed, or
    # the checkpoint it resumed from)
    dist.assert_same(_state_tensors(state), "states at the start")
    timer = StepTimer(os.path.join(cfg.run_dir, "step_times.jsonl")
                      if cfg.get("run_dir") and primary else None)
    # debug knob (geot_tpu's): per-step losses at full precision, a host
    # sync per step, the step's milliseconds to that sync, and each rank's
    # kernel launches in the step; under data parallelism also the check
    # that every rank holds the same state after each step
    step_log = bool(os.environ.get("GEOT_LOG_STEP_LOSS"))
    print_freq = int(cfg.get("print_freq", 0) or 0)
    profile_epoch = int(cfg.get("profile_epoch", 0) or 0)
    test_model = None

    preempted = {"sig": None}
    orig_handlers: Dict[int, Any] = {}

    def _restore_handlers():
        while orig_handlers:
            s, h = orig_handlers.popitem()
            signal.signal(s, h)

    def _on_preempt(signum, frame):
        preempted["sig"] = signum
        _restore_handlers()           # a second signal stops at once
        logger.warning(f"signal {signum}: will checkpoint and stop after "
                       f"the current epoch (repeat to force-exit)")

    try:
        for s in (signal.SIGTERM, signal.SIGINT):
            orig_handlers[s] = signal.signal(s, _on_preempt)
    except ValueError:
        pass                          # not the main thread

    try:
        for epoch in range(start_epoch, epochs + 1):
            prof = (_start_profile(cfg, device, logger, epoch)
                    if profile_epoch == epoch and primary else None)
            train_loader_l.set_epoch(epoch)
            lr = schedule(epoch)
            sums: Dict[str, torch.Tensor] = {}
            n = 0
            t0 = time.time()
            if semi and epoch > supervised_epochs:
                train_loader_u.set_epoch(epoch)
                use_teacher = epoch <= switch_ep
                batches = _Timed(semi_pairs(train_loader_l, train_loader_u))
                run = (lambda b: semi_step(
                    state, to_device(b[0], MODEL_KEYS, device),
                    to_device(b[1], semi_keys(b[1]), device), lr,
                    use_teacher))
            else:
                batches = _Timed(train_loader_l)
                run = (lambda b: sup_step(
                    state, to_device(b, MODEL_KEYS, device), lr))
            for batch in batches:
                if step_log:
                    before = dict(LAUNCHES)
                    t_step = time.perf_counter()
                metrics = run(batch)
                # on the device: a fetch per step would make the host wait
                # for every step
                sums = {k: sums[k] + v if k in sums else v.clone()
                        for k, v in metrics.items()}
                n += 1
                if step_log:
                    loss, sup, unsup = (float(metrics[k]) for k in
                                        ("loss", "sup_loss", "unsup_loss"))
                    # from the batch's copy to the device to the losses on
                    # the host, which waits for the step
                    step_ms = (time.perf_counter() - t_step) * 1e3
                    logger.info(f"steploss {epoch}/{n} {loss:.9f} "
                                f"sup {sup:.9f} unsup {unsup:.9f} "
                                f"ms {step_ms:.3f}")
                    logger.info(f"launches step {state.step} " + json.dumps(
                        _launches_by_rank(before, device)))
                    if world > 1:
                        dist.assert_same(_state_tensors(state),
                                         f"states after step {state.step}")
                        logger.info(f"ranks equal after step {state.step}")
                timer.tick(state.step, epoch=epoch)
                if print_freq and n % print_freq == 0:
                    logger.info(f"epoch {epoch} step {n} dispatched "
                                f"({time.time() - t0:.1f}s)")
            # the epoch's one fetch of its metrics
            keys = list(sums)
            flat = (torch.cat([sums[k].reshape(-1).double() for k in keys])
                    .cpu().numpy() if keys else np.zeros(0))
            ep_mean, at = {}, 0
            for k in keys:
                size = sums[k].numel()
                ep_mean[k] = flat[at:at + size].reshape(sums[k].shape) / n
                at += size
            if prof is not None:
                # the fetch above waited for the epoch's last kernel
                _stop_profile(prof, cfg, logger, epoch)
            wall = time.time() - t0
            meters = {k: AverageMeter() for k in ("loss", "sup_loss",
                                                  "unsup_loss")}
            for k in meters:
                meters[k].update(float(ep_mean.get(k, float("nan"))))
            logger.info(f"epoch {epoch}/{epochs} lr={lr:.6f} "
                        f"loss={meters['loss'].avg:.5f} "
                        f"sup={meters['sup_loss'].avg:.5f} "
                        f"unsup={meters['unsup_loss'].avg:.5f} "
                        f"({wall:.1f}s, data {batches.seconds:.1f}s)")
            n_skip = round(float(ep_mean.get("skipped", 0.0)) * n)
            if n_skip:
                logger.warning(f"epoch {epoch}: {n_skip}/{n} steps skipped "
                               f"(non-finite loss/gradients)")
                if writer:
                    writer.add_scalar("skipped_steps", n_skip, epoch)
            if writer:
                writer.add_scalar("lr", lr, epoch)
                writer.add_scalar("epoch_seconds", wall, epoch)
                writer.add_scalar("data_seconds", batches.seconds, epoch)
                for tag, key in REF_TAGS.items():
                    if key in ep_mean:
                        writer.add_scalar(tag, float(ep_mean[key]), epoch)
                for tag, key in CLS_TAGS.items():
                    if key in ep_mean:
                        for j, v in enumerate(np.ravel(ep_mean[key])):
                            writer.add_scalar(f"{tag}_{j}", float(v), epoch)

            # a frequency of 0 or None turns the periodic pass off; the
            # last epoch always runs it
            val_freq = int(cfg.get("val_freq", 250) or 0)
            if (val_freq and epoch % val_freq == 0) or epoch == epochs:
                ema_on = bool(state.ema_params)
                res = _rank0_metrics(validate(
                    eval_step, state.eval_model(), val_loader, cfg, logger),
                    device)
                results["val"] = res
                # the candidate for best: the better of the EMA and raw
                # weights (geot_tpu/engine/train.py:601-636)
                sel, sel_tree = res, ("ema" if ema_on else "raw")
                if ema_on:
                    res_raw = _rank0_metrics(validate(
                        eval_step, state.model, val_loader, cfg, logger,
                        tag="val_raw"), device)
                    results["val_raw"] = res_raw
                    if writer:
                        for k, v in res_raw.items():
                            writer.add_scalar(f"val_raw_{k}", v, epoch)
                    if res_raw["whole_miou"] > sel["whole_miou"]:
                        sel, sel_tree = res_raw, "raw"
                if hasattr(schedule, "note_metric"):
                    # the plateau schedule's feedback
                    # (geot_tpu/engine/train.py:622-623)
                    schedule.note_metric(sel["whole_miou"])
                is_best = (sel["whole_miou"] >= best["miou"]
                           or np.isnan(best["miou"]))
                if is_best and not np.isnan(sel["whole_miou"]):
                    best.update(miou=sel["whole_miou"], dsc=sel["whole_dsc"],
                                acc=sel["whole_acc"], epoch=epoch,
                                ema_selected=float(sel_tree == "ema"))
                if writer:
                    for k, v in res.items():
                        writer.add_scalar(f"val_{k}", v, epoch)
                    for k in ("miou", "dsc", "acc"):
                        writer.add_scalar(f"val_{k}", res[f"whole_{k}"],
                                          epoch)
                    for k in ("miou", "dsc", "acc"):
                        writer.add_scalar(f"best_val_{k}", best[k], epoch)
                if cfg.get("ckpt_dir"):
                    save_checkpoint(cfg, state, epoch, additional_dict=best,
                                    is_best=is_best,
                                    save_freq=cfg.get("save_freq"))

            test_freq = int(cfg.get("test_freq", 250) or 0)
            if (test_freq and epoch % test_freq == 0) or epoch == epochs:
                # the best validated weights, as the reference reloads them
                # before a test pass, of the tree that won there
                # (ema_selected); the training state is left as it is
                model = state.eval_model()
                best_path = (ckpt_path(cfg["ckpt_dir"],
                                       cfg.get("run_name", "run"), "best")
                             if cfg.get("ckpt_dir") else None)
                if best_path and os.path.exists(best_path):
                    if test_model is None:
                        test_model = copy.deepcopy(state.model)
                    test_model.load_state_dict(load_variables(
                        best_path, bool(best.get("ema_selected", 0))))
                    model = test_model
                    logger.info(f"test on the best checkpoint (epoch "
                                f"{best['epoch']})")
                res = validate(eval_step, model, test_loader, cfg, logger,
                               tag="test")
                results["test"] = res
                if writer:
                    for k, v in res.items():
                        writer.add_scalar(f"test_{k}", v, epoch)
                if num_votes:
                    res_v = validate(eval_step, model, test_loader, cfg,
                                     logger, num_votes=num_votes,
                                     data_transform=vote_t,
                                     tag="test_voting")
                    results["test_voting"] = res_v
                    if writer:
                        for k, v in res_v.items():
                            writer.add_scalar(f"test_{k}_voting", v, epoch)

            if preempted["sig"] is not None:
                if cfg.get("ckpt_dir"):
                    save_checkpoint(cfg, state, epoch, additional_dict=best,
                                    is_best=False)
                logger.warning(f"preempted (signal {preempted['sig']}) at "
                               f"epoch {epoch}: checkpoint saved; continue "
                               f"with mode=resume")
                results["preempted_at"] = epoch
                break
    finally:
        _restore_handlers()
        timer.close()
    results["best"] = best
    if writer:
        writer.close()
    return results


def parse_and_run(argv=None) -> Dict[str, Any]:
    """``--cfg <yaml> [k=v | --k v ...]``: load, override, join the process
    group (``parallel.dist.init``; a no-op for one process), draw the seed
    if the config has none, set up the run directory, write ``cfg.yaml``
    and run ``main`` on ``cfg.device`` (default ``cuda``)."""
    parser = argparse.ArgumentParser("geot_tpu_torch segmentation training")
    parser.add_argument("--cfg", type=str, required=True)
    args, opts = parser.parse_known_args(argv)
    cfg = EasyConfig()
    cfg.load(args.cfg, recursive=True)
    cfg.update(opts)
    refuse_unported(cfg)
    device = resolve_device(cfg.get("device", "cuda"))
    if cfg.get("distributed", "auto") is not False:
        dist.init(cfg, device)
    if cfg.get("seed") is None:
        cfg.seed = _draw_seed(device)

    path = os.path.abspath(args.cfg)
    cfg.task_name = os.path.basename(os.path.dirname(path))
    cfg.cfg_basename = os.path.splitext(os.path.basename(path))[0]
    mode = cfg.get("mode", "train")
    tags = [cfg.task_name, mode, cfg.cfg_basename, f"seed{cfg.seed}"]
    cfg.root_dir = os.path.join(cfg.get("root_dir", "./log"), cfg.task_name)
    if cfg.get("run_dir"):
        cfg.run_name = cfg.get("run_name") or "-".join(tags)
        cfg.ckpt_dir = cfg.get("ckpt_dir") or os.path.join(cfg.run_dir,
                                                           "checkpoint")
        os.makedirs(cfg.ckpt_dir, exist_ok=True)
    elif mode == "resume" or mode in EVAL_MODES:
        resume_exp_directory(cfg, pretrained_path=cfg.get("pretrained_path"))
    elif dist.world() > 1:
        raise ValueError("several ranks need one shared run_dir=<dir> "
                         "(engine.launch passes one)")
    else:
        generate_exp_directory(cfg, tags)
    # an evaluation in the run's directory keeps the run's cfg.yaml
    cfg_name = "cfg.yaml"
    if mode in EVAL_MODES and os.path.exists(os.path.join(cfg.run_dir,
                                                          "cfg.yaml")):
        cfg_name = f"cfg_{mode}.yaml"
    if dist.is_primary():
        with open(os.path.join(cfg.run_dir, cfg_name), "w") as f:
            f.write(dump_yaml(cfg.dict()))
    # the pretraining stage first, then the heritage tasks
    # (geot_tpu/engine/train.py:763-774)
    if "generator_args" not in (cfg.get("model") or {}):
        if cfg.get("task") == "partseg":
            from .partseg import main as partseg_main
            return partseg_main(cfg, device=device)
        if cfg.get("task") == "cls":
            from .cls import main as cls_main
            return cls_main(cfg, device=device)
    return main(cfg, device=device)


if __name__ == "__main__":
    parse_and_run()
    dist.shutdown()
