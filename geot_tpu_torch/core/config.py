"""Device choice, the flagship model and training arguments, and the model
registry.

``FLAGSHIP_SEG_ARGS`` is a plain dict copy of ``model.segmentor_args`` in
``cfgs/tooth_semi/transformer_finetune_fixmatch_ntm.yaml``, and
``FLAGSHIP_SEMI_CFG`` of the keys the semi-supervised step and loop read,
from that file merged over ``cfgs/tooth_semi/default.yaml``: the card's
machine has no YAML reader.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict

import torch

FLAGSHIP_SEG_ARGS: Dict[str, Any] = {
    "NAME": "PointTransformer_seg_T",
    "pretrained_path": None,
    "trans_dim": 384,
    "depth": 12,
    "num_heads": 4,
    "group_size": 32,
    "num_group": 512,
    "encoder_dims": 256,
    "nclasses": 17,
    "drop_path_rate": 0.1,
    "downsample_targets": [8192, 4096, 2048],
    "extract_layers": [4, 8, 12],
}


FLAGSHIP_SEMI_CFG: Dict[str, Any] = {
    "num_classes": 17,
    "num_points": 16000,
    "seed": 1609,
    "epochs": 300,
    "lr": 0.001,
    "optimizer": {"NAME": "adamw", "weight_decay": 1.0e-4},
    "sched": "multistep",
    "decay_epochs": [220],
    "decay_rate": 0.1,
    "warmup_epochs": 0,
    "grad_norm_clip": 1,
    "criterion_args": {"NAME": "Poly1FocalLoss"},
    "criterion_u_args": {"NAME": "Poly1FocalLoss_U_corr"},
    "threshold": 0.0,
    "unsupervised_loss_weight": 1.0,
    "lambma": 0.9,
    "geo_lambma": 0.999,
    "ema_t_decay": 0.999,
    "filter_outlier": False,
    "use_3d_loss": True,
    "threed_loss_weight": 0.1,
    "threed_k": 32,
    "threed_sigma": 1.0,
    "batch_size_l": 2,
    "batch_size_u": 2,
    "switch_ep": 50,
    "supervised_epochs": 0,
    "t_predictor": {"NAME": "Ins_T_mean",
                    "T_args": {"NAME": "sig_t_mean", "nclasses": 17}},
    "datatransforms": {
        "train": ["PointsToTensor", "PointCloudScaling",
                  "PointCloudCenterAndNormalize"],
        "train_w": ["PointsToTensor", "PointCloudCenterAndNormalize"],
        "train_s": ["PointsToTensor", "PointCloudScaling_s",
                    "PointCloudCenterAndNormalize", "PointCloudRotation_s",
                    "PointCloudTranslation_s"],
        "val": ["PointsToTensor", "PointCloudCenterAndNormalize"],
        "test": ["PointsToTensor", "PointCloudCenterAndNormalize"],
        "vote": ["PointCloudScaling"],
        "kwargs": {"jitter_sigma": 0.001, "jitter_clip": 0.005,
                   "scale": [0.9, 1.1], "gravity_dim": 1,
                   "shift": [0.1, 0.1, 0.1], "angle": [0.5, 0.5, 0.5],
                   "jitter_sigma_s": 0.001, "jitter_clip_s": 0.005,
                   "scale_s": [0.8, 1.2], "shift_s": [0.2, 0.2, 0.2],
                   "angle_s": [1, 1, 1]},
    },
}


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA unless the caller names the
    CPU; asking for CUDA without a card raises instead of running on the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


MODELS: Dict[str, Callable[..., torch.nn.Module]] = {}


def register_model(name: str):
    """Class decorator: make ``name`` buildable by ``build_model_from_cfg``."""
    def deco(cls):
        MODELS[name] = cls
        return cls
    return deco


def build_model_from_cfg(cfg: Dict[str, Any]) -> torch.nn.Module:
    """Build the model named by ``cfg["NAME"]`` with the remaining keys as
    arguments (``pretrained_path`` is a loader concern and is dropped)."""
    from .. import models  # noqa: F401  (registers the model classes)

    kwargs = copy.deepcopy(dict(cfg))
    name = kwargs.pop("NAME")
    kwargs.pop("pretrained_path", None)
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODELS)}")
    return MODELS[name](**kwargs)
