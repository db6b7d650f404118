"""Device choice, the flagship model arguments and the model registry.

The flagship arguments are a plain dict copy of ``model.segmentor_args`` in
``cfgs/tooth_semi/transformer_finetune_fixmatch_ntm.yaml``, so the serving
path reads no YAML.
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
