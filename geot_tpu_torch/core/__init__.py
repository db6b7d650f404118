"""Configs, registries, metrics, run directories and seeding
(``geot_tpu/core``)."""
from .registry import Registry, build_from_cfg
from .config import EasyConfig
from .metrics import (AverageMeter, ConfusionMatrix, IoU_from_confusions,
                      get_mious, partnet_metrics, shapenetpart_metrics)
from .logger import (generate_exp_directory, resume_exp_directory,
                     setup_logger_dist)
from .random import set_random_seed, str2bool

__all__ = [
    "Registry", "build_from_cfg", "EasyConfig", "AverageMeter",
    "ConfusionMatrix", "get_mious", "IoU_from_confusions",
    "partnet_metrics", "shapenetpart_metrics", "setup_logger_dist",
    "generate_exp_directory", "resume_exp_directory", "set_random_seed",
    "str2bool",
]
