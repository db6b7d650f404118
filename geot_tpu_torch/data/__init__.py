"""The data side (``geot_tpu/data``): datasets, loaders, transforms and
dataset utilities."""
from .build import (DATASETS, build_dataloader_from_cfg,
                    build_dataset_from_cfg, build_semi_dataloader_from_cfg)
from .data_util import (crop_pc, get_class_weights, get_features_by_keys,
                        voxelize)
from .transforms import Compose, DataTransforms, build_transforms_from_cfg
from ..utils.vis3d import vis_multi_points, vis_points

__all__ = [
    "DATASETS", "build_dataloader_from_cfg", "build_semi_dataloader_from_cfg",
    "build_dataset_from_cfg", "get_class_weights", "get_features_by_keys",
    "crop_pc", "voxelize", "vis_points", "vis_multi_points",
    "DataTransforms", "build_transforms_from_cfg", "Compose",
]
