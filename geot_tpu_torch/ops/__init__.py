"""Point ops. ``fps``, ``fps_bucket``, ``knn_small_k`` and
``knn_small_k_pruned`` launch the CUDA kernels for CUDA tensors; every op
runs its plain PyTorch version for CPU tensors."""
from ._build import LAUNCHES, reset_launches
from .fps import (fps, fps_bucket, fps_bucket_plan, fps_bucket_ref,
                  fps_gather, fps_ref)
from .group import gather_points, grouping_operation
from .interpolate import three_interpolate, three_interpolation, three_nn
from .knn import (knn, knn_pruned_plan, knn_small_k, knn_small_k_pruned,
                  knn_small_k_pruned_ref, knn_small_k_ref, pairwise_dist2)
from .morton import morton_codes, spatial_sort

__all__ = ["LAUNCHES", "reset_launches", "fps", "fps_bucket",
           "fps_bucket_plan", "fps_bucket_ref", "fps_gather", "fps_ref",
           "gather_points", "grouping_operation", "three_interpolate",
           "three_interpolation", "three_nn", "knn", "knn_pruned_plan",
           "knn_small_k", "knn_small_k_pruned", "knn_small_k_pruned_ref",
           "knn_small_k_ref", "morton_codes", "pairwise_dist2",
           "spatial_sort"]
