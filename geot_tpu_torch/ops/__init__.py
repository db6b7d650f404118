"""Point ops. ``fps`` and ``knn_small_k`` launch the CUDA kernels for CUDA
tensors; every op runs its plain PyTorch version for CPU tensors."""
from ._build import LAUNCHES, reset_launches
from .fps import fps, fps_gather, fps_ref
from .group import gather_points, grouping_operation
from .interpolate import three_interpolate, three_interpolation, three_nn
from .knn import knn, knn_small_k, knn_small_k_ref, pairwise_dist2

__all__ = ["LAUNCHES", "reset_launches", "fps", "fps_gather", "fps_ref",
           "gather_points", "grouping_operation", "three_interpolate",
           "three_interpolation", "three_nn", "knn", "knn_small_k",
           "knn_small_k_ref", "pairwise_dist2"]
