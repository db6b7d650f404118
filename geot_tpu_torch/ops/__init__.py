"""Point ops. ``fps``, ``fps_bucket``, ``knn_small_k`` and
``knn_small_k_pruned`` launch the CUDA kernels for CUDA tensors (``fps_block``
and ``knn_small_k_unsplit`` the first versions of the first and third);
every op runs its plain PyTorch version for CPU tensors. ``ball_query``
is plain PyTorch on both, as ``geot_tpu`` computes it in XLA."""
from ._build import LAUNCHES, reset_launches
from .ball_query import ball_query
from .fps import (FpsPlan, cluster_exchange, fps, fps_block, fps_bucket,
                  fps_bucket_plan, fps_bucket_ref, fps_cluster, fps_gather,
                  fps_plan, fps_ref, fps_stratified)
from .group import gather_points, grouping_operation
from .interpolate import three_interpolate, three_interpolation, three_nn
from .knn import (knn, knn_pruned_plan, knn_small_k, knn_small_k_pruned,
                  knn_small_k_pruned_ref, knn_small_k_ref,
                  knn_small_k_unsplit, knn_split_plan, pairwise_dist2)
from .morton import morton_codes, spatial_sort

__all__ = ["LAUNCHES", "reset_launches", "ball_query", "FpsPlan", "cluster_exchange",
           "fps", "fps_block", "fps_bucket", "fps_bucket_plan",
           "fps_bucket_ref", "fps_cluster", "fps_gather", "fps_plan",
           "fps_ref", "fps_stratified", "gather_points",
           "grouping_operation", "three_interpolate", "three_interpolation",
           "three_nn", "knn",
           "knn_pruned_plan", "knn_small_k", "knn_small_k_pruned",
           "knn_small_k_pruned_ref", "knn_small_k_ref",
           "knn_small_k_unsplit", "knn_split_plan", "morton_codes",
           "pairwise_dist2", "spatial_sort"]
