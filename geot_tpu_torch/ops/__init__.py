"""Point ops. ``fps``, ``fps_bucket``, ``knn_small_k`` and
``knn_small_k_pruned`` launch the CUDA kernels for CUDA tensors (``fps_block``
and ``knn_small_k_unsplit`` the first versions of the first and third);
every op runs its plain PyTorch version for CPU tensors. ``fps`` and
``knn_small_k`` are the custom ops ``geot::fps`` and ``geot::knn_small_k``
(importing this package registers them); each picks its kernel by shape
(``fps_plan`` and ``bucket_capacity``, ``knn_route``), the bucket-pruned
kernels and their plans (``morton_codes_kernel``) included. ``ball_query``
is plain PyTorch on both, as ``geot_tpu`` computes it in XLA; so are
``fps_weighted``, the segment reductions (``scatter``), the vector-attention
primitives (``vector_attn``) and ``index_points``. ``grid_subsample`` and
``random_sample`` are host code (numpy; ``grid_subsample_native`` the C++
pooling). ``compat`` holds the reference's ``pointops`` and
``pointnet2_utils`` APIs over these ops."""
from ._build import LAUNCHES, reset_launches
from .ball_query import ball_query
from .fps import (FpsPlan, bucket_capacity, cluster_exchange, fps,
                  fps_block, fps_bucket, fps_bucket_plan, fps_bucket_ref,
                  fps_bucket_size, fps_cluster, fps_gather, fps_plan, fps_ref,
                  fps_stratified, fps_weighted)
from .group import (gather_points, grouping_operation, index_points,
                    torch_grouping_operation)
from .interpolate import (three_interpolate, three_interpolation, three_nn,
                          three_nn_weights)
from .knn import (KnnPrunedPlan, knn, knn_pruned_order, knn_pruned_plan,
                  knn_pruned_prepare, knn_pruned_prepare_ref, knn_route,
                  knn_small_k, knn_small_k_pruned, knn_small_k_pruned_ref,
                  knn_small_k_ref, knn_small_k_unsplit, knn_split,
                  knn_split_plan, knn_point, pairwise_dist2)
from .morton import morton_codes, morton_codes_joint, morton_codes_kernel
from .scatter import segment_max, segment_mean, segment_sum
from .subsample import grid_subsample, grid_subsample_native, random_sample
from .vector_attn import aggregation, subtraction

__all__ = ["LAUNCHES", "reset_launches", "ball_query", "FpsPlan",
           "bucket_capacity", "cluster_exchange",
           "fps", "fps_block", "fps_bucket", "fps_bucket_plan",
           "fps_bucket_ref", "fps_bucket_size", "fps_cluster", "fps_gather",
           "fps_plan",
           "fps_ref", "fps_stratified", "gather_points",
           "grouping_operation", "three_interpolate", "three_interpolation",
           "three_nn", "three_nn_weights", "KnnPrunedPlan", "knn",
           "knn_pruned_order", "knn_pruned_plan", "knn_pruned_prepare",
           "knn_pruned_prepare_ref",
           "knn_small_k", "knn_small_k_pruned",
           "knn_small_k_pruned_ref", "knn_small_k_ref",
           "knn_small_k_unsplit", "knn_split", "knn_split_plan", "knn_route",
           "morton_codes", "morton_codes_joint",
           "morton_codes_kernel", "pairwise_dist2", "fps_weighted",
           "index_points", "torch_grouping_operation", "knn_point",
           "segment_max", "segment_mean", "segment_sum", "grid_subsample",
           "grid_subsample_native", "random_sample", "aggregation",
           "subtraction"]
