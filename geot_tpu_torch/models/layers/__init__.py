"""Building blocks of the models, channels-last
(``geot_tpu/models/layers/``): ``common`` (dense, normalisation, dropout,
the compute dtype, ``SharedMLP``), ``group`` (ball-query and kNN
grouping), ``local_aggregation`` (group, assemble, shared MLP, reduce;
ASSA), and the reference's layer surface: ``helpers``, ``weight_init``,
``drop``, ``mlp``, ``factories``, ``knn``, ``subsample``, ``kmeans``,
``graph_conv``, ``attention``, ``group_embed`` and ``patch_embed``, plus
the op-level names the reference republishes here (``gather_operation``
is channels-last, ``ops.gather_points``). ``__all__`` holds every name of
``geot_tpu.models.layers.__all__``."""
from .common import (GELU, BatchNorm, Dense, DropPath, Dropout, DtypeArg,
                     GroupNorm, LayerNorm, LeakyReLU, MlpBlock,
                     PointBatchNorm, SharedMLP, as_dtype, drop_path_rates,
                     gelu, make_divisible, rounded, softmax)
from .helpers import (MultipleSequential, to_1tuple, to_2tuple, to_3tuple,
                      to_4tuple, to_ntuple)
from .weight_init import lecun_normal_, trunc_normal_, variance_scaling_
from .drop import DropBlock2d, drop_block_2d, drop_block_fast_2d, drop_path
from .mlp import ConvMlp, GatedMlp, GluMlp, Mlp
from .group_embed import GroupTokenizer, SubsampleGroup
from .patch_embed import P3Embed, PointPatchEmbed
from .knn import KNN, DenseDilated, DilatedKNN, knn_point
from .subsample import furthest_point_sample, random_sample
from .group import (GroupAll, KNNGroup, QueryAndGroup, create_grouper,
                    get_aggregation_features)
# the reference's spelling (openpoints group.py:323)
from .group import get_aggregation_features as get_aggregation_feautres
from .local_aggregation import ASSA, CHANNEL_MAP, LocalAggregation
from .kmeans import KMeansEmbed, kmeans
from .attention import TransformerEncoder
from .graph_conv import (DenseDynBlock, DynConv, EdgeConv, GraphConv, MRConv,
                         ResDynBlock, gather_features)
from .factories import (Conv1d, Conv2d, CreateResConvBlock2D, create_act,
                        create_convblock1d, create_convblock2d,
                        create_linearblock, create_norm)
from ...ops import (fps, grouping_operation, three_interpolate,
                    three_interpolation, three_nn, torch_grouping_operation)
from ...ops import gather_points as gather_operation

__all__ = [
    "GELU", "BatchNorm", "Dense", "DropPath", "Dropout", "DtypeArg",
    "GroupNorm", "LayerNorm", "LeakyReLU", "MlpBlock", "PointBatchNorm",
    "SharedMLP", "as_dtype", "drop_path_rates", "gelu", "make_divisible",
    "rounded", "softmax", "MultipleSequential",
    "to_1tuple", "to_2tuple", "to_3tuple", "to_4tuple", "to_ntuple",
    "trunc_normal_", "variance_scaling_", "lecun_normal_",
    "DropBlock2d", "drop_block_2d", "drop_block_fast_2d", "drop_path",
    "Mlp", "GluMlp", "GatedMlp", "ConvMlp",
    "SubsampleGroup", "GroupTokenizer", "PointPatchEmbed", "P3Embed",
    "knn_point", "KNN", "DilatedKNN", "DenseDilated",
    "furthest_point_sample", "random_sample",
    "create_grouper", "QueryAndGroup", "KNNGroup", "GroupAll",
    "get_aggregation_features", "get_aggregation_feautres",
    "ASSA", "LocalAggregation", "CHANNEL_MAP", "kmeans", "KMeansEmbed",
    "MRConv", "EdgeConv", "GraphConv", "DynConv", "ResDynBlock",
    "DenseDynBlock", "gather_features", "TransformerEncoder",
    "create_act", "create_norm", "create_convblock1d", "create_convblock2d",
    "create_linearblock", "CreateResConvBlock2D", "Conv1d", "Conv2d",
    "fps", "grouping_operation", "gather_operation",
    "torch_grouping_operation", "three_nn", "three_interpolate",
    "three_interpolation",
]
