"""Building blocks of the models, channels-last
(``geot_tpu/models/layers/``): ``common`` (dense, normalisation, dropout,
the compute dtype, ``SharedMLP``), ``group`` (ball-query and kNN
grouping) and ``local_aggregation`` (group, assemble, shared MLP,
reduce)."""
from .common import (GELU, BatchNorm, Dense, DropPath, Dropout, DtypeArg,
                     GroupNorm, LayerNorm, LeakyReLU, MlpBlock, SharedMLP,
                     as_dtype, gelu, rounded, softmax)
from .group import (GroupAll, KNNGroup, QueryAndGroup, create_grouper,
                    get_aggregation_features)
from .local_aggregation import CHANNEL_MAP, LocalAggregation

__all__ = ["GELU", "BatchNorm", "Dense", "DropPath", "Dropout", "DtypeArg",
           "GroupNorm", "LayerNorm", "LeakyReLU", "MlpBlock", "SharedMLP",
           "as_dtype", "gelu", "rounded", "softmax", "GroupAll", "KNNGroup",
           "QueryAndGroup", "create_grouper", "get_aggregation_features",
           "CHANNEL_MAP", "LocalAggregation"]
