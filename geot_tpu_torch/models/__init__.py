"""Models; importing this package registers them for
``core.config.build_model_from_cfg``."""
from .backbone.dgcnn import DGCNN
from .backbone.pointmlp import PointMLPPartSegmentor
from .backbone.pointnetv2 import PointNet2Decoder, PointNet2Encoder
from .backbone.transformer import (PointTransformerSeg, PointTransformerSegT,
                                   SigTMean)
from .segmentation.base_seg import BaseSeg, InsTMean, SegHead, WholePartSeg

__all__ = ["BaseSeg", "DGCNN", "InsTMean", "PointMLPPartSegmentor",
           "PointNet2Decoder", "PointNet2Encoder", "PointTransformerSeg",
           "PointTransformerSegT", "SegHead", "SigTMean", "WholePartSeg"]
