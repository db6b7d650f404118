"""Models; importing this package registers them for
``core.config.build_model_from_cfg``."""
from .backbone.dgcnn import DGCNN, DGCNNGenEncoder
from .backbone.pointmlp import PointMLPGenEncoder, PointMLPPartSegmentor
from .backbone.pointnetv2 import (PointNet2Decoder, PointNet2Encoder,
                                  PointNet2GenEncoder)
from .backbone.transformer import (PointTransformerGenEncoder,
                                   PointTransformerSeg, PointTransformerSegT,
                                   SigTMean)
from .generation.view_gen import (ViewDecoder, ViewDecoderBig, ViewDecoderDS,
                                  ViewGenBase, ViewTransformer)
from .segmentation.base_seg import BaseSeg, InsTMean, SegHead, WholePartSeg

__all__ = ["BaseSeg", "DGCNN", "DGCNNGenEncoder", "InsTMean",
           "PointMLPGenEncoder", "PointMLPPartSegmentor", "PointNet2Decoder",
           "PointNet2Encoder", "PointNet2GenEncoder",
           "PointTransformerGenEncoder", "PointTransformerSeg",
           "PointTransformerSegT", "SegHead", "SigTMean", "ViewDecoder",
           "ViewDecoderBig", "ViewDecoderDS", "ViewGenBase",
           "ViewTransformer", "WholePartSeg"]
