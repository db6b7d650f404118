"""Models; importing this package registers them for
``core.config.build_model_from_cfg``."""
from .backbone.dgcnn import DGCNN, DGCNNGenEncoder
from .backbone.pointmlp import (PointMLPEncoder, PointMLPEncoderV2,
                                PointMLPGenEncoder, PointMLPPartSegmentor)
from .backbone.pointnetv2 import (PointNet2Decoder, PointNet2Encoder,
                                  PointNet2GenEncoder, PointNet2PartDecoder)
from .backbone.transformer import (PointTransformerGenEncoder,
                                   PointTransformerSeg, PointTransformerSegT,
                                   SigTMean)
from .generation.view_gen import (ViewDecoder, ViewDecoderBig, ViewDecoderDS,
                                  ViewGenBase, ViewTransformer)
from .classification.cls_base import BaseCls, ClsHead, DistillCls
from .segmentation.base_seg import (BasePartSeg, BaseSeg, InsTMean, SegHead,
                                    WholePartSeg)

__all__ = ["BaseCls", "BasePartSeg", "BaseSeg", "ClsHead", "DGCNN",
           "DGCNNGenEncoder", "DistillCls", "InsTMean", "PointMLPEncoder",
           "PointMLPEncoderV2", "PointMLPGenEncoder", "PointMLPPartSegmentor",
           "PointNet2Decoder", "PointNet2Encoder", "PointNet2GenEncoder",
           "PointNet2PartDecoder",
           "PointTransformerGenEncoder", "PointTransformerSeg",
           "PointTransformerSegT", "SegHead", "SigTMean", "ViewDecoder",
           "ViewDecoderBig", "ViewDecoderDS", "ViewGenBase",
           "ViewTransformer", "WholePartSeg"]
