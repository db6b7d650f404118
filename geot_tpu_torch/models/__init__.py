"""Models; importing this package registers them for
``core.config.build_model_from_cfg``."""
from .backbone.dgcnn import DGCNN, DGCNNGenEncoder
from .backbone.pointmlp import (PointMLPEncoder, PointMLPEncoderV2,
                                PointMLPGenEncoder, PointMLPPartSegmentor)
from .backbone.pointnetv2 import (PointNet2Decoder, PointNet2Encoder,
                                  PointNet2GenEncoder, PointNet2PartDecoder)
from .backbone.transformer import (GraghMatching, PointTransformerEncoder,
                                   PointTransformerGenEncoder,
                                   PointTransformerGenEncoderSeg,
                                   PointTransformerSeg,
                                   PointTransformerSeg2Classifier,
                                   PointTransformerSegClassifier,
                                   PointTransformerSegCluster,
                                   PointTransformerSegT, SigT, SigTMean)
from .layers.patch_embed import P3Embed, PointPatchEmbed
from .generation.view_gen import (ViewDecoder, ViewDecoderBig, ViewDecoderDS,
                                  ViewGenBase, ViewTransformer)
from .classification.cls_base import BaseCls, ClsHead, DistillCls
from .segmentation.base_seg import (BasePartSeg, BaseSeg, DistillBaseSeg,
                                    InsT, InsTMean, MultiSegHead, SegHead,
                                    VariableSeg, VariableSegHead,
                                    WholePartSeg, WholePartSegNTM)

__all__ = ["BaseCls", "BasePartSeg", "BaseSeg", "ClsHead", "DGCNN",
           "DGCNNGenEncoder", "DistillBaseSeg", "DistillCls",
           "GraghMatching", "InsT", "InsTMean", "MultiSegHead", "P3Embed",
           "PointMLPEncoder", "PointMLPEncoderV2", "PointMLPGenEncoder",
           "PointMLPPartSegmentor", "PointNet2Decoder", "PointNet2Encoder",
           "PointNet2GenEncoder", "PointNet2PartDecoder", "PointPatchEmbed",
           "PointTransformerEncoder", "PointTransformerGenEncoder",
           "PointTransformerGenEncoderSeg", "PointTransformerSeg",
           "PointTransformerSeg2Classifier", "PointTransformerSegClassifier",
           "PointTransformerSegCluster", "PointTransformerSegT", "SegHead",
           "SigT", "SigTMean", "VariableSeg", "VariableSegHead",
           "ViewDecoder", "ViewDecoderBig", "ViewDecoderDS", "ViewGenBase",
           "ViewTransformer", "WholePartSeg", "WholePartSegNTM"]
