"""Models; importing this package registers them for
``core.config.build_model_from_cfg``."""
from .backbone.transformer import PointTransformerSegT, SigTMean
from .segmentation.base_seg import InsTMean, WholePartSeg

__all__ = ["InsTMean", "PointTransformerSegT", "SigTMean", "WholePartSeg"]
