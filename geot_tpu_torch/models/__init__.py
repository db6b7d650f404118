"""Models; importing this package registers them for
``core.config.build_model_from_cfg``."""
from .backbone.transformer import PointTransformerSegT
from .segmentation.base_seg import WholePartSeg

__all__ = ["PointTransformerSegT", "WholePartSeg"]
