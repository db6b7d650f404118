"""The flagship recipe's losses (``geot_tpu/losses``)."""
from .build import (Poly1FocalLoss, Poly1FocalLossUCorr,
                    build_criterion_from_cfg)
from .inst_loss import threed_space_loss

__all__ = ["Poly1FocalLoss", "Poly1FocalLossUCorr",
           "build_criterion_from_cfg", "threed_space_loss"]
