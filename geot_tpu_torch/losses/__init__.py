"""The losses (``geot_tpu/losses``): the criterion registry, the
transition-matrix regularisers and the teacher contrastive loss."""
from .build import (LOSSES, Poly1FocalLoss, Poly1FocalLossUCorr,
                    build_criterion_from_cfg)
from .contrast import ContrastState, contrast_loss_t
from .inst_loss import feature_space_loss, identity_loss, threed_space_loss

__all__ = ["LOSSES", "ContrastState", "Poly1FocalLoss",
           "Poly1FocalLossUCorr", "build_criterion_from_cfg",
           "contrast_loss_t", "feature_space_loss", "identity_loss",
           "threed_space_loss"]
