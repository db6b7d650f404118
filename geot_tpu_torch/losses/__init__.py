"""The losses (``geot_tpu/losses``): the criterion registry, the
transition-matrix regularisers and the teacher contrastive loss."""
from .build import LOSS, LOSSES, build_criterion_from_cfg  # noqa: F401
from .inst_loss import (Idenyity_loss, feature_space_loss, identity_loss,
                        threeD_space_loss, threed_space_loss)
from .contrast import ContrastState, contrast_loss_t

__all__ = [
    "LOSS", "build_criterion_from_cfg",
    "feature_space_loss", "identity_loss", "threed_space_loss",
    "Idenyity_loss", "threeD_space_loss",
    "ContrastState", "contrast_loss_t",
]
