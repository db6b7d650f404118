"""The training engine (``geot_tpu/engine``): the train states and the NTM
helpers here; the trainer, steps, evaluation and serving in their
modules."""
from .state import SemiTrainState, TrainState
from .semi import (LABEL_PROJ, estimate_class_T, gaussian_prior_T,
                   ntm_update, pseudo_stats)

__all__ = [
    "SemiTrainState", "TrainState",
    "LABEL_PROJ", "estimate_class_T", "gaussian_prior_T", "ntm_update",
    "pseudo_stats",
]
