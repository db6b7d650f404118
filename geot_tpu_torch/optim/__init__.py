"""The optimizer family and the learning-rate schedules
(``geot_tpu/optim``)."""
from .adahessian import hutchinson_diag, rademacher
from .factory import (ChainOptimizer, PlateauSchedule,
                      build_optimizer_from_cfg, build_scheduler_from_cfg,
                      needs_hessian, set_learning_rate)

__all__ = ["ChainOptimizer", "PlateauSchedule", "build_optimizer_from_cfg",
           "build_scheduler_from_cfg", "hutchinson_diag", "needs_hessian",
           "rademacher", "set_learning_rate"]
