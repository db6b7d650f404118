"""The optimizer family and the learning-rate schedules
(``geot_tpu/optim``)."""
from .adahessian import adahessian, hutchinson_diag, rademacher  # noqa: F401
from .factory import (ChainOptimizer, PlateauSchedule,  # noqa: F401
                      build_optimizer_from_cfg, build_scheduler_from_cfg,
                      needs_hessian, set_learning_rate)

__all__ = ["build_optimizer_from_cfg", "build_scheduler_from_cfg",
           "adahessian", "hutchinson_diag", "PlateauSchedule"]
