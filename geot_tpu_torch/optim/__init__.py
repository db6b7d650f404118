"""Optimizer and learning-rate schedule (``geot_tpu/optim/factory.py``)."""
from .factory import (PlateauSchedule, build_optimizer_from_cfg,
                      build_scheduler_from_cfg, set_learning_rate)

__all__ = ["PlateauSchedule", "build_optimizer_from_cfg",
           "build_scheduler_from_cfg", "set_learning_rate"]
