"""Models (``geot_tpu/models``): ``MODELS`` and ``build_model_from_cfg``;
importing this package registers every model class."""
from ..core.config import MODELS, build_model_from_cfg

# imported for their registrations
from .backbone import dgcnn, pointmlp, pointnetv2, transformer  # noqa: F401
from .classification import cls_base  # noqa: F401
from .generation import view_gen  # noqa: F401
from .layers import patch_embed  # noqa: F401
from .segmentation import base_seg  # noqa: F401

__all__ = ["MODELS", "build_model_from_cfg"]
