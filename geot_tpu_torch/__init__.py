"""geot_tpu_torch: GeoT on PyTorch and CUDA for NVIDIA Hopper.

The PyTorch counterpart of ``geot_tpu``. It serves the flagship
``PointTransformer_seg_T`` model and runs its FixMatch + noise-transition
train step; its point ops (farthest point sampling and small-k kNN, each
plain and Morton-bucket-pruned) are hand-written CUDA kernels under
``csrc/``, built with ``nvcc`` on first use and loaded through ``ctypes``;
the two on the paths are the ``torch.library`` ops ``geot::fps`` and
``geot::knn_small_k``, which ``torch.export`` keeps in an exported forward.

Layout mirrors ``geot_tpu``: ``ops`` (point ops and kernel wrappers),
``models`` (the seg backbone, ``WholePartSeg`` and the T-predictor),
``data`` (synthetic semi-supervised datasets, transforms, loader),
``losses``, ``optim``, ``engine`` (weight conversion, train state and
step, full-resolution upsample, ``predict_scan``, the HTTP service,
export and the multi-process launcher), ``parallel`` (data parallelism).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from .core.config import FLAGSHIP_SEG_ARGS, FLAGSHIP_SEMI_CFG, resolve_device

__all__ = ["FLAGSHIP_SEG_ARGS", "FLAGSHIP_SEMI_CFG", "resolve_device"]
