"""geot_tpu_torch: GeoT on PyTorch and CUDA for NVIDIA Hopper.

The PyTorch counterpart of ``geot_tpu``. It serves the flagship
``PointTransformer_seg_T`` model; its two hot point ops (farthest point
sampling and small-k kNN) are hand-written CUDA kernels under ``csrc/``,
built with ``nvcc`` on first use and loaded through ``ctypes``.

Layout mirrors ``geot_tpu``: ``ops`` (point ops and kernel wrappers),
``models`` (the seg backbone and ``WholePartSeg``), ``engine`` (weight
conversion, full-resolution upsample, ``predict_scan`` and the HTTP
service). Entry points run on the card unless the caller passes
``device="cpu"``.
"""
from .core.config import FLAGSHIP_SEG_ARGS, resolve_device

__all__ = ["FLAGSHIP_SEG_ARGS", "resolve_device"]
