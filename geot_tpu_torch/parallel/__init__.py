"""Data parallelism over ``torch.distributed`` (``dist``), and
``geot_tpu/parallel``'s process helpers."""
from .dist import find_free_port, get_dist_info

__all__ = ["find_free_port", "get_dist_info"]
