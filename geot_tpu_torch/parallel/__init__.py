"""Data parallelism over ``torch.distributed`` (``dist``)."""
