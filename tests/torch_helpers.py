"""Helpers shared by the port's tests: the torch thread count of the CPU
tests, and the dtypes a model's layers compute in. Nothing here imports
JAX, so the card's tests use it too."""
import contextlib

import pytest
import torch

from geot_tpu_torch.models.layers.common import Dense


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the tests' small shapes run no faster on more,
    and the tier-1 run puts several test processes on the same cores.
    A test module takes it with ``from torch_helpers import
    one_torch_thread``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def dense_dtypes(*models: torch.nn.Module):
    """The set of dtypes the ``Dense`` layers of ``models`` return while
    the block runs: ``{torch.bfloat16, ...}`` once a model computes in
    bfloat16, ``{torch.float32}`` when it computes in float32."""
    seen = set()
    hooks = [m.register_forward_hook(lambda mod, args, out:
                                     seen.add(out.dtype))
             for model in models for m in model.modules()
             if isinstance(m, Dense)]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()
