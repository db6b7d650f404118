"""Layer helpers (``geot_tpu/models/layers/helpers.py``): the tuple
parsers ``to_ntuple`` and its family, and ``MultipleSequential``, a
sequential whose stages pass tuples on as positional arguments.
``make_divisible`` lives in ``common`` and is re-exported here."""
from __future__ import annotations

import collections.abc
from itertools import repeat
from typing import Any, Sequence

from torch import nn

from .common import make_divisible  # noqa: F401  (reference helpers.py:26)


def _ntuple(n):
    def parse(x):
        if isinstance(x, collections.abc.Iterable):
            return tuple(x)
        return tuple(repeat(x, n))

    return parse


to_1tuple = _ntuple(1)
to_2tuple = _ntuple(2)
to_3tuple = _ntuple(3)
to_4tuple = _ntuple(4)
to_ntuple = _ntuple


class MultipleSequential(nn.Module):
    """Runs ``layers`` in order; a stage that returns a tuple feeds the
    next one its entries as arguments. Modules among ``layers`` are held as
    ``layers_{i}``, the flax names; plain callables are kept unregistered."""

    def __init__(self, layers: Sequence[Any]):
        super().__init__()
        self.steps = []
        for i, layer in enumerate(layers):
            if isinstance(layer, nn.Module):
                self.add_module(f"layers_{i}", layer)
                self.steps.append(f"layers_{i}")
            else:
                self.steps.append(layer)

    def forward(self, *inputs):
        out: Any = inputs
        for step in self.steps:
            layer = getattr(self, step) if isinstance(step, str) else step
            out = layer(*out) if isinstance(out, tuple) else layer(out)
        return out
