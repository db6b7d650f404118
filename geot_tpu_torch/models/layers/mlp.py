"""MLP blocks (``geot_tpu/models/layers/mlp.py``): ``Mlp``, ``GluMlp``,
``GatedMlp`` and ``ConvMlp`` with the ``act_args`` surface, channels-last
(``ConvMlp``'s 1x1 convs are ``Dense`` too; it keeps its own structure: a
norm after fc1, one dropout, none at the end).

flax infers the input width; here ``in_features`` is required. Dropout
masks come from the ``generator`` passed to ``forward`` (torch's default
generator when it is None)."""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from .common import Dense, DtypeArg, Dropout
from .factories import create_act, create_norm
from .helpers import to_2tuple


class _MlpBase(nn.Module):
    default_act = "gelu"

    def __init__(self, in_features: int, hidden_features: Optional[int],
                 out_features: Optional[int], act_args: Any, drop: Any):
        super().__init__()
        self.out = out_features or in_features
        self.hidden = hidden_features or in_features
        act = create_act(act_args if act_args is not None
                         else {"act": self.default_act})
        if isinstance(act, nn.Module):      # PReLU, named as flax binds it
            self.add_module(f"{act.flax_name}_0", act)
        self.fns = {"act": act}
        d1, d2 = to_2tuple(drop)
        self.drop1, self.drop2 = Dropout(d1), Dropout(d2)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return self.fns["act"](x)


class Mlp(_MlpBase):
    """fc1 -> act (gelu) -> dropout -> fc2 -> dropout."""

    def __init__(self, in_features: int,
                 hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None, act_args: Any = None,
                 drop: Any = 0.0, dtype: DtypeArg = None):
        super().__init__(in_features, hidden_features, out_features,
                         act_args, drop)
        self.fc1 = Dense(in_features, self.hidden, dtype=dtype)
        self.fc2 = Dense(self.hidden, self.out, dtype=dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.drop1(self.act(self.fc1(x)), generator)
        return self.drop2(self.fc2(x), generator)


class GluMlp(_MlpBase):
    """fc1 to twice the gate width; the second half gates the first
    through act (sigmoid)."""

    default_act = "sigmoid"

    def __init__(self, in_features: int,
                 hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None, act_args: Any = None,
                 drop: Any = 0.0, dtype: DtypeArg = None):
        super().__init__(in_features, hidden_features, out_features,
                         act_args, drop)
        assert self.hidden % 2 == 0, "GluMlp hidden width must be even"
        self.fc1 = Dense(in_features, self.hidden, dtype=dtype)
        self.fc2 = Dense(self.hidden // 2, self.out, dtype=dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.fc1(x)
        half = self.hidden // 2
        x = self.drop1(x[..., :half] * self.act(x[..., half:]), generator)
        return self.drop2(self.fc2(x), generator)


class GatedMlp(_MlpBase):
    """gMLP: fc1 -> act -> dropout -> ``gate_layer`` (a module that halves
    the hidden width, held as ``gate_layer``) -> fc2 -> dropout."""

    def __init__(self, in_features: int,
                 hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None, act_args: Any = None,
                 gate_layer: Optional[nn.Module] = None, drop: Any = 0.0,
                 dtype: DtypeArg = None):
        super().__init__(in_features, hidden_features, out_features,
                         act_args, drop)
        self.fc1 = Dense(in_features, self.hidden, dtype=dtype)
        width = self.hidden
        if gate_layer is not None:
            assert self.hidden % 2 == 0
            self.gate_layer = gate_layer
            width = self.hidden // 2
        else:
            self.gate_layer = None
        self.fc2 = Dense(width, self.out, dtype=dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.drop1(self.act(self.fc1(x)), generator)
        if self.gate_layer is not None:
            x = self.gate_layer(x)
        return self.drop2(self.fc2(x), generator)


class ConvMlp(_MlpBase):
    """fc1 -> norm -> act (gelu) -> dropout -> fc2. The norm is flax's
    auto-named one (``PointBatchNorm_0``, ``LayerNorm_0``, ...)."""

    def __init__(self, in_features: int,
                 hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None, act_args: Any = None,
                 norm_args: Any = None, drop: float = 0.0,
                 dtype: DtypeArg = None):
        super().__init__(in_features, hidden_features, out_features,
                         act_args, (drop, 0.0))
        norm = create_norm(norm_args, self.hidden)
        self.norm_name = None
        if norm is not None:
            self.norm_name = f"{norm.flax_name}_0"
            self.add_module(self.norm_name, norm)
        self.fc1 = Dense(in_features, self.hidden, dtype=dtype)
        self.fc2 = Dense(self.hidden, self.out, dtype=dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.fc1(x)
        if self.norm_name is not None:
            x = getattr(self, self.norm_name)(x)
        x = self.drop1(self.act(x), generator)
        return self.fc2(x)
