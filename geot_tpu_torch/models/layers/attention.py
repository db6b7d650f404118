"""``TransformerEncoder`` (``geot_tpu/models/layers/attention.py``): a
stack of the backbone's pre-norm ViT ``Block`` (``block_{i}``, the flax
names) that adds the position embedding before every block; with
``num_outs`` it returns that many dilated taps (the reference's
``forward_features``), else the last block's output. Dropout and drop-path
masks come from the ``generator`` passed to ``forward``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .common import DtypeArg, drop_path_rates


class TransformerEncoder(nn.Module):
    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 dtype: DtypeArg = None):
        super().__init__()
        # call-time import: the backbone imports this package
        from ..backbone.transformer import Block

        self.depth = depth
        dpr = drop_path_rates(drop_path_rate, depth)
        for i in range(depth):
            self.add_module(f"block_{i}", Block(
                embed_dim, num_heads, drop_path=dpr[i], dtype=dtype,
                mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, drop=drop_rate,
                attn_drop=attn_drop_rate))

    def forward(self, x: torch.Tensor, pos: torch.Tensor,
                num_outs: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        out_depth = []
        if num_outs is not None:
            dilation = self.depth // num_outs
            out_depth = list(range(self.depth))[
                (self.depth - (num_outs - 1) * dilation - 1)::dilation]
        taps = []
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x + pos, generator)
            if i in out_depth:
                taps.append(x)
        return taps if num_outs is not None else x

    def forward_features(self, x: torch.Tensor, pos: torch.Tensor,
                         num_outs: int,
                         generator: Optional[torch.Generator] = None):
        return self(x, pos, num_outs, generator)
