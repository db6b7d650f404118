"""Point Transformer seg backbone, the GeoT flagship, and its instance
transition-matrix predictor ``SigTMean``.

Counterpart of ``geot_tpu/models/backbone/transformer.py:33-469``
(``_PointTransformerSegBase`` with ``with_T=True`` and
``fast_pyramid=False``) and ``:651`` (``SigTMean``). In training mode
(``module.train()``) BatchNorm uses batch statistics and updates its
running ones as flax does, and stochastic depth (rate ``drop_path_rate *
i / (depth - 1)`` in block i) and the seg head's dropout draw their masks
from the ``generator`` passed to ``forward``.

Submodules and parameters carry the names of the reference torch
state_dict (``encoder.first_conv.0``, ``blocks.blocks.{i}``,
``propogation_{j}.mlp.layer{i}.conv``, ``dgcnn_pro_{j}.layer1.0``,
``seg_head.{0,1,3}``, ``T_linear``, ...), so
``geot_tpu.engine.checkpoint.convert_torch_seg_t`` reads a state_dict of
this module.

16k points --FPS-> 512 centers --kNN 32-> groups --mini-PointNet-> tokens
-> ViT blocks with taps -> FPS pyramid (prefixes of the one FPS run) +
3-NN feature propagation + 2 DGCNN graph upsamplings -> seg head.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ...core.config import register_model
from ...ops import (fps, gather_points, grouping_operation, knn,
                   three_interpolation)
from ..layers import (BatchNorm, DropPath, Dropout, GroupNorm, MlpBlock,
                      SharedMLP)


class MiniPointNetEncoder(nn.Module):
    """Per-group PointNet: 3 -> 256 local, max-pool global concat,
    -> ``encoder_channel``."""

    def __init__(self, encoder_channel: int):
        super().__init__()
        self.first_conv = nn.Sequential(nn.Linear(3, 128), BatchNorm(128),
                                        nn.ReLU(), nn.Linear(128, 256))
        self.second_conv = nn.Sequential(nn.Linear(512, 512), BatchNorm(512),
                                         nn.ReLU(),
                                         nn.Linear(512, encoder_channel))

    def forward(self, point_groups: torch.Tensor) -> torch.Tensor:
        # point_groups (B, G, K, 3) -> (B, G, encoder_channel)
        x = self.first_conv(point_groups)                    # (B, G, K, 256)
        g = x.amax(dim=2, keepdim=True)                      # (B, G, 1, 256)
        # Linear(concat([broadcast(g), x])) factored so the global term is
        # computed once per group (geot_tpu's _FactoredConcatDense)
        conv = self.second_conv[0]
        C = x.shape[-1]
        x = x @ conv.weight[:, C:].T + (g @ conv.weight[:, :C].T + conv.bias)
        x = self.second_conv[1:](x)
        return x.amax(dim=2)


class Attention(nn.Module):
    """Multi-head self-attention over the group tokens (the flagship's
    attention and projection dropout rates are 0)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x).reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                     # (B, H, N, hd)
        attn = (q @ k.transpose(-2, -1)) * (hd ** -0.5)
        out = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class Block(nn.Module):
    """Pre-norm ViT block with stochastic depth."""

    def __init__(self, dim: int, num_heads: int, drop_path: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, num_heads)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = MlpBlock(dim, 4 * dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x)), generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class TransformerStack(nn.Module):
    """Block stack; the position embedding is re-added before every block
    and the outputs of the blocks in ``extract_layers`` (1-based) are
    returned."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 drop_path_rate: float, extract_layers: Sequence[int]):
        super().__init__()
        dpr = ([float(drop_path_rate)] if depth == 1 else
               [float(drop_path_rate) * i / (depth - 1) for i in range(depth)])
        self.blocks = nn.ModuleList(Block(dim, num_heads, drop_path=dpr[i])
                                    for i in range(depth))
        self.extract_layers = tuple(extract_layers)

    def forward(self, x: torch.Tensor, pos: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        taps = []
        for i, block in enumerate(self.blocks):
            x = block(x + pos, generator)
            if i + 1 in self.extract_layers:
                taps.append(x)
        return taps


class PosEmbed(nn.Sequential):
    """3 -> 128 -> dim MLP with exact GELU (names ``pos_embed.0/.2``)."""

    def __init__(self, dim: int):
        super().__init__(nn.Linear(3, 128), nn.GELU(approximate="none"),
                         nn.Linear(128, dim))


class FeaturePropagation(nn.Module):
    """three_nn + inverse-distance interpolation + skip concat + SharedMLP."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(channels)

    def forward(self, unknown_xyz, known_xyz, unknown_feats, known_feats):
        interp = three_interpolation(unknown_xyz, known_xyz, known_feats)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats.to(interp.dtype)], dim=-1)
        return self.mlp(interp)


class DGCNNPropagation(nn.Module):
    """Graph-conv upsampling: two edge convs (k=4) with GroupNorm(4) +
    LeakyReLU(0.2) and max over neighbours; hidden 4D/3, output D."""

    def __init__(self, dim: int = 384, k: int = 4):
        super().__init__()
        hidden = 4 * dim // 3
        self.k = k
        self.layer1 = nn.Sequential(nn.Linear(2 * dim, hidden, bias=False),
                                    GroupNorm(4, hidden, eps=1e-5),
                                    nn.LeakyReLU(0.2))
        self.layer2 = nn.Sequential(nn.Linear(2 * hidden, dim, bias=False),
                                    GroupNorm(4, dim, eps=1e-5),
                                    nn.LeakyReLU(0.2))

    def _graph_feature(self, coor_q, x_q, coor_k, x_k):
        _, idx = knn(coor_q, coor_k, self.k)                 # (B, Nq, k)
        neigh = grouping_operation(x_k, idx)                 # (B, Nq, k, C)
        center = x_q[:, :, None, :].expand_as(neigh)
        return torch.cat([neigh - center, center], dim=-1)

    def forward(self, coor, f, coor_q, f_q):
        # coor/f: coarse level; coor_q/f_q: fine level
        h = self.layer1(self._graph_feature(coor_q, f_q, coor, f)).amax(dim=2)
        h2 = self._graph_feature(coor_q, h, coor_q, h)
        return self.layer2(h2).amax(dim=2)


@register_model("PointTransformer_seg_T")
class PointTransformerSegT(nn.Module):
    """The GeoT flagship segmentor. ``forward`` returns
    ``(logit (B, N, C), correction, sigma, f_l0 (B, N, D))``.
    ``head_dropout`` is the seg head's dropout rate (0.5 as in the
    reference; ``geot_tpu``'s argument of the same name)."""

    def __init__(self, trans_dim: int = 384, depth: int = 12,
                 drop_path_rate: float = 0.1, nclasses: int = 17,
                 num_heads: int = 4, group_size: int = 32,
                 num_group: int = 512, encoder_dims: int = 256,
                 downsample_targets: Sequence[int] = (8192, 4096, 2048),
                 extract_layers: Sequence[int] = (4, 8, 12),
                 head_dropout: float = 0.5):
        super().__init__()
        D = trans_dim
        self.num_group = num_group
        self.group_size = group_size
        self.downsample_targets = tuple(downsample_targets)
        self.encoder = MiniPointNetEncoder(encoder_dims)
        self.reduce_dim = (nn.Linear(encoder_dims, D) if encoder_dims != D
                           else None)
        self.pos_embed = PosEmbed(D)
        self.blocks = TransformerStack(D, depth, num_heads, drop_path_rate,
                                       extract_layers)
        self.norm = nn.LayerNorm(D, eps=1e-5)
        self.propogation_2 = FeaturePropagation([D + 3, D * 4, D])
        self.propogation_1 = FeaturePropagation([D + 3, D * 4, D])
        self.propogation_0 = FeaturePropagation([D + 5, D * 4, D])
        self.dgcnn_pro_1 = DGCNNPropagation(D, k=4)
        self.dgcnn_pro_2 = DGCNNPropagation(D, k=4)
        self.seg_head = nn.Sequential(nn.Linear(D, 128), BatchNorm(128),
                                      Dropout(head_dropout),
                                      nn.Linear(128, nclasses))
        # T_revision is in the reference checkpoint but unused in forward
        self.T_revision = nn.Linear(nclasses, nclasses, bias=False)
        self.T_linear = nn.Linear(nclasses, nclasses, bias=False)
        self.sigma = nn.Parameter(torch.full((nclasses,), 0.4))
        nn.init.zeros_(self.T_revision.weight)
        nn.init.zeros_(self.T_linear.weight)

    def forward(self, pts: torch.Tensor, x: Optional[torch.Tensor] = None,
                cls_label: Optional[torch.Tensor] = None,
                T: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        B, N, _ = pts.shape
        pts = pts.contiguous()
        # the tokenizer centers and the decoder pyramid are prefixes of ONE
        # FPS run (greedy selections are incremental)
        max_n = max(max(self.downsample_targets), self.num_group)
        # the FPS kernel reads float32 coordinates whatever the model's dtype
        fps_pts = gather_points(pts, fps(pts.float().contiguous(), max_n))
        center = fps_pts[:, :self.num_group]
        _, knn_idx = knn(center, pts, self.group_size)
        neighborhood = grouping_operation(pts, knn_idx) - center[:, :, None, :]
        tokens = self.encoder(neighborhood)
        if self.reduce_dim is not None:
            tokens = self.reduce_dim(tokens)
        taps = self.blocks(tokens, self.pos_embed(center), generator)
        taps = [self.norm(t) for t in taps]

        # jaw one-hot (mandible/maxillary) broadcast to every point
        if cls_label is None:
            cls_label = torch.zeros(B, dtype=torch.long, device=pts.device)
        onehot = F.one_hot(cls_label.reshape(B).long(), 2).to(pts.dtype)
        f_l0_in = torch.cat([onehot[:, None, :].expand(B, N, 2), pts], dim=-1)

        c = [fps_pts[:, :t] for t in self.downsample_targets]
        f_l3 = taps[2]
        f_l2 = self.propogation_2(c[1], center, c[1], taps[1])
        f_l1 = self.propogation_1(c[0], center, c[0], taps[0])
        f_l2 = self.dgcnn_pro_2(center, f_l3, c[1], f_l2)
        f_l1 = self.dgcnn_pro_1(c[1], f_l2, c[0], f_l1)
        f_l0 = self.propogation_0(pts, c[0], f_l0_in, f_l1)
        head = self.seg_head
        logit = head[3](head[2](head[1](head[0](f_l0)), generator))
        # logits in at least float32 (geot_tpu casts to float32, for bf16)
        logit = logit.to(torch.promote_types(logit.dtype, torch.float32))

        correction = self.T_linear(T) if T is not None else None
        return logit, correction, self.sigma, f_l0


@register_model("sig_t_mean")
class SigTMean(nn.Module):
    """Instance-dependent transition matrix predictor
    (``geot_tpu/models/backbone/transformer.py:651``): per class k a
    Linear(2C -> C) over [softmax(x); cm[k]], clipped to [1e-5, 1 - 1e-5]
    and row-normalised. ``fc`` is the flax layout (C, 2C, C): class, input,
    output."""

    def __init__(self, nclasses: int = 17):
        super().__init__()
        C = nclasses
        self.nclasses = C
        self.fc = nn.Parameter(torch.empty(C, 2 * C, C))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Per-class xavier-uniform (fan_in 2C, fan_out C), as geot_tpu's
        ``variance_scaling`` with ``batch_axis=0``."""
        bound = (6.0 / (3 * self.nclasses)) ** 0.5
        with torch.no_grad():
            self.fc.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, cm: torch.Tensor) -> torch.Tensor:
        """x (B, N, C) softmax, cm (C, C) -> (B*N, C, C)."""
        C = self.nclasses
        out = x.reshape(-1, C).to(self.fc.dtype)
        w1, w2 = self.fc[:, :C, :], self.fc[:, C:, :]
        data = torch.einsum("mc,kcd->mkd", out, w1)
        const = torch.einsum("kc,kcd->kd", cm, w2)
        ins_t = (data + const[None]).clamp(1e-5, 1 - 1e-5)
        return ins_t / ins_t.sum(dim=2, keepdim=True)
