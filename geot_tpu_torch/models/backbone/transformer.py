"""Point Transformer seg backbone, the GeoT flagship, and its instance
transition-matrix predictor ``SigTMean``.

Counterpart of ``geot_tpu/models/backbone/transformer.py:33-469``
(``_PointTransformerSegBase`` with ``with_T`` on or off, head mode "plain",
the exact or the serving topology, float32 or bfloat16 compute) and
``:651`` (``SigTMean``), and the pretraining stage's encoder
``PointTransformer_genencoder`` (``:517-552``). In training mode
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

from typing import Optional, Sequence, Union

import torch
from torch import nn
import torch.nn.functional as F

from ...core.config import register_model
from ...ops import (fps, fps_stratified, gather_points, grouping_operation,
                   knn, three_interpolation)
from ..layers import (GELU, BatchNorm, Dense, DropPath, Dropout, DtypeArg,
                      GroupNorm, LayerNorm, LeakyReLU, MlpBlock, SharedMLP,
                      as_dtype, rounded, softmax)


class MiniPointNetEncoder(nn.Module):
    """Per-group PointNet: 3 -> 256 local, max-pool global concat,
    -> ``encoder_channel``."""

    def __init__(self, encoder_channel: int, dtype: DtypeArg = None):
        super().__init__()
        self.first_conv = nn.Sequential(
            Dense(3, 128, dtype=dtype), BatchNorm(128, dtype=dtype),
            nn.ReLU(), Dense(128, 256, dtype=dtype))
        self.second_conv = nn.Sequential(
            Dense(512, 512, dtype=dtype), BatchNorm(512, dtype=dtype),
            nn.ReLU(), Dense(512, encoder_channel, dtype=dtype))

    def forward(self, point_groups: torch.Tensor) -> torch.Tensor:
        # point_groups (B, G, K, 3) -> (B, G, encoder_channel)
        x = self.first_conv(point_groups)                    # (B, G, K, 256)
        g = x.amax(dim=2, keepdim=True)                      # (B, G, 1, 256)
        # Linear(concat([broadcast(g), x])) factored so the global term is
        # computed once per group (geot_tpu's _FactoredConcatDense, which
        # casts inputs and parameters to the compute dtype first)
        conv = self.second_conv[0]
        dt = conv.compute_dtype or torch.promote_types(x.dtype,
                                                       conv.weight.dtype)
        w, b = conv.weight.to(dt), conv.bias.to(dt)
        C = x.shape[-1]
        x = x.to(dt) @ w[:, C:].T + (g.to(dt) @ w[:, :C].T + b)
        x = self.second_conv[1:](x)
        return x.amax(dim=2)


class Attention(nn.Module):
    """Multi-head self-attention over the group tokens (the flagship's
    attention and projection dropout rates are 0)."""

    def __init__(self, dim: int, num_heads: int, dtype: DtypeArg = None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, dim * 3, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x).reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                     # (B, H, N, hd)
        # the scale rounded to q's dtype first, as JAX's weak typing does
        attn = (q @ k.transpose(-2, -1)) * rounded(hd ** -0.5, q.dtype)
        out = (softmax(attn) @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class Block(nn.Module):
    """Pre-norm ViT block with stochastic depth. The norms compute in the
    residual stream's dtype (``geot_tpu`` gives them no ``dtype``), the
    attention and the MLP in ``dtype``."""

    def __init__(self, dim: int, num_heads: int, drop_path: float = 0.0,
                 dtype: DtypeArg = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, num_heads, dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = MlpBlock(dim, 4 * dim, dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x)), generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class TransformerStack(nn.Module):
    """Block stack; the position embedding is re-added before every block
    and the outputs of the blocks in ``extract_layers`` (1-based) are
    returned."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 drop_path_rate: float, extract_layers: Sequence[int],
                 dtype: DtypeArg = None):
        super().__init__()
        dpr = ([float(drop_path_rate)] if depth == 1 else
               [float(drop_path_rate) * i / (depth - 1) for i in range(depth)])
        self.blocks = nn.ModuleList(Block(dim, num_heads, drop_path=dpr[i],
                                          dtype=dtype)
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
    """3 -> 128 -> dim MLP with exact GELU (names ``pos_embed.0/.2``), in
    the centers' dtype."""

    def __init__(self, dim: int):
        super().__init__(Dense(3, 128), GELU(), Dense(128, dim))


def group_tokens(pts: torch.Tensor, npoint: int, num_group: int,
                 group_size: int, fps_pts: Optional[torch.Tensor] = None):
    """The tokenizer's groups: FPS of ``npoint`` points of ``pts`` (unless
    ``fps_pts`` gives them), whose first ``num_group`` are the centers,
    and each center's ``group_size`` nearest points less the center.
    Returns ``(fps_pts (B, npoint, 3), center (B, num_group, 3),
    neighborhood (B, num_group, group_size, 3))``. The flagship takes
    ``npoint`` = its largest pyramid level, so one FPS run gives the
    centers and the pyramid; the generation encoder takes ``num_group``
    (``geot_tpu/models/layers/group_embed.py:60-65``)."""
    if fps_pts is None:
        # the FPS kernel reads float32 coordinates whatever the dtype
        fps_pts = gather_points(pts, fps(pts.float().contiguous(), npoint))
    center = fps_pts[:, :num_group]
    _, knn_idx = knn(center, pts, group_size)
    neighborhood = grouping_operation(pts, knn_idx) - center[:, :, None, :]
    return fps_pts, center, neighborhood


class FeaturePropagation(nn.Module):
    """three_nn + inverse-distance interpolation + skip concat + SharedMLP.

    ``prefix_n`` (the serving order): the first ``prefix_n`` unknown rows
    ARE the known rows, so their interpolation is ``known_feats`` itself
    and only the remaining rows are searched."""

    def __init__(self, channels: Sequence[int], dtype: DtypeArg = None):
        super().__init__()
        self.mlp = SharedMLP(channels, dtype)

    def forward(self, unknown_xyz, known_xyz, unknown_feats, known_feats,
                prefix_n: Optional[int] = None):
        if prefix_n is not None:
            rest = three_interpolation(unknown_xyz[:, prefix_n:], known_xyz,
                                       known_feats)
            interp = torch.cat([known_feats.to(rest.dtype), rest], dim=1)
        else:
            interp = three_interpolation(unknown_xyz, known_xyz, known_feats)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats.to(interp.dtype)], dim=-1)
        return self.mlp(interp)


class DGCNNPropagation(nn.Module):
    """Graph-conv upsampling: two edge convs (k=4) with GroupNorm(4) +
    LeakyReLU(0.2) and max over neighbours; hidden 4D/3, output D.

    ``reuse_cross_idx`` (the serving ``fast_graph``): the second edge conv
    reuses the first one's cross-level neighbour indices instead of a
    fine-level self-kNN. Valid only when the coarse rows are a prefix of the
    fine rows (the stratified order), so an index addresses the same point
    in both."""

    def __init__(self, dim: int = 384, k: int = 4, dtype: DtypeArg = None):
        super().__init__()
        hidden = 4 * dim // 3
        self.k = k
        self.layer1 = nn.Sequential(
            Dense(2 * dim, hidden, bias=False, dtype=dtype),
            GroupNorm(4, hidden, eps=1e-5, dtype=dtype), LeakyReLU(0.2))
        self.layer2 = nn.Sequential(
            Dense(2 * hidden, dim, bias=False, dtype=dtype),
            GroupNorm(4, dim, eps=1e-5, dtype=dtype), LeakyReLU(0.2))

    def _graph_feature(self, coor_q, x_q, coor_k, x_k, idx=None):
        if idx is None:
            _, idx = knn(coor_q, coor_k, self.k)             # (B, Nq, k)
        neigh = grouping_operation(x_k, idx)                 # (B, Nq, k, C)
        center = x_q[:, :, None, :].expand_as(neigh)
        return torch.cat([neigh - center, center], dim=-1), idx

    def forward(self, coor, f, coor_q, f_q, reuse_cross_idx: bool = False):
        # coor/f: coarse level; coor_q/f_q: fine level
        h, cross_idx = self._graph_feature(coor_q, f_q, coor, f)
        h = self.layer1(h).amax(dim=2)
        h2, _ = self._graph_feature(coor_q, h, coor_q, h,
                                    cross_idx if reuse_cross_idx else None)
        return self.layer2(h2).amax(dim=2)


@register_model("PointTransformer_seg_T")
class PointTransformerSegT(nn.Module):
    """The GeoT flagship segmentor. ``forward`` returns
    ``(logit (B, N, C) float32 or wider, correction, sigma, f_l0 (B, N,
    D))``; ``with_T=False`` is ``PointTransformer_seg``. ``head_dropout``
    is the seg head's dropout rate (0.5 as in the
    reference; ``geot_tpu``'s argument of the same name).

    Serving topology (``geot_tpu``'s arguments of the same names):
    ``fast_pyramid`` True or an int L runs FPS only for the first
    ``num_group`` (True) or ``max(L, num_group)`` selections and fills the
    rest of the cloud by ``fps_stratified``; the whole cloud is processed in
    that order, so each decoder level's support rows are a prefix of its
    query rows and skip their 3-NN search, and the outputs are put back in
    the caller's order at the end. ``fast_graph`` (only with
    ``fast_pyramid``) makes both DGCNN layers reuse their cross-level
    indices. ``dtype`` ("bfloat16", "float32", None) is the compute dtype
    of the layers that ``geot_tpu`` gives one (``models.layers``);
    parameters stay float32, and FPS and every neighbour search read
    float32 coordinates."""

    def __init__(self, trans_dim: int = 384, depth: int = 12,
                 drop_path_rate: float = 0.1, nclasses: int = 17,
                 num_heads: int = 4, group_size: int = 32,
                 num_group: int = 512, encoder_dims: int = 256,
                 downsample_targets: Sequence[int] = (8192, 4096, 2048),
                 extract_layers: Sequence[int] = (4, 8, 12),
                 head_dropout: float = 0.5,
                 fast_pyramid: Union[bool, int] = False,
                 fast_graph: bool = False, dtype: DtypeArg = None,
                 with_T: bool = True):
        super().__init__()
        D = trans_dim
        self.num_group = num_group
        self.group_size = group_size
        self.downsample_targets = tuple(downsample_targets)
        self.fast_pyramid = fast_pyramid
        self.fast_graph = bool(fast_graph)
        self.compute_dtype = as_dtype(dtype)
        self.encoder = MiniPointNetEncoder(encoder_dims, dtype)
        self.reduce_dim = (Dense(encoder_dims, D) if encoder_dims != D
                           else None)
        self.pos_embed = PosEmbed(D)
        self.blocks = TransformerStack(D, depth, num_heads, drop_path_rate,
                                       extract_layers, dtype)
        self.norm = LayerNorm(D, eps=1e-5, dtype=dtype)
        self.propogation_2 = FeaturePropagation([D + 3, D * 4, D], dtype)
        self.propogation_1 = FeaturePropagation([D + 3, D * 4, D], dtype)
        self.propogation_0 = FeaturePropagation([D + 5, D * 4, D], dtype)
        self.dgcnn_pro_1 = DGCNNPropagation(D, k=4, dtype=dtype)
        self.dgcnn_pro_2 = DGCNNPropagation(D, k=4, dtype=dtype)
        self.seg_head = nn.Sequential(Dense(D, 128, dtype=dtype),
                                      BatchNorm(128, dtype=dtype),
                                      Dropout(head_dropout),
                                      Dense(128, nclasses))
        self.with_T = with_T
        if with_T:
            # T_revision is in the reference checkpoint but unused in
            # forward
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
        perm = None
        if self.fast_pyramid:
            L = (self.num_group if self.fast_pyramid is True
                 else max(int(self.fast_pyramid), self.num_group))
            max_n = max(max(self.downsample_targets), L)
            # the whole cloud in [true-FPS prefix | stratified fill] order
            perm = fps_stratified(pts, N, L)                 # (B, N)
            pts = gather_points(pts, perm)
            fps_pts = pts[:, :max_n]
        else:
            # the tokenizer centers and the decoder pyramid are prefixes of
            # ONE FPS run (greedy selections are incremental)
            max_n = max(max(self.downsample_targets), self.num_group)
            fps_pts = None
        fps_pts, center, neighborhood = group_tokens(
            pts, max_n, self.num_group, self.group_size, fps_pts)
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
        prefix = self.num_group if perm is not None else None
        reuse = self.fast_graph and perm is not None
        f_l3 = taps[2]
        f_l2 = self.propogation_2(c[1], center, c[1], taps[1], prefix)
        f_l1 = self.propogation_1(c[0], center, c[0], taps[0], prefix)
        f_l2 = self.dgcnn_pro_2(center, f_l3, c[1], f_l2, reuse)
        f_l1 = self.dgcnn_pro_1(c[1], f_l2, c[0], f_l1, reuse)
        f_l0 = self.propogation_0(pts, c[0], f_l0_in, f_l1,
                                  c[0].shape[1] if perm is not None else None)
        head = self.seg_head
        logit = head[3](head[2](head[1](head[0](f_l0)), generator))
        # logits in at least float32 (geot_tpu casts to float32, for bf16)
        logit = logit.to(torch.promote_types(logit.dtype, torch.float32))
        if perm is not None:
            # back to the caller's point order: the inverse permutation is
            # a scatter of iota
            inv = torch.empty_like(perm, dtype=torch.long).scatter_(
                1, perm.long(), torch.arange(N, device=perm.device)
                .expand(B, N))
            logit = gather_points(logit, inv)
            f_l0 = gather_points(f_l0, inv)

        if not self.with_T:
            return logit, None, None, f_l0
        correction = self.T_linear(T) if T is not None else None
        return logit, correction, self.sigma, f_l0


@register_model("PointTransformer_seg")
def PointTransformerSeg(**kwargs) -> PointTransformerSegT:
    """The same backbone without the NTM head (no ``T_linear``,
    ``T_revision`` or ``sigma``; ``geot_tpu/models/backbone/transformer.py:
    489-492``): ``forward`` returns ``(logit, None, None, f_l0)``."""
    return PointTransformerSegT(with_T=False, **kwargs)


@register_model("PointTransformer_genencoder")
class PointTransformerGenEncoder(nn.Module):
    """The flagship's trunk as the pretraining stage's point encoder
    (``geot_tpu/models/backbone/transformer.py:517-552``): FPS to
    ``num_group`` centers, kNN groups, the mini-PointNet, the block stack;
    ``forward_cls_feat`` returns (the normed last tap (B, G, D), the
    centers (B, G, 3)). Its modules carry the flagship trunk's names
    (``encoder``, ``reduce_dim``, ``pos_embed``, ``blocks``, ``norm``), so
    a pretraining checkpoint's ``encoder.*`` grafts into ``segmentor.*``
    (``engine.checkpoint.load_pretrain_encoder``). The arguments the trunk
    does not read (``nclasses``, ``downsample_targets``) are taken, as in
    ``geot_tpu``."""

    def __init__(self, trans_dim: int = 384, depth: int = 12,
                 drop_path_rate: float = 0.1, num_heads: int = 4,
                 group_size: int = 32, num_group: int = 512,
                 encoder_dims: int = 256,
                 extract_layers: Sequence[int] = (4, 8, 12),
                 nclasses: int = 17,
                 downsample_targets: Sequence[int] = (8192, 4096, 2048)):
        super().__init__()
        self.num_group = num_group
        self.group_size = group_size
        self.encoder = MiniPointNetEncoder(encoder_dims)
        self.reduce_dim = (Dense(encoder_dims, trans_dim)
                           if encoder_dims != trans_dim else None)
        self.pos_embed = PosEmbed(trans_dim)
        self.blocks = TransformerStack(trans_dim, depth, num_heads,
                                       drop_path_rate, extract_layers)
        self.norm = LayerNorm(trans_dim, eps=1e-5)

    def forward(self, p, f0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        pts = (p["pos"] if isinstance(p, dict) else p).contiguous()
        _, center, neighborhood = group_tokens(
            pts, self.num_group, self.num_group, self.group_size)
        tokens = self.encoder(neighborhood)
        if self.reduce_dim is not None:
            tokens = self.reduce_dim(tokens)
        taps = self.blocks(tokens, self.pos_embed(center), generator)
        return self.norm(taps[-1]), center

    def forward_cls_feat(self, p, f0: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        return self(p, f0, generator)


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
