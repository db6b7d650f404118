"""Point Transformer seg backbone, the GeoT flagship, its seg variants,
encoders and transition-matrix predictors.

Counterpart of ``geot_tpu/models/backbone/transformer.py``:
``_PointTransformerSegBase`` (``:292-514``: ``with_T`` on or off, head
mode "plain", "cluster" or "classifier", the exact or the serving
topology, float32 or bfloat16 compute) under the names
``PointTransformer_seg_T``, ``_seg``, ``_seg_2classifier``,
``_seg_cluster`` and ``_seg_classifier``; the pretraining stage's encoder
``PointTransformer_genencoder`` (``:517-552``); the cls-token encoders
``PointTransformerGenEncoder`` and ``PointTransformerEncoder``
(``:556-626``); ``sig_t`` and ``sig_t_mean`` (``:629, 651``); and the
``Gragh_Matching`` stub (``:680``). In training mode
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

from ...core.config import MODELS
from ...ops import (fps, fps_stratified, gather_points, grouping_operation,
                   knn, three_interpolation)
from ..layers import (GELU, BatchNorm, Dense, DropPath, Dropout, DtypeArg,
                      GroupNorm, LayerNorm, LeakyReLU, MlpBlock, SharedMLP,
                      as_dtype, rounded, softmax)
from ..layers.group_embed import GroupTokenizer, SubsampleGroup


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
    """Multi-head self-attention over the group tokens; dropout on the
    attention weights (``attn_drop``) and after the projection
    (``proj_drop``), both 0 in the flagship."""

    def __init__(self, dim: int, num_heads: int, dtype: DtypeArg = None,
                 qkv_bias: bool = False, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, dim * 3, bias=qkv_bias, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x).reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                     # (B, H, N, hd)
        # the scale rounded to q's dtype first, as JAX's weak typing does
        attn = (q @ k.transpose(-2, -1)) * rounded(hd ** -0.5, q.dtype)
        attn = self.attn_drop(softmax(attn), generator)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj_drop(self.proj(out), generator)


class Block(nn.Module):
    """Pre-norm ViT block with stochastic depth. The norms compute in the
    residual stream's dtype (``geot_tpu`` gives them no ``dtype``), the
    attention and the MLP in ``dtype``. ``mlp_ratio``, ``qkv_bias``,
    ``drop`` (projection and MLP dropout) and ``attn_drop`` are
    ``geot_tpu``'s ``Block`` fields (4, False, 0, 0 in the flagship)."""

    def __init__(self, dim: int, num_heads: int, drop_path: float = 0.0,
                 dtype: DtypeArg = None, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop: float = 0.0,
                 attn_drop: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, num_heads, dtype, qkv_bias, attn_drop,
                              drop)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), dtype, drop)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x), generator),
                               generator)
        return x + self.drop_path(self.mlp(self.norm2(x), generator),
                                  generator)


class TransformerStack(nn.Module):
    """Block stack; the position embedding is re-added before every block
    and the outputs of the blocks in ``extract_layers`` (1-based) are
    returned (untapped: ``extract_layers=None``)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 drop_path_rate: float,
                 extract_layers: Optional[Sequence[int]],
                 dtype: DtypeArg = None):
        super().__init__()
        dpr = ([float(drop_path_rate)] if depth == 1 else
               [float(drop_path_rate) * i / (depth - 1) for i in range(depth)])
        self.blocks = nn.ModuleList(Block(dim, num_heads, drop_path=dpr[i],
                                          dtype=dtype)
                                    for i in range(depth))
        self.extract_layers = (None if extract_layers is None
                               else tuple(extract_layers))

    def forward(self, x: torch.Tensor, pos: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """The taps, or the last block's output when ``extract_layers``
        is None."""
        taps = []
        for i, block in enumerate(self.blocks):
            x = block(x + pos, generator)
            if self.extract_layers is not None and \
                    i + 1 in self.extract_layers:
                taps.append(x)
        return x if self.extract_layers is None else taps


class PosEmbed(nn.Sequential):
    """3 -> 128 -> dim MLP with exact GELU (names ``pos_embed.0/.2``), in
    the centers' dtype."""

    def __init__(self, dim: int):
        super().__init__(Dense(3, 128), GELU(), Dense(128, dim))


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


HEAD_MODES = ("plain", "cluster", "classifier")


@MODELS.register_module(name="PointTransformer_seg_T")
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
    float32 coordinates.

    ``head_mode`` (``geot_tpu``'s ``:310, 415-440``) sets the fourth
    output: "plain" the decoder's features ``f_l0``; "cluster" a 64-d
    contrast projection of them (``proj_{i}`` + ``proj_bn_{i}``, 128, 128,
    64, ReLU between, none after the last), taken before the serving
    order's un-permute so it follows the logits' rows; "classifier" the
    log-softmax of the logits times the detached seg head's last weight
    (128, C), each class's column L2-normalised (+1e-12): (B, N, 128)."""

    def __init__(self, trans_dim: int = 384, depth: int = 12,
                 drop_path_rate: float = 0.1, nclasses: int = 17,
                 num_heads: int = 4, group_size: int = 32,
                 num_group: int = 512, encoder_dims: int = 256,
                 downsample_targets: Sequence[int] = (8192, 4096, 2048),
                 extract_layers: Sequence[int] = (4, 8, 12),
                 head_dropout: float = 0.5,
                 fast_pyramid: Union[bool, int] = False,
                 fast_graph: bool = False, dtype: DtypeArg = None,
                 with_T: bool = True, head_mode: str = "plain"):
        super().__init__()
        if head_mode not in HEAD_MODES:
            raise ValueError(f"head_mode {head_mode!r}; expected one of "
                             f"{HEAD_MODES}")
        D = trans_dim
        self.num_group = num_group
        self.tokenizer = GroupTokenizer(num_group, group_size)
        self.head_mode = head_mode
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
        if head_mode == "cluster":
            width = D
            for i, c in enumerate((128, 128, 64)):
                self.add_module(f"proj_{i}", Dense(width, c))
                self.add_module(f"proj_bn_{i}", BatchNorm(c))
                width = c
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
        if fps_pts is None:
            # the FPS kernel reads float32 coordinates whatever the dtype
            fps_pts = gather_points(pts, fps(pts.float().contiguous(),
                                             max_n))
        neighborhood, center, _ = self.tokenizer.group(pts, fps_pts)
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
        feats = f_l0
        if self.head_mode == "classifier":
            # class prototypes: the last layer's kernel (128, C), detached,
            # each column L2-normalised, weighted by the log-softmax
            proto = head[3].weight.detach().T
            proto = proto / (torch.linalg.vector_norm(proto, dim=0,
                                                      keepdim=True) + 1e-12)
            feats = torch.log_softmax(logit, dim=-1) @ proto.T
        # logits in at least float32 (geot_tpu casts to float32, for bf16)
        logit = logit.to(torch.promote_types(logit.dtype, torch.float32))
        if self.head_mode == "cluster":
            h = f_l0
            for i in range(3):
                h = getattr(self, f"proj_bn_{i}")(
                    getattr(self, f"proj_{i}")(h))
                if i < 2:
                    h = torch.relu(h)
            feats = h
        if perm is not None:
            # back to the caller's point order: the inverse permutation is
            # a scatter of iota
            inv = torch.empty_like(perm, dtype=torch.long).scatter_(
                1, perm.long(), torch.arange(N, device=perm.device)
                .expand(B, N))
            logit = gather_points(logit, inv)
            feats = gather_points(feats, inv)

        if not self.with_T:
            return logit, None, None, feats
        correction = self.T_linear(T) if T is not None else None
        return logit, correction, self.sigma, feats


@MODELS.register_module(name="PointTransformer_seg")
def PointTransformerSeg(**kwargs) -> PointTransformerSegT:
    """The same backbone without the NTM head (no ``T_linear``,
    ``T_revision`` or ``sigma``; ``geot_tpu/models/backbone/transformer.py:
    489-492``): ``forward`` returns ``(logit, None, None, f_l0)``."""
    return PointTransformerSegT(with_T=False, **kwargs)


@MODELS.register_module(name="PointTransformer_seg_2classifier")
def PointTransformerSeg2Classifier(**kwargs) -> PointTransformerSegT:
    """``PointTransformer_seg``'s forward (the reference never wired its
    second classifier; ``transformer.py:495-499``)."""
    return PointTransformerSegT(with_T=False, **kwargs)


@MODELS.register_module(name="PointTransformer_seg_cluster")
def PointTransformerSegCluster(**kwargs) -> PointTransformerSegT:
    """The seg backbone with the 64-d contrast projection as its features
    (``head_mode="cluster"``, ``transformer.py:502-506``)."""
    return PointTransformerSegT(with_T=False, head_mode="cluster", **kwargs)


@MODELS.register_module(name="PointTransformer_seg_classifier")
def PointTransformerSegClassifier(**kwargs) -> PointTransformerSegT:
    """The seg backbone with class-prototype features from the seg head's
    weights (``head_mode="classifier"``, ``transformer.py:509-514``)."""
    return PointTransformerSegT(with_T=False, head_mode="classifier",
                                **kwargs)


@MODELS.register_module(name="PointTransformer_genencoder")
class PointTransformerGenEncoderSeg(nn.Module):
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

    # forward_cls_feat gives tokens and centers, no global feature
    GLOBAL_CLS_FEAT = False

    def __init__(self, trans_dim: int = 384, depth: int = 12,
                 drop_path_rate: float = 0.1, num_heads: int = 4,
                 group_size: int = 32, num_group: int = 512,
                 encoder_dims: int = 256,
                 extract_layers: Sequence[int] = (4, 8, 12),
                 nclasses: int = 17,
                 downsample_targets: Sequence[int] = (8192, 4096, 2048)):
        super().__init__()
        self.tokenizer = GroupTokenizer(num_group, group_size)
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
        neighborhood, center, _ = self.tokenizer(pts)
        tokens = self.encoder(neighborhood)
        if self.reduce_dim is not None:
            tokens = self.reduce_dim(tokens)
        taps = self.blocks(tokens, self.pos_embed(center), generator)
        return self.norm(taps[-1]), center

    def forward_cls_feat(self, p, f0: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        return self(p, f0, generator)


class _ClsTokenEncoder(nn.Module):
    """The cls-token encoders' body (``geot_tpu/models/backbone/
    transformer.py:556-598``): ``SubsampleGroup`` (FPS to ``num_groups``
    centers, ball-query or kNN groups of ``group_size``), the
    mini-PointNet, ``reduce_dim`` to ``trans_dim``, a learnt ``cls_token``
    and ``cls_pos`` before the group tokens, an untapped block stack and
    ``norm``. ``encode`` returns (the normed tokens (B, 1 + G, D), the
    centers (B, G, 3)). ``in_channels`` is taken and not read, as in
    ``geot_tpu``."""

    def __init__(self, num_groups: int = 256, group_size: int = 32,
                 subsample: str = "fps", group: str = "ballquery",
                 radius: float = 0.1, encoder_dims: int = 256,
                 trans_dim: int = 384, drop_path_rate: float = 0.1,
                 depth: int = 12, num_heads: int = 6, in_channels: int = 3):
        super().__init__()
        self.grouper = SubsampleGroup(num_groups, group_size, subsample,
                                      group, radius)
        self.encoder = MiniPointNetEncoder(encoder_dims)
        self.reduce_dim = Dense(encoder_dims, trans_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, trans_dim))
        self.cls_pos = nn.Parameter(torch.empty(1, 1, trans_dim))
        self.pos_embed = PosEmbed(trans_dim)
        self.blocks = TransformerStack(trans_dim, depth, num_heads,
                                       drop_path_rate, None)
        self.norm = LayerNorm(trans_dim, eps=1e-5)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """``cls_token`` zeros and ``cls_pos`` N(0, 1), as ``geot_tpu``
        draws them."""
        with torch.no_grad():
            self.cls_token.zero_()
            self.cls_pos.normal_(generator=generator)

    def encode(self, pts: torch.Tensor,
               generator: Optional[torch.Generator] = None):
        neighborhood, center = self.grouper(pts)
        tokens = self.reduce_dim(self.encoder(neighborhood))
        B, _, D = tokens.shape
        x = torch.cat([self.cls_token.expand(B, 1, D), tokens], dim=1)
        pos = torch.cat([self.cls_pos.expand(B, 1, D),
                         self.pos_embed(center)], dim=1)
        return self.norm(self.blocks(x, pos, generator)), center

    def forward_cls_feat(self, p, f0: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        return self(p, f0, generator)


@MODELS.register_module(name="PointTransformerGenEncoder")
class PointTransformerGenEncoder(_ClsTokenEncoder):
    """``forward`` returns (the tokens without the cls token (B, G, D),
    the centers (B, G, 3)) (``transformer.py:601-612``)."""

    GLOBAL_CLS_FEAT = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.out_channels = self.reduce_dim.out_features

    def forward(self, p, x: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        pts = p["pos"] if isinstance(p, dict) else p
        out, center = self.encode(pts, generator)
        return out[:, 1:], center


@MODELS.register_module(name="PointTransformerEncoder")
class PointTransformerEncoder(_ClsTokenEncoder):
    """``forward`` returns [the cls token ; the max over the group tokens],
    (B, 2 D) (``transformer.py:615-626``)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.out_channels = 2 * self.reduce_dim.out_features

    def forward(self, p, f0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        pts = p["pos"] if isinstance(p, dict) else p
        out, _ = self.encode(pts, generator)
        return torch.cat([out[:, 0], out[:, 1:].amax(dim=1)], dim=-1)


@MODELS.register_module(name="sig_t")
class SigT(nn.Module):
    """A global transition matrix from softmax outputs
    (``transformer.py:629-647``): ``fc`` (C C, C) (the reference's
    ``fc.weight`` layout, init 0.1 / C) maps each point's (C,) softmax to
    a (C, C) matrix, clipped to [1e-5, 1 - 1e-5] and row-normalised.
    ``forward(x (B, N, C)) -> (B N, C, C)``."""

    def __init__(self, nclasses: int = 17):
        super().__init__()
        self.nclasses = nclasses
        self.fc = nn.Parameter(torch.empty(nclasses * nclasses, nclasses))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.fc.fill_(0.1 / self.nclasses)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C = self.nclasses
        out = (x.reshape(-1, C).to(self.fc.dtype) @ self.fc.T)
        out = out.reshape(-1, C, C).clamp(1e-5, 1 - 1e-5)
        return out / out.sum(dim=2, keepdim=True)


@MODELS.register_module(name="sig_t_mean")
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


@MODELS.register_module(name="Gragh_Matching")
class GraghMatching(nn.Module):
    """The registry's ``Gragh_Matching`` (``transformer.py:680-694``): the
    reference class is unfinished (its ``forward`` is ``pass``), so, as in
    ``geot_tpu``, the surface is kept and a call raises."""

    def __init__(self, in_channels: int = 128, nclasses: int = 17,
                 sample_nums: int = 1024):
        super().__init__()
        self.in_channels = in_channels
        self.nclasses = nclasses
        self.sample_nums = sample_nums

    def forward(self, feat_s, feat_t, label_t):
        raise NotImplementedError(
            "Gragh_Matching is an unfinished stub in the reference "
            "(forward is `pass`); kept only for registry parity.")
