"""The cross-view photo generation stack of GeoT's pretraining stage,
channels last (``geot_tpu/models/generation/view_gen.py:23-297``).

A point encoder's tokens become the memory of a cross-attention
"photo generator" (``ViewTransformer``) whose queries are the rays of an
image-plane grid of the target view; a transposed-convolution decoder
turns the grid's features into an RGB image (``ViewDecoder``; the
bilinear ``ViewDecoder_big`` and the deeply supervised ``ViewDecoder_ds``
are the alternatives), and ``ViewGenBase`` scores it against the render
with a foreground-weighted MSE. Images are NHWC. Module and parameter
names follow the flax tree; convolution weights are OIHW.

Flax's ``ConvTranspose`` (``padding="SAME"``, ``transpose_kernel=False``)
is not ``torch.nn.ConvTranspose2d``: the kernel is applied unflipped to
the stride-dilated input padded as ``lax.conv_transpose`` pads it, and the
output is the input's size times the stride. ``ConvTranspose`` computes
exactly that with ``conv2d``. The attention is plain ``matmul`` and
softmax, as ``geot_tpu`` computes it outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ...core.config import MODELS, build_model_from_cfg
from ..layers import BatchNorm, Dense, Dropout, LayerNorm, gelu, softmax


def rotate_point_clouds_batch(pos: torch.Tensor,
                              rot: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) x (B, 3, 3) -> (B, N, 3): each point times ``rot``
    transposed."""
    return pos @ rot.transpose(-1, -2)


class Conv(nn.Module):
    """Flax ``nn.Conv`` on NHWC input, stride 1, symmetric ``padding``
    (flax's default "SAME" is ``kernel // 2`` for an odd kernel)."""

    # ``weight.permute(flax_kernel_axes)`` is the flax kernel (H, W, in, out)
    flax_kernel_axes = (2, 3, 1, 0)

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                     padding=self.padding)
        return y.permute(0, 2, 3, 1)


def conv_transpose_padding(k: int, s: int):
    """``lax.conv_transpose``'s (before, after) padding of one spatial axis
    for ``padding="SAME"`` (``jax._src.lax.convolution.
    _conv_transpose_padding``)."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return pad_a, pad_len - pad_a


class ConvTranspose(nn.Module):
    """Flax ``nn.ConvTranspose(padding="SAME", transpose_kernel=False)`` on
    NHWC input: the input dilated by ``stride`` (zeros between its
    pixels), padded as ``lax.conv_transpose`` pads, and convolved (a
    cross-correlation, the kernel not flipped) at stride 1; (B, H, W, C) ->
    (B, H * stride, W * stride, out_channels)."""

    flax_kernel_axes = (2, 3, 1, 0)

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int):
        super().__init__()
        self.stride = stride
        self.pad = conv_transpose_padding(kernel, stride)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride
        x = x.permute(0, 3, 1, 2)
        B, C, H, W = x.shape
        up = x.new_zeros(B, C, (H - 1) * s + 1, (W - 1) * s + 1)
        up[:, :, ::s, ::s] = x
        a, b = self.pad
        y = F.conv2d(F.pad(up, (a, b, a, b)), self.weight, self.bias)
        return y.permute(0, 2, 3, 1)


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = Dense(dim, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * gelu(gate)


class FeedForward(nn.Module):
    """Gated-GELU MLP, ``dim`` -> ``4 dim`` -> ``dim`` (``geot_tpu``'s
    defaults, ``mult=4``, ``glu=True``, the only ones its blocks use)."""

    def __init__(self, dim: int, dropout: float = 0.0):
        super().__init__()
        self.geglu = GEGLU(dim, 4 * dim)
        self.dropout = Dropout(dropout)
        self.fc_out = Dense(4 * dim, dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.fc_out(self.dropout(self.geglu(x), generator))


class CrossAttention(nn.Module):
    """Multi-head attention of ``x`` over ``context`` (itself when None),
    both ``dim`` wide; ``to_q``/``to_k``/``to_v`` without bias, ``to_out``
    back to ``dim``."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(dim, inner, bias=False)
        self.to_k = Dense(dim, inner, bias=False)
        self.to_v = Dense(dim, inner, bias=False)
        self.to_out = Dense(inner, dim)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        context = x if context is None else context

        def split(t):
            B, N, _ = t.shape
            return t.reshape(B, N, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = (split(self.to_q(x)), split(self.to_k(context)),
                   split(self.to_v(context)))
        sim = (q @ k.transpose(-1, -2)) * self.dim_head ** -0.5
        out = softmax(sim) @ v                               # (B, H, N, D)
        B, H, N, D = out.shape
        out = self.to_out(out.transpose(1, 2).reshape(B, N, H * D))
        return self.dropout(out, generator)


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention over the memory and the gated MLP,
    each pre-normed and residual."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 dropout: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, n_heads, d_head, dropout)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, n_heads, d_head, dropout)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, dropout=dropout)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x), generator=generator)
        x = x + self.attn2(self.norm2(x), context, generator)
        return x + self.ff(self.norm3(x), generator)


# the width of each part of a query
_QUERY_PARTS = {"point_grid": 3, "direction_norm": 3, "query_pos": 2}


@MODELS.register_module(name="ViewTransformer")
class ViewTransformer(nn.Module):
    """The photo generator. ``forward(feats_pc (B, G, in_channels), pos_feats
    (B, G, 3), pos_pc (B, N, 3), view (B, V, 3, 3))`` -> (B * V, fs, fs,
    feat_channels) with ``fs = img_size // img_ds_ratio``: the tokens and
    their centers go through ``feat_mlp`` to the attention memory; each
    query is a pixel of the target view's ``fs`` x ``fs`` grid (its point
    on the image plane in world coordinates, the view direction and its
    position in [0, 1]^2, in ``query_component``'s order) through
    ``query_mlp``; ``depth`` blocks of ``channels_per_head`` heads of
    ``channels_per_head`` channels each."""

    def __init__(self, in_channels: int = 384, feat_channels: int = 384,
                 depth: int = 4, channels_per_head: int = 64,
                 drop_rate: float = 0.0, obj_size: int = 96,
                 img_size: int = 112, img_ds_ratio: int = 16,
                 query_component: Any = None):
        super().__init__()
        self.obj_size, self.img_size = obj_size, img_size
        self.img_ds_ratio = img_ds_ratio
        self.feat_channels = feat_channels
        self.depth = depth
        self.query_component = list(query_component or _QUERY_PARTS)
        q_in = sum(_QUERY_PARTS[k] for k in self.query_component)
        self.feat_mlp_fc1 = Dense(in_channels + 3, feat_channels * 2)
        self.feat_mlp_fc2 = Dense(feat_channels * 2, feat_channels)
        self.query_mlp_fc1 = Dense(q_in, feat_channels * 2)
        self.query_mlp_fc2 = Dense(feat_channels * 2, feat_channels)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                feat_channels, channels_per_head, channels_per_head,
                drop_rate))

    def _meshgrid(self):
        """The grid's pixel centers in image coordinates (fs * fs, 2) and
        its positions in [0, 1]^2 (fs * fs, 2), float32 numpy."""
        fs = self.img_size // self.img_ds_ratio
        hs, ws = np.meshgrid(np.arange(fs), np.arange(fs), indexing="ij")
        mesh = np.stack([hs, ws], axis=-1).reshape(-1, 2).astype(np.float32)
        mesh_center = (mesh + 0.5) * self.img_ds_ratio
        pos = np.stack(np.meshgrid(np.linspace(0, 1, fs),
                                   np.linspace(0, 1, fs), indexing="ij"),
                       axis=-1).reshape(-1, 2)
        return mesh_center, pos.astype(np.float32)

    def _scale_bias(self, pos_pc: torch.Tensor, view: torch.Tensor):
        """Per (cloud, view) the world size of a pixel (``scale``, (BV, 1))
        and the world position of pixel (0, 0) (``bias``, (BV, 2)) that
        put the rotated cloud in the middle ``obj_size`` pixels of the
        ``img_size`` image; and the views flattened to (BV, 3, 3)."""
        B, V = view.shape[:2]
        N = pos_pc.shape[1]
        flat_view = view.reshape(B * V, 3, 3)
        pos = pos_pc[:, None].expand(B, V, N, 3).reshape(B * V, N, 3)
        rot = rotate_point_clouds_batch(pos, flat_view)
        lo, hi = rot.amin(dim=1), rot.amax(dim=1)
        pc_min = lo[:, :2]
        grid_size = (hi - lo)[:, :2].amax(dim=-1) / (self.obj_size - 3)
        idx_xy = torch.floor((rot[:, :, :2] - pc_min[:, None])
                             / grid_size[:, None, None])
        center = torch.floor((idx_xy.amax(dim=1) + idx_xy.amin(dim=1)) / 2)
        offset = self.obj_size / 2 - center - 1
        pad = (self.img_size - self.obj_size) // 2
        scale = grid_size[:, None]
        bias = pc_min - scale * (offset + pad)
        return scale, bias, flat_view

    def queries(self, pos_pc: torch.Tensor, view: torch.Tensor
                ) -> torch.Tensor:
        """(B * V, fs * fs, query width): the raw queries of every view."""
        mesh_np, qpos_np = self._meshgrid()
        mesh = torch.from_numpy(mesh_np).to(pos_pc)
        qpos = torch.from_numpy(qpos_np).to(pos_pc)
        scale, bias, flat_view = self._scale_bias(pos_pc, view)
        inv = torch.linalg.inv(flat_view)
        grid_world = scale[:, None] * mesh[None] + bias[:, None]  # (BV, P, 2)
        point_grid = grid_world @ inv[:, :, :2].transpose(-1, -2)
        BV, P = point_grid.shape[:2]
        direction = flat_view[:, :, 2]
        direction = direction / (torch.linalg.vector_norm(
            direction, dim=-1, keepdim=True) + 1e-12)
        parts = {"point_grid": point_grid,
                 "direction_norm": direction[:, None].expand(BV, P, 3),
                 "query_pos": qpos[None].expand(BV, P, 2)}
        return torch.cat([parts[k] for k in self.query_component], dim=-1)

    def forward(self, feats_pc: torch.Tensor, pos_feats: torch.Tensor,
                pos_pc: torch.Tensor, view: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        V = view.shape[1]
        feats = self.feat_mlp_fc2(gelu(self.feat_mlp_fc1(
            torch.cat([feats_pc, pos_feats], dim=-1))))
        B, G, C = feats.shape
        memory = feats[:, None].expand(B, V, G, C).reshape(B * V, G, C)
        q = self.query_mlp_fc2(gelu(self.query_mlp_fc1(
            self.queries(pos_pc, view))))
        for i in range(self.depth):
            q = getattr(self, f"block_{i}")(q, memory, generator)
        fs = self.img_size // self.img_ds_ratio
        return q.reshape(B * V, fs, fs, self.feat_channels)


@MODELS.register_module(name="ViewDecoder")
class ViewDecoder(nn.Module):
    """Four transposed convolutions ((5, 5) at stride 4, then (3, 3) at
    stride 2 three times; 32x up), ReLU between, sigmoid out."""

    def __init__(self, in_channels: int = 384, out_channels: int = 3):
        super().__init__()
        c = in_channels
        self.layer1 = ConvTranspose(c, c // 2, 5, 4)
        self.layer2 = ConvTranspose(c // 2, c // 4, 3, 2)
        self.layer3 = ConvTranspose(c // 4, c // 8, 3, 2)
        self.layer4 = ConvTranspose(c // 8, out_channels, 3, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.layer1(x))
        x = F.relu(self.layer2(x))
        x = F.relu(self.layer3(x))
        return torch.sigmoid(self.layer4(x))


@MODELS.register_module(name="ViewDecoder_big")
class ViewDecoderBig(nn.Module):
    """Four stages of a bilinear 2x upsample (``jax.image.resize``'s half-
    pixel centres, as ``F.interpolate(align_corners=False)``) and two
    (3, 3) convolutions without bias, each with BatchNorm and ReLU; a
    (1, 1) convolution and sigmoid out (16x up)."""

    def __init__(self, in_channels: int = 384, out_channels: int = 3):
        super().__init__()
        c = in_channels
        cin = c
        for i, cout in enumerate((c // 2, c // 4, c // 8, c // 8)):
            for j in range(2):
                self.add_module(f"layer{i}_conv{j}",
                                Conv(cin, cout, 3, padding=1, bias=False))
                self.add_module(f"layer{i}_bn{j}", BatchNorm(cout))
                cin = cout
        self.out = Conv(cin, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                              mode="bilinear", align_corners=False
                              ).permute(0, 2, 3, 1)
            for j in range(2):
                x = F.relu(getattr(self, f"layer{i}_bn{j}")(
                    getattr(self, f"layer{i}_conv{j}")(x)))
        return torch.sigmoid(self.out(x))


@MODELS.register_module(name="ViewDecoder_ds")
class ViewDecoderDS(nn.Module):
    """Four (3, 3) stride-2 transposed convolutions with ReLU, each stage
    tapped by a (3, 3) sigmoid head; returns the four images, smallest
    first."""

    def __init__(self, in_channels: int = 384, out_channels: int = 3):
        super().__init__()
        c = in_channels
        cin = c
        for i, cout in enumerate((c // 2, c // 4, c // 8, c // 8)):
            self.add_module(f"layer{i + 1}", ConvTranspose(cin, cout, 3, 2))
            self.add_module(f"out{i + 1}", Conv(cout, out_channels, 3,
                                                padding=1, bias=False))
            cin = cout

    def forward(self, x: torch.Tensor):
        imgs = []
        for i in range(1, 5):
            x = F.relu(getattr(self, f"layer{i}")(x))
            imgs.append(torch.sigmoid(getattr(self, f"out{i}")(x)))
        return imgs


@MODELS.register_module(name="ViewGenBase")
class ViewGenBase(nn.Module):
    """Encoder, generator and decoder. ``forward(p0)`` with ``p0 = {"pos"
    (B, N, 3), "x", "views" (B, V, 3, 3), "imgs" (B, V, H, W, 3),
    "weight"? (B, V, H, W)}`` returns ``(loss, recon (B * V, H, W, 3))``:
    the squared error over the render's foreground (any channel below 1)
    times ``weight`` where given, over 3 x the foreground's pixels, times
    ``loss_args.weight_fg``, plus the background's over 3 x its pixels
    times ``weight_bg``. Dropout and stochastic depth draw from
    ``generator`` in training mode. ``forward_sums`` returns the loss's
    four sums in its place and ``loss_of_sums`` the loss of them: under
    data parallelism the pretraining step sums them over the ranks."""

    def __init__(self, encoder_args: Dict[str, Any],
                 generator_args: Dict[str, Any],
                 decoder_args: Dict[str, Any],
                 loss_args: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.encoder = build_model_from_cfg(encoder_args)
        self.generator = build_model_from_cfg(generator_args)
        self.decoder = build_model_from_cfg(decoder_args)
        la = loss_args or {}
        self.w_fg = float(la.get("weight_fg", 1.0))
        self.w_bg = float(la.get("weight_bg", 1.0))

    def forward(self, p0: Dict[str, torch.Tensor],
                f0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        sums, recon = self.forward_sums(p0, f0, generator)
        return self.loss_of_sums(sums), recon

    def forward_sums(self, p0: Dict[str, torch.Tensor],
                     f0: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """``(sums (4,), recon)``: the foreground's (weighted) squared
        error, its pixels, the background's squared error and its
        pixels."""
        feats_pc, coords_pc = self.encoder.forward_cls_feat(
            p0, f0, generator=generator)
        feats_img = self.generator(feats_pc, coords_pc, p0["pos"],
                                   p0["views"], generator)
        recon = self.decoder(feats_img)                      # (BV, H, W, 3)
        BV, H, W, _ = recon.shape
        img_gt = p0["imgs"].reshape(BV, H, W, 3)
        fg = ((img_gt < 1).to(recon.dtype).sum(dim=-1, keepdim=True)
              > 0).to(recon.dtype)
        se = (recon - img_gt) ** 2
        if "weight" in p0:
            w = p0["weight"].reshape(BV, H, W, 1)
            fg_sum = (se * fg * w).sum()
        else:
            fg_sum = (se * fg).sum()
        return torch.stack([fg_sum, fg.sum(), (se * (1 - fg)).sum(),
                            (1 - fg).sum()]), recon

    def loss_of_sums(self, sums: torch.Tensor) -> torch.Tensor:
        fg_loss = sums[0] / torch.clamp(sums[1] * 3, min=1.0)
        bg_loss = sums[2] / torch.clamp(sums[3] * 3, min=1.0)
        return fg_loss * self.w_fg + bg_loss * self.w_bg
