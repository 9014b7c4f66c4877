"""Temporal LiDAR encoders (port of carla_garage_tpu/models/video_nets.py).

For the temporal-LiDAR configuration a LiDAR histogram sequence
[B,C,T,H,W] is encoded with factorized spatiotemporal convolutions
(R(2+1)D) or shifted-window 3D attention (Video Swin), time collapsing by a
mean per stage, so that the output matches the single-frame encoder's:
4 stage maps [B,C_i,H_i,W_i].

flax builds parameters from the input's shape, so these constructors take
the input's channels (and, for the Swin net, its (T, H, W), which fixes
each block's window and relative-position table). Conventions kept from
the JAX modules: SAME padding (a stride-2 3x3 pads (0, 1) on even sizes);
GroupNorm over every non-channel axis, time included; flax LayerNorm
(eps 1e-6) and its tanh-approximated GELU in the Swin MLP; the Swin window
clipped to the input (min(window, T/H/W)); and no attention mask on the
shifted windows, only the roll.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from carla_garage_tpu_torch.models.backbones import SameConv3d
from carla_garage_tpu_torch.models.layers import LayerNorm, Linear
from carla_garage_tpu_torch.ops.norm import TpuGroupNorm

LN_EPS = 1e-6    # flax nn.LayerNorm's default


class R2Plus1DBlock(nn.Module):
  """Factorized 3D conv: spatial 1x3x3 then temporal 3x1x1 (+ residual)."""

  def __init__(self, w_in: int, width: int, spatial_stride: int = 1):
    super().__init__()
    s = spatial_stride
    self.spatial = SameConv3d(w_in, width, (1, 3, 3), (1, s, s), bias=False)
    self.norm1 = TpuGroupNorm(min(32, width), width)
    self.temporal = SameConv3d(width, width, (3, 1, 1), bias=False)
    self.norm2 = TpuGroupNorm(min(32, width), width)
    self.has_down = s != 1 or w_in != width
    if self.has_down:
      self.down = SameConv3d(w_in, width, 1, (1, s, s), bias=False)

  def forward(self, x):
    """x [B,C,T,H,W]."""
    h = torch.relu(self.norm1(self.spatial(x)))
    h = self.norm2(self.temporal(h))
    if self.has_down:
      x = self.down(x)
    return torch.relu(x + h)


class VideoResNet(nn.Module):
  """R(2+1)D encoder returning 4 time-collapsed stage maps."""

  def __init__(self, widths: Sequence[int] = (32, 64, 128, 256),
               in_channels: int = 2):
    super().__init__()
    self.stem = SameConv3d(in_channels, widths[0], (1, 3, 3), (1, 2, 2),
                           bias=False)
    self.stem_norm = TpuGroupNorm(min(32, widths[0]), widths[0])
    w_in = widths[0]
    for i, w in enumerate(widths):
      self.add_module(f"block{i}", R2Plus1DBlock(w_in, w,
                                                 2 if i > 0 else 1))
      w_in = w
    self.n_blocks = len(widths)

  def forward(self, x) -> Tuple[torch.Tensor, ...]:
    """x [B,C,T,H,W] -> 4 maps [B,width_i,H/2^(i+1),W/2^(i+1)]."""
    h = torch.relu(self.stem_norm(self.stem(x)))
    feats = []
    for i in range(self.n_blocks):
      h = getattr(self, f"block{i}")(h)
      feats.append(h.mean(2))
    return tuple(feats)


# --- Video Swin Transformer 3D --------------------------------------------
# Inside the Swin net tensors are channels-last [B,T,H,W,C]: the window
# attention, LayerNorms and Linears all act on the last axis.

def _window_partition(x, ws):
  """x [B,T,H,W,C] -> [B*nW, wt*wh*ww, C] with window size ws=(wt,wh,ww)."""
  B, T, H, W, C = x.shape
  wt, wh, ww = ws
  x = x.reshape(B, T // wt, wt, H // wh, wh, W // ww, ww, C)
  x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
  return x.reshape(-1, wt * wh * ww, C)


def _window_reverse(win, ws, B, T, H, W):
  wt, wh, ww = ws
  C = win.shape[-1]
  x = win.reshape(B, T // wt, H // wh, W // ww, wt, wh, ww, C)
  x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
  return x.reshape(B, T, H, W, C)


def relative_position_index(ws) -> np.ndarray:
  """[N, N] index into the (2wt-1)(2wh-1)(2ww-1) bias table."""
  wt, wh, ww = ws
  coords = np.stack(np.meshgrid(np.arange(wt), np.arange(wh),
                                np.arange(ww), indexing="ij"),
                    0).reshape(3, -1)
  rel = coords[:, :, None] - coords[:, None, :]
  rel = rel + np.array([wt - 1, wh - 1, ww - 1]).reshape(3, 1, 1)
  return rel[0] * (2 * wh - 1) * (2 * ww - 1) + rel[1] * (2 * ww - 1) + \
      rel[2]


class WindowAttention3D(nn.Module):
  """3D window multi-head self-attention with a learned relative position
  bias."""

  def __init__(self, dim: int, window: Tuple[int, int, int], n_heads: int):
    super().__init__()
    wt, wh, ww = window
    self.dim, self.n_heads = dim, n_heads
    self.n = wt * wh * ww
    self.qkv = Linear(dim, 3 * dim)
    self.rel_bias = nn.Parameter(torch.randn(
        (2 * wt - 1) * (2 * wh - 1) * (2 * ww - 1), n_heads) * 0.02)
    self.register_buffer("rel_index", torch.from_numpy(
        relative_position_index(window).astype(np.int64)), persistent=False)
    self.proj = Linear(dim, dim)

  def forward(self, x):
    """x [nW, N, C] with N = prod(window)."""
    N, H = self.n, self.n_heads
    hd = self.dim // H
    q, k, v = torch.split(self.qkv(x), self.dim, -1)

    def heads(a):
      return a.reshape(a.shape[0], N, H, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    att = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
    att = att + self.rel_bias[self.rel_index].permute(2, 0, 1)[None]
    att = torch.softmax(att, -1)
    out = torch.einsum("bhqk,bhkd->bhqd", att, v)
    return self.proj(out.transpose(1, 2).reshape(x.shape[0], N, self.dim))


class SwinBlock3D(nn.Module):
  """(Shifted) window attention + MLP, both pre-LN residual. size: the
  input's (T, H, W), which clips the window."""

  def __init__(self, dim: int, n_heads: int, window: Tuple[int, int, int],
               size: Tuple[int, int, int], shift: bool = False,
               mlp_ratio: float = 4.0):
    super().__init__()
    self.ws = tuple(min(w, n) for w, n in zip(window, size))
    self.shift = shift
    self.ln1 = LayerNorm(dim, eps=LN_EPS)
    self.attn = WindowAttention3D(dim, self.ws, n_heads)
    self.ln2 = LayerNorm(dim, eps=LN_EPS)
    self.mlp_fc = Linear(dim, int(dim * mlp_ratio))
    self.mlp_proj = Linear(int(dim * mlp_ratio), dim)

  def forward(self, x):
    """x [B,T,H,W,C], T/H/W multiples of the clipped window."""
    B, T, H, W, _ = x.shape
    ws = self.ws
    h = self.ln1(x)
    if self.shift:
      h = torch.roll(h, tuple(-(w // 2) for w in ws), dims=(1, 2, 3))
    h = _window_reverse(self.attn(_window_partition(h, ws)), ws, B, T, H, W)
    if self.shift:
      h = torch.roll(h, tuple(w // 2 for w in ws), dims=(1, 2, 3))
    x = x + h
    h = F.gelu(self.mlp_fc(self.ln2(x)), approximate="tanh")
    return x + self.mlp_proj(h)


class SwinTransformer3D(nn.Module):
  """Temporal LiDAR encoder: a (1,4,4) patch embedding, then 4 stages of
  shifted-window 3D attention with 2x2 patch merging between them,
  returning 4 time-collapsed stage maps. in_channels and input_size
  (T, H, W) describe the input sequence."""

  def __init__(self, embed_dim: int = 48,
               depths: Sequence[int] = (2, 2, 4, 2),
               n_heads: Sequence[int] = (3, 6, 12, 24),
               window: Tuple[int, int, int] = (2, 4, 4),
               in_channels: int = 2,
               input_size: Tuple[int, int, int] = (4, 256, 256)):
    super().__init__()
    self.patch_embed = SameConv3d(in_channels, embed_dim, (1, 4, 4),
                                  (1, 4, 4))
    self.patch_ln = LayerNorm(embed_dim, eps=LN_EPS)
    T, H, W = input_size
    H, W, C = -(-H // 4), -(-W // 4), embed_dim
    self.depths = tuple(depths)
    for si, (depth, heads) in enumerate(zip(depths, n_heads)):
      if si > 0:
        self.add_module(f"merge_ln{si}", LayerNorm(4 * C, eps=LN_EPS))
        self.add_module(f"merge{si}", Linear(4 * C, 2 * C))
        H, W, C = H // 2, W // 2, 2 * C
      for bi in range(depth):
        self.add_module(f"s{si}b{bi}", SwinBlock3D(
            C, heads, window, (T, H, W), shift=bool(bi % 2)))

  def forward(self, x) -> Tuple[torch.Tensor, ...]:
    """x [B,C,T,H,W] -> 4 maps [B,dim*2^i,H/4/2^i,W/4/2^i]."""
    h = self.patch_ln(self.patch_embed(x).permute(0, 2, 3, 4, 1))
    feats = []
    for si, depth in enumerate(self.depths):
      if si > 0:
        B, T, H, W, C = h.shape
        h = h.reshape(B, T, H // 2, 2, W // 2, 2, C)
        h = h.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, T, H // 2, W // 2,
                                                   4 * C)
        h = getattr(self, f"merge{si}")(getattr(self, f"merge_ln{si}")(h))
      for bi in range(depth):
        h = getattr(self, f"s{si}b{bi}")(h)
      feats.append(h.mean(1).permute(0, 3, 1, 2))
    return tuple(feats)
