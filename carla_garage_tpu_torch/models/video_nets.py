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

``VideoSwin`` is instead the published Video Swin (Liu et al., "Video
Swin Transformer", CVPR 2022, arXiv:2106.13230, and its released code),
which goes beyond the JAX module: a window no shorter than its axis is
clipped to it and not shifted along it; the shifted windows mask tokens of
different regions from each other (logit ``MASKED``, the released code's
-100); inputs are padded to whole windows after the LayerNorm and cropped
after the attention; exact GELU; LayerNorm eps 1e-5; the relative-position
table sized by the configured window (a clipped window indexes it by its
true offsets); patch merging of 2x2 neighbours in the released code's
order through a linear layer without bias; patch 2x4x4 and MLP ratio 4,
as every published variant has them. Its stages run one at a time
(``embed``, ``stage``), so that a fusion can sit between them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from carla_garage_tpu_torch.models.backbones import SameConv3d
from carla_garage_tpu_torch.models.layers import LayerNorm, Linear
from carla_garage_tpu_torch.ops.norm import TpuGroupNorm

LN_EPS = 1e-6    # flax nn.LayerNorm's default
PUBLISHED_LN_EPS = 1e-5   # torch nn.LayerNorm's, the released code's
PUBLISHED_PATCH = (2, 4, 4)
PUBLISHED_MLP_RATIO = 4


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

MASKED = -100.0    # the released code's logit between tokens of two regions


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


def relative_position_index(ws, table=None) -> np.ndarray:
  """[N, N] index into the (2tt-1)(2th-1)(2tw-1) bias table of the window
  `table` (default `ws`), for a window `ws` no larger than it."""
  tt, th, tw = table or ws
  coords = np.stack(np.meshgrid(*(np.arange(w) for w in ws),
                                indexing="ij"), 0).reshape(3, -1)
  rel = coords[:, :, None] - coords[:, None, :]
  rel = rel + np.array([tt - 1, th - 1, tw - 1]).reshape(3, 1, 1)
  return rel[0] * (2 * th - 1) * (2 * tw - 1) + rel[1] * (2 * tw - 1) + \
      rel[2]


def published_window(size, window) -> tuple:
  """(window, shift) of the released code's ``get_window_size``: an axis no
  longer than its window takes the axis as window and no shift; the others
  the window and a shift of half of it."""
  ws = tuple(n if n <= w else w for n, w in zip(size, window))
  shift = tuple(0 if n <= w else w // 2 for n, w in zip(size, window))
  return ws, shift


def shift_regions(padded, ws, shift) -> np.ndarray:
  """[nW, N] region id of every token of every window after the cyclic
  shift, over the padded (T, H, W): along each shifted axis the last
  window's tokens split into those before and after the shift, and tokens
  of different regions may not attend to each other."""
  ids = np.zeros(padded, np.int64)
  for axis, (n, w, s) in enumerate(zip(padded, ws, shift)):
    along = np.zeros(n, np.int64)
    if s:
      along[n - w:n - s] = 1
      along[n - s:] = 2
    shape = [1, 1, 1]
    shape[axis] = n
    ids = ids * 3 + along.reshape(shape)
  t = torch.from_numpy(ids)[None, ..., None]
  return _window_partition(t, ws)[..., 0].numpy()


class WindowAttention3D(nn.Module):
  """3D window multi-head self-attention with a learned relative position
  bias. table: the window that sizes the bias table (default `window`)."""

  def __init__(self, dim: int, window: Tuple[int, int, int], n_heads: int,
               table: Tuple[int, int, int] | None = None):
    super().__init__()
    wt, wh, ww = table or window
    self.n_heads = n_heads
    self.qkv = Linear(dim, 3 * dim)
    self.rel_bias = nn.Parameter(torch.randn(
        (2 * wt - 1) * (2 * wh - 1) * (2 * ww - 1), n_heads) * 0.02)
    # torch.tensor, unlike from_numpy, honours a default device
    self.register_buffer("rel_index", torch.tensor(
        relative_position_index(window, table).astype(np.int64)),
        persistent=False)
    self.proj = Linear(dim, dim)

  def bias(self):
    """[heads, N, N]: the table's rows at each pair's relative position."""
    return self.rel_bias[self.rel_index].permute(2, 0, 1)

  def forward(self, win, regions=None):
    """win [B, nW, N, C] -> [B, nW, N, C] with N = prod(window); regions
    [nW, N] (the published shifted windows) masks pairs of different
    regions with ``MASKED``. One ``scaled_dot_product_attention`` with
    windows and heads on one axis, the bias (and mask) as its additive
    float mask."""
    B, nW, N, C = win.shape
    H = self.n_heads
    qkv = self.qkv(win).view(B, nW, N, 3, H, C // H)
    qkv = qkv.permute(3, 0, 1, 4, 2, 5).reshape(3, B, nW * H, N, C // H)
    mask = self.bias()[None]
    if regions is None:
      mask = mask.expand(nW, H, N, N)
    else:
      other = regions[:, :, None] != regions[:, None, :]
      mask = mask + (other.to(mask.dtype) * MASKED)[:, None]
    out = F.scaled_dot_product_attention(
        qkv[0], qkv[1], qkv[2], attn_mask=mask.reshape(1, nW * H, N, N))
    out = out.view(B, nW, H, N, C // H).transpose(2, 3).reshape(B, nW, N, C)
    return self.proj(out)


def _attend(attn, h, ws, regions=None):
  """`attn` over the windows of h [B,T,H,W,C] (T/H/W whole windows)."""
  B, T, H, W, C = h.shape
  win = _window_partition(h, ws)
  win = attn(win.view(B, -1, *win.shape[1:]), regions)
  return _window_reverse(win.reshape(-1, *win.shape[2:]), ws, B, T, H, W)


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
    ws = self.ws
    h = self.ln1(x)
    if self.shift:
      h = torch.roll(h, tuple(-(w // 2) for w in ws), dims=(1, 2, 3))
    h = _attend(self.attn, h, ws)
    if self.shift:
      h = torch.roll(h, tuple(w // 2 for w in ws), dims=(1, 2, 3))
    x = x + h
    h = F.gelu(self.mlp_fc(self.ln2(x)), approximate="tanh")
    return x + self.mlp_proj(h)


class VideoSwinBlock(nn.Module):
  """The published block: z = 3D(S)W-MSA(LN(z)) + z, then FFN(LN(z)) + z,
  exact GELU, MLP ratio 4, LayerNorm eps 1e-5. size: the input's (T, H,
  W); window: the configured window, which sizes the bias table and,
  clipped to the input (``published_window``), partitions it. Shifted
  blocks roll by the clipped shift and mask across regions; the input is
  padded to whole windows after the LayerNorm and cropped after the
  attention."""

  def __init__(self, dim: int, n_heads: int, window: Tuple[int, int, int],
               size: Tuple[int, int, int], shift: bool = False):
    super().__init__()
    self.ws, shifts = published_window(size, window)
    self.shifts = shifts if shift else (0, 0, 0)
    self.shift = any(self.shifts)
    self.pads = tuple(-n % w for n, w in zip(size, self.ws))
    padded = tuple(n + p for n, p in zip(size, self.pads))
    self.ln1 = LayerNorm(dim, eps=PUBLISHED_LN_EPS)
    self.attn = WindowAttention3D(dim, self.ws, n_heads, table=window)
    self.ln2 = LayerNorm(dim, eps=PUBLISHED_LN_EPS)
    self.mlp_fc = Linear(dim, PUBLISHED_MLP_RATIO * dim)
    self.mlp_proj = Linear(PUBLISHED_MLP_RATIO * dim, dim)
    self.register_buffer("regions", torch.tensor(shift_regions(
        padded, self.ws, self.shifts)) if self.shift else None,
        persistent=False)

  def forward(self, x):
    """x [B,T,H,W,C] of the size given at construction."""
    _, T, H, W, _ = x.shape
    pt, ph, pw = self.pads
    h = F.pad(self.ln1(x), (0, 0, 0, pw, 0, ph, 0, pt))
    if self.shift:
      h = torch.roll(h, tuple(-s for s in self.shifts), dims=(1, 2, 3))
    h = _attend(self.attn, h, self.ws, self.regions)
    if self.shift:
      h = torch.roll(h, self.shifts, dims=(1, 2, 3))
    x = x + h[:, :T, :H, :W]
    return x + self.mlp_proj(F.gelu(self.mlp_fc(self.ln2(x))))


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


class VideoSwin(nn.Module):
  """The published Video Swin (the module's docstring): a 2x4x4 patch
  embedding, then 4 stages of ``VideoSwinBlock`` with 2x2 patch merging
  between them, run one at a time (``embed``, then ``stage`` 0-3) so that
  a fusion can sit between them. in_channels and input_size (T, H, W)
  describe the input sequence."""

  def __init__(self, embed_dim: int, depths: Sequence[int],
               n_heads: Sequence[int], window: Tuple[int, int, int],
               in_channels: int, input_size: Tuple[int, int, int]):
    super().__init__()
    self.patch_embed = nn.Conv3d(in_channels, embed_dim, PUBLISHED_PATCH,
                                 PUBLISHED_PATCH)
    self.patch_ln = LayerNorm(embed_dim, eps=PUBLISHED_LN_EPS)
    T, H, W = (-(-n // p) for n, p in zip(input_size, PUBLISHED_PATCH))
    C = embed_dim
    self.depths = tuple(depths)
    for si, (depth, heads) in enumerate(zip(depths, n_heads)):
      if si > 0:
        self.add_module(f"merge_ln{si}",
                        LayerNorm(4 * C, eps=PUBLISHED_LN_EPS))
        self.add_module(f"merge{si}", Linear(4 * C, 2 * C, bias=False))
        H, W, C = -(-H // 2), -(-W // 2), 2 * C
      for bi in range(depth):
        self.add_module(f"s{si}b{bi}", VideoSwinBlock(
            C, heads, window, (T, H, W), shift=bool(bi % 2)))

  def embed(self, x):
    """x [B,C,T,H,W], padded to whole patches -> the patches' embeddings
    [B,T',H',W',dim]."""
    pads = [-n % p for n, p in zip(x.shape[2:], PUBLISHED_PATCH)]
    x = F.pad(x, (0, pads[2], 0, pads[1], 0, pads[0]))
    return self.patch_ln(self.patch_embed(x).permute(0, 2, 3, 4, 1))

  def _merge(self, si: int, h):
    """2x2 patch merging before stage si: [B,T,H,W,C] -> [B,T,H/2,W/2,2C],
    an odd H or W padded, the neighbours in the released code's order
    (0,0), (1,0), (0,1), (1,1) as (dh, dw)."""
    B, T, H, W, C = h.shape
    h = F.pad(h, (0, 0, 0, W % 2, 0, H % 2))
    H, W = H + H % 2, W + W % 2
    h = h.reshape(B, T, H // 2, 2, W // 2, 2, C)
    h = h.permute(0, 1, 2, 4, 5, 3, 6).reshape(B, T, H // 2, W // 2, 4 * C)
    return getattr(self, f"merge{si}")(getattr(self, f"merge_ln{si}")(h))

  def stage(self, si: int, h):
    """Stage si on [B,T,H,W,C] (the patches' embeddings for si=0): the
    merge (si > 0), then its blocks."""
    if si > 0:
      h = self._merge(si, h)
    for bi in range(self.depths[si]):
      h = getattr(self, f"s{si}b{bi}")(h)
    return h
