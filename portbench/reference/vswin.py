"""The plain reference of TransFuser++ with a Video Swin-T LiDAR branch
(configuration ``tfpp_vswin``), in plain torch, run in float32 with TF32
off.

The LiDAR branch is written from the equations of Liu et al., "Video Swin
Transformer" (CVPR 2022, arXiv:2106.13230) and their released code: a
3D patch partition (Conv3d with kernel = stride = the patch, then a
LayerNorm), then stages of blocks

    z' = 3DW-MSA(LN(z)) + z,   z'' = FFN(LN(z')) + z'

whose odd blocks use 3DSW-MSA, with Attention(Q, K, V) = SoftMax(QK^T /
sqrt(d) + B + M) V by matmul, B gathered from a learned table of (2P-1)
(2M-1)(2M-1) rows per head at each pair's relative position, M the
shifted windows' region mask, the FFN two linear layers around an exact
GELU, and between stages a patch merging that concatenates 2x2
neighbours (4C) and maps them to 2C by a linear layer without bias. The
rest of the model is the frozen reference ``cgt``: the RegNetY image
branch, ``FusionStage``, the decoder join and every head
(``cgt.models.transfuser.LidarCenterNet``). Nothing here imports the port.

Departures from the paper, each shared with the program:

- the fusion of a video branch (carla_garage's temporal-LiDAR option):
  at each stage the GPT fusion takes the stage's time mean [B,C,H,W], its
  LiDAR residual (its output less that mean) is added to every frame
  before the next stage, and the stride-32 map of ``c5_conv`` and
  ``change_channel`` is the time mean after the last fusion;
- the input: ``lidar_seq_len`` frames of 2-channel LiDAR histograms, which
  the model's input holds as channel pairs, newest first; the branch
  takes them oldest first;
- the masked logit is ``MASKED`` = -100, the released code's, not -inf;
- the window and shift follow the released code's ``get_window_size``: an
  axis no longer than its window takes the axis as its window and is not
  shifted; the others shift by half the window. At 16 frames the time
  axis (8 tokens) equals its window, so the shifted blocks shift by
  (0, 3, 3);
- a clipped window indexes the bias table by its tokens' true relative
  positions (the released code slices the full window's index, which
  mislabels a clipped window's pairs);
- inputs are padded to whole windows after LN(z) with zeros, which the
  unshifted windows do not mask, and cropped after the attention, as in
  the released code; the patch partition and an odd merge pad likewise;
- patch merging concatenates the neighbours in the released code's order
  (0,0), (1,0), (0,1), (1,1) as (dh, dw);
- LayerNorm eps 1e-5 (torch's); no final LayerNorm, dropout or drop path
  (inference; the four stage maps feed the fusion).

``lidar_video_cost`` counts the branch's operations and HBM bytes, frozen
for the roofline of its device time.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

MASKED = -100.0


@dataclasses.dataclass(frozen=True)
class VSwinConfig:
  """The Video Swin branch's sizes (Video Swin-T's by default)."""
  embed_dim: int = 96
  depths: tuple = (2, 2, 6, 2)
  heads: tuple = (3, 6, 12, 24)
  window: tuple = (8, 7, 7)
  patch: tuple = (2, 4, 4)
  mlp_ratio: float = 4.0
  seq_len: int = 16
  in_channels: int = 2


def window_and_shift(size, window) -> tuple:
  """The released code's get_window_size: (window, shift) for an input of
  `size` (T, H, W)."""
  ws, shift = list(window), [w // 2 for w in window]
  for i, n in enumerate(size):
    if n <= window[i]:
      ws[i], shift[i] = n, 0
  return tuple(ws), tuple(shift)


def partition(x, ws):
  """[B, T, H, W, C] -> [B * windows, wt * wh * ww, C]."""
  B, T, H, W, C = x.shape
  x = x.view(B, T // ws[0], ws[0], H // ws[1], ws[1], W // ws[2], ws[2], C)
  return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, math.prod(ws), C)


def unpartition(x, ws, B, T, H, W):
  x = x.view(B, T // ws[0], H // ws[1], W // ws[2], ws[0], ws[1], ws[2], -1)
  return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, T, H, W, -1)


def bias_index(ws, table, device=None) -> torch.Tensor:
  """[N, N]: the bias table's row of each pair of a window `ws`, the
  table built for the window `table`."""
  grid = torch.meshgrid(*(torch.arange(w, device=device) for w in ws),
                        indexing="ij")
  coords = torch.stack(grid).flatten(1)                  # [3, N]
  rel = coords[:, :, None] - coords[:, None, :]          # [3, N, N]
  rel = rel + torch.tensor([t - 1 for t in table],
                           device=device)[:, None, None]
  return (rel[0] * (2 * table[1] - 1) + rel[1]) * (2 * table[2] - 1) + \
      rel[2]


def region_mask(padded, ws, shift, device=None) -> torch.Tensor:
  """[windows, N, N]: 0 between tokens of one region, MASKED between
  tokens of two, over the padded input after the cyclic shift (the
  released code's compute_mask)."""
  ids = torch.zeros((1, *padded, 1), device=device)
  cnt = 0
  cuts = [(slice(-w), slice(-w, -s), slice(-s, None))
          for w, s in zip(ws, shift)]
  for d in cuts[0]:
    for h in cuts[1]:
      for w in cuts[2]:
        ids[:, d, h, w, :] = cnt
        cnt += 1
  win = partition(ids, ws)[..., 0]                       # [windows, N]
  diff = win[:, None, :] - win[:, :, None]
  return torch.where(diff != 0, MASKED, 0.0)


class Attention(nn.Module):

  def __init__(self, dim: int, heads: int, table):
    super().__init__()
    self.heads = heads
    self.table = tuple(table)
    self.qkv = nn.Linear(dim, 3 * dim)
    self.rel_bias = nn.Parameter(torch.zeros(
        math.prod(2 * t - 1 for t in table), heads))
    self.proj = nn.Linear(dim, dim)

  def forward(self, x, ws, mask=None):
    """x [B * windows, N, C]; mask [windows, N, N] or None."""
    Bw, N, C = x.shape
    H = self.heads
    d = C // H
    qkv = self.qkv(x).view(Bw, N, 3, H, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    att = (q / math.sqrt(d)) @ k.transpose(-2, -1)         # [Bw, H, N, N]
    idx = bias_index(ws, self.table, x.device)
    att = att + self.rel_bias[idx.flatten()].view(N, N, H).permute(2, 0, 1)
    if mask is not None:
      nw = mask.shape[0]
      att = att.view(Bw // nw, nw, H, N, N) + \
          mask.to(att.dtype)[None, :, None]
      att = att.view(Bw, H, N, N)
    out = torch.softmax(att, -1) @ v                      # [Bw, H, N, d]
    return self.proj(out.transpose(1, 2).reshape(Bw, N, C))


class Block(nn.Module):
  """One Video Swin block; shifted: the odd blocks of a stage."""

  def __init__(self, dim: int, heads: int, window, mlp_ratio: float,
               shifted: bool):
    super().__init__()
    self.window = tuple(window)
    self.shifted = shifted
    self.ln1 = nn.LayerNorm(dim)
    self.attn = Attention(dim, heads, window)
    self.ln2 = nn.LayerNorm(dim)
    self.mlp_fc = nn.Linear(dim, int(dim * mlp_ratio))
    self.mlp_proj = nn.Linear(int(dim * mlp_ratio), dim)

  def forward(self, z):
    B, T, H, W, C = z.shape
    ws, shift = window_and_shift((T, H, W), self.window)
    if not self.shifted:
      shift = (0, 0, 0)
    pads = [-n % w for n, w in zip((T, H, W), ws)]
    x = F.pad(self.ln1(z), (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    Tp, Hp, Wp = T + pads[0], H + pads[1], W + pads[2]
    mask = None
    if any(shift):
      x = torch.roll(x, [-s for s in shift], dims=(1, 2, 3))
      mask = region_mask((Tp, Hp, Wp), ws, shift, z.device)
    x = unpartition(self.attn(partition(x, ws), ws, mask), ws, B, Tp, Hp,
                    Wp)
    if any(shift):
      x = torch.roll(x, list(shift), dims=(1, 2, 3))
    z = z + x[:, :T, :H, :W]
    return z + self.mlp_proj(F.gelu(self.mlp_fc(self.ln2(z))))


class VideoSwin(nn.Module):
  """The branch, stage by stage: ``embed`` then ``stage(i, .)``; tensors
  channels-last [B, T, H, W, C]."""

  def __init__(self, v: VSwinConfig):
    super().__init__()
    self.v = v
    C = v.embed_dim
    self.patch_embed = nn.Conv3d(v.in_channels, C, v.patch, v.patch)
    self.patch_ln = nn.LayerNorm(C)
    for si, depth in enumerate(v.depths):
      if si > 0:
        self.add_module(f"merge_ln{si}", nn.LayerNorm(4 * C))
        self.add_module(f"merge{si}", nn.Linear(4 * C, 2 * C, bias=False))
        C *= 2
      for bi in range(depth):
        self.add_module(f"s{si}b{bi}", Block(C, v.heads[si], v.window,
                                             v.mlp_ratio, bi % 2 == 1))

  def embed(self, x):
    """x [B, C, T, H, W] -> [B, T', H', W', dim]."""
    pads = [-n % p for n, p in zip(x.shape[2:], self.v.patch)]
    x = self.patch_embed(F.pad(x, (0, pads[2], 0, pads[1], 0, pads[0])))
    return self.patch_ln(x.permute(0, 2, 3, 4, 1))

  def stage(self, si: int, x):
    if si > 0:
      B, T, H, W, C = x.shape
      x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
      x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                     x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], -1)
      x = getattr(self, f"merge{si}")(getattr(self, f"merge_ln{si}")(x))
    for bi in range(self.v.depths[si]):
      x = getattr(self, f"s{si}b{bi}")(x)
    return x


class Backbone(nn.Module):
  """The RegNetY image branch and the Video Swin branch, fused after each
  stage, and the top-down path to the BEV grid (as the frozen
  ``TransfuserBackbone``'s)."""

  def __init__(self, c, v: VSwinConfig):
    super().__init__()
    from portbench.reference.cgt.models.backbones import (RegNetYStage,
                                                         RegNetYStem,
                                                         arch_spec, conv)
    from portbench.reference.cgt.models.fusion import FusionStage
    self.cfg, self.v = c, v
    spec = arch_spec(c.image_arch)
    self.image_stem = RegNetYStem(3, spec["stem_w"], "gn")
    self.lidar_video = VideoSwin(v)
    wi = spec["stem_w"]
    for i in range(4):
      self.add_module(f"image_stage{i}", RegNetYStage(
          wi, spec["depths"][i], spec["widths"][i], spec["group_w"],
          spec["se_ratio"], "gn"))
      wi = spec["widths"][i]
      self.add_module(f"fusion{i}", FusionStage(
          wi, v.embed_dim * 2 ** i, c.img_anchors, c.lidar_anchors,
          c.n_head, c.n_fusion_layers))
    ch = c.bev_features_channels
    self.c5_conv = conv(v.embed_dim * 8, ch, 1)
    self.up_conv5 = conv(ch, ch, 3)
    self.up_conv4 = conv(ch, ch, 3)

  def forward(self, rgb, lidar_bev):
    """rgb [B,3,H,W]; lidar_bev [B, 2K, H, W], frames newest first."""
    from portbench.reference.cgt.models.fusion import upsample_bilinear
    c, v = self.cfg, self.v
    B, _, H, W = lidar_bev.shape
    frames = lidar_bev.reshape(B, v.seq_len, v.in_channels, H, W)
    frames = frames.flip(1).permute(0, 2, 1, 3, 4)        # oldest first
    img = self.image_stem(rgb)
    z = self.lidar_video.embed(frames)
    for i in range(4):
      img = getattr(self, f"image_stage{i}")(img)
      z = self.lidar_video.stage(i, z)
      mean = z.mean(1).permute(0, 3, 1, 2)
      img, fused = getattr(self, f"fusion{i}")(img, mean)
      z = z + (fused - mean).permute(0, 2, 3, 1)[:, None]
    lid = z.mean(1).permute(0, 3, 1, 2)
    Hl32, Wl32 = lid.shape[-2:]
    p5 = torch.relu(self.c5_conv(lid))
    p4 = torch.relu(self.up_conv5(upsample_bilinear(p5, (Hl32 * 2,
                                                         Wl32 * 2))))
    p4u = upsample_bilinear(p4, (c.lidar_h // 4, c.lidar_w // 4))
    return img, torch.relu(self.up_conv4(p4u)), lid


def model(c, v: VSwinConfig):
  """TF++ with the Video Swin LiDAR branch: the frozen
  ``LidarCenterNet`` (c: its ``TransfuserConfig``) with its backbone and
  ``change_channel`` in the branch's widths. Its forward is the frozen
  one: inputs NHWC, the LiDAR input [B, H, W, 2K]."""
  from portbench.reference.cgt.models.backbones import conv
  from portbench.reference.cgt.models.transfuser import LidarCenterNet
  # the frozen class builds a RegNetY LiDAR branch, replaced here
  m = LidarCenterNet(dataclasses.replace(c, lidar_arch="regnety_micro"))
  m.backbone = Backbone(c, v)
  m.change_channel = conv(v.embed_dim * 8, c.d_model, 1)
  return m


# --- the branch's cost --------------------------------------------------------

def lidar_video_cost(v: VSwinConfig, batch: int, lidar_hw,
                     nbytes: int = 2) -> tuple:
  """(HBM bytes, operations) of the branch over `batch` samples of
  lidar_hw (H, W), as the program runs it: the frames' reorder, the patch
  partition and every stage with its time mean and, after stages 0-2, the
  fusion's residual added to every frame. Operations: 2 a multiply-add of
  the patch embedding, the linear layers (on the padded tokens where the
  equations pad) and the attention's two matmuls per window and head.
  Bytes at `nbytes` a value: every tensor between the equations'
  operations written once and read once (the inputs, LayerNorm outputs,
  q, k and v, the attention's and projections' outputs, the MLP's hidden
  state with the GELU in place, the residual sums, the merges, the time
  means and the residual's broadcast), each weight and bias table read
  once, and the attention's bias and mask once per window and head; no
  copy for the padding, roll or window partition, and no N x N matrix
  (a fused kernel keeps it on chip)."""
  B, K = batch, v.seq_len
  T, H, W = (-(-n // p) for n, p in zip((K, *lidar_hw), v.patch))
  C = v.embed_dim
  pix = K * lidar_hw[0] * lidar_hw[1] * v.in_channels
  w_embed = C * v.in_channels * math.prod(v.patch)
  # the frames' reorder (read, write), the embedding (read; write), its
  # LayerNorm (read, write)
  n_bytes = nbytes * (3 * B * pix + w_embed + 3 * B * T * H * W * C)
  flops = 2 * B * T * H * W * w_embed
  for si, depth in enumerate(v.depths):
    if si > 0:
      H, W = -(-H // 2), -(-W // 2)
      L = B * T * H * W
      # LayerNorm over 4C (read, write), the merge (read 4C, write 2C)
      n_bytes += nbytes * (L * 4 * C * 3 + L * 2 * C + 8 * C * C)
      flops += 2 * L * 4 * C * 2 * C
      C *= 2
    L = B * T * H * W
    d = C // v.heads[si]
    hidden = int(C * v.mlp_ratio)
    for bi in range(depth):
      ws, shift = window_and_shift((T, H, W), v.window)
      N = math.prod(ws)
      Lp = B * math.prod(-(-n // w) * w for n, w in zip((T, H, W), ws))
      n_win = Lp // N
      # LN1 (read, write), qkv (read C, write 3C), attention (read 3C,
      # write C), proj (read C, write C), residual (read 2C, write C)
      n_bytes += nbytes * (L * 2 * C + Lp * (C + 3 * C) + Lp * (3 * C + C)
                           + Lp * 2 * C + L * 3 * C)
      n_bytes += nbytes * (3 * C * C + C * C + 6 * C)
      n_bytes += nbytes * math.prod(2 * t - 1 for t in v.window) * \
          v.heads[si]
      n_bytes += nbytes * (n_win // B) * v.heads[si] * N * N
      flops += 2 * Lp * C * 3 * C + 2 * Lp * C * C
      flops += 2 * 2 * n_win * v.heads[si] * N * N * d
      # LN2 (read, write), fc1 (read C, write 4C), fc2 (read 4C, write
      # C), residual (read 2C, write C)
      n_bytes += nbytes * (L * 2 * C + L * (C + hidden) + L * (hidden + C)
                           + L * 3 * C + 2 * C * hidden)
      flops += 2 * 2 * L * C * hidden
    # the time mean (read, write a frame) and, before the next stage, the
    # residual broadcast (read the frames and the residual, write)
    n_bytes += nbytes * (L * C + L // T * C)
    if si < len(v.depths) - 1:
      n_bytes += nbytes * (2 * L * C + L // T * C)
  return n_bytes, flops
