"""RegNetY image / LiDAR encoders (port of carla_garage_tpu/models/backbones.py).

Submodule names follow the flax module names, so ``convert.load_flax_params``
maps a flax parameter tree onto them name for name. Convolutions run NCHW.

RegNetY-032 spec (timm): stem 32, stages depth (2, 5, 13, 1), widths
(72, 216, 576, 1512), group width 24, SE ratio 0.25, stride 2 per stage.
"""

from __future__ import annotations

import torch
from torch import nn

from carla_garage_tpu_torch.ops.norm import TpuGroupNorm

REGNETY_032 = dict(depths=(2, 5, 13, 1), widths=(72, 216, 576, 1512),
                   group_w=24, se_ratio=0.25, stem_w=32)
REGNETY_MICRO = dict(depths=(1, 1, 2, 1), widths=(32, 64, 128, 256),
                     group_w=16, se_ratio=0.25, stem_w=16)
ARCHS = {"regnety_032": REGNETY_032, "regnety_micro": REGNETY_MICRO}


def arch_spec(arch: str) -> dict:
  if arch not in ARCHS:
    raise ValueError(f"unknown arch {arch}")
  return ARCHS[arch]


class AffineNorm(nn.Module):
  """Per-channel affine over the last axis: x * scale + bias."""

  def __init__(self, channels: int):
    super().__init__()
    self.scale = nn.Parameter(torch.ones(channels))
    self.bias = nn.Parameter(torch.zeros(channels))

  def forward(self, x):
    return x * self.scale + self.bias


def make_norm(width: int) -> TpuGroupNorm:
  """GroupNorm with the largest group count <= 32 that divides width
  (24 for 72, 27 for 216, 32 for 576, 28 for 1512)."""
  g = min(32, width)
  while width % g:
    g -= 1
  return TpuGroupNorm(g, width)


def conv(cin, cout, k, stride=1, groups=1, bias=True) -> nn.Conv2d:
  """flax nn.Conv with torch padding: 1 for 3x3 (flax SAME at stride 1,
  and the explicit ((1,1),(1,1)) of the stem and conv2), 0 for 1x1."""
  return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                   groups=groups, bias=bias)


class SqueezeExcite(nn.Module):

  def __init__(self, channels: int, rd_channels: int):
    super().__init__()
    self.fc1 = conv(channels, rd_channels, 1)
    self.fc2 = conv(rd_channels, channels, 1)

  def forward(self, x):
    s = x.mean((2, 3), keepdim=True)
    s = self.fc2(torch.relu(self.fc1(s)))
    return x * torch.sigmoid(s)


class YBlock(nn.Module):
  """RegNetY bottleneck: 1x1 -> 3x3 grouped (stride) -> SE -> 1x1 + skip."""

  def __init__(self, w_in: int, width: int, stride: int, group_w: int,
               se_ratio: float):
    super().__init__()
    groups = max(width // group_w, 1)
    self.conv1 = conv(w_in, width, 1, bias=False)
    self.norm1 = make_norm(width)
    self.conv2 = conv(width, width, 3, stride, groups=groups, bias=False)
    self.norm2 = make_norm(width)
    self.se = SqueezeExcite(width, max(int(w_in * se_ratio), 8))
    self.conv3 = conv(width, width, 1, bias=False)
    self.norm3 = make_norm(width)
    self.has_down = stride != 1 or w_in != width
    if self.has_down:
      self.down_conv = conv(w_in, width, 1, stride, bias=False)
      self.down_norm = make_norm(width)

  def forward(self, x):
    h = torch.relu(self.norm1(self.conv1(x)))
    h = torch.relu(self.norm2(self.conv2(h)))
    h = self.se(h)
    h = self.norm3(self.conv3(h))
    if self.has_down:
      x = self.down_norm(self.down_conv(x))
    return torch.relu(x + h)


class RegNetYStem(nn.Module):

  def __init__(self, cin: int, stem_w: int):
    super().__init__()
    self.conv = conv(cin, stem_w, 3, 2, bias=False)
    self.norm = make_norm(stem_w)

  def forward(self, x):
    return torch.relu(self.norm(self.conv(x)))


class RegNetYStage(nn.Sequential):

  def __init__(self, w_in: int, depth: int, width: int, group_w: int,
               se_ratio: float):
    super().__init__()
    for bi in range(depth):
      self.add_module(f"b{bi}", YBlock(w_in if bi == 0 else width, width,
                                       2 if bi == 0 else 1, group_w,
                                       se_ratio))
