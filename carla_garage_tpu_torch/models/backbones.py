"""RegNetY image / LiDAR encoders (port of carla_garage_tpu/models/backbones.py).

Submodule names follow the flax module names, so ``convert.load_flax_params``
maps a flax parameter tree onto them name for name. Convolutions run NCHW.

norm="gn" (the default) normalizes with the JAX package's GroupNorm;
norm="bn_affine" puts a per-channel affine in its place that carries an
inference BatchNorm folded into (scale, bias): the layout of the
reference's PyTorch checkpoints (``convert.assemble``).

RegNetY-032 spec (timm): stem 32, stages depth (2, 5, 13, 1), widths
(72, 216, 576, 1512), group width 24, SE ratio 0.25, stride 2 per stage.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
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


class ChannelAffineNorm(nn.Module):
  """Per-channel affine over dim 1 of a channel-first map: an inference
  BatchNorm with folded statistics. Parameters ``scale`` and ``bias`` [C],
  as the JAX AffineNorm's. relu=True returns ``torch.relu`` of the output,
  as ``TpuGroupNorm`` does."""

  def __init__(self, channels: int):
    super().__init__()
    self.scale = nn.Parameter(torch.ones(channels))
    self.bias = nn.Parameter(torch.zeros(channels))

  def forward(self, x, relu: bool = False):
    shape = (-1,) + (1,) * (x.ndim - 2)
    out = x * self.scale.reshape(shape) + self.bias.reshape(shape)
    return torch.relu(out) if relu else out


def make_norm(width: int, norm: str = "gn") -> nn.Module:
  """norm="gn": GroupNorm with the largest group count <= 32 that divides
  width (24 for 72, 27 for 216, 32 for 576, 28 for 1512); "bn_affine": a
  folded BatchNorm."""
  if norm == "bn_affine":
    return ChannelAffineNorm(width)
  if norm != "gn":
    raise ValueError(f"unknown norm {norm!r}")
  g = min(32, width)
  while width % g:
    g -= 1
  return TpuGroupNorm(g, width)


def conv(cin, cout, k, stride=1, groups=1, bias=True) -> nn.Conv2d:
  """flax nn.Conv with torch padding: 1 for 3x3 (flax SAME at stride 1,
  and the explicit ((1,1),(1,1)) of the stem and conv2), 0 for 1x1."""
  return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                   groups=groups, bias=bias)


def same_pads(sizes, kernel, stride) -> list:
  """flax's SAME padding, (low, high) for each spatial axis: the output
  keeps ceil(n / s) positions and an odd total puts the extra zero at the
  end, so a 3x3 stride-2 conv on an even size pads (0, 1)."""
  pads = []
  for n, k, s in zip(sizes, kernel, stride):
    total = max((-(-n // s) - 1) * s + k - n, 0)
    pads.append((total // 2, total - total // 2))
  return pads


class _SamePadding:
  """forward pads the input as flax's SAME does, then convolves."""

  def forward(self, x):
    pads = same_pads(x.shape[2:], self.kernel_size, self.stride)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if any(flat):
      x = F.pad(x, flat)
    return self._conv_forward(x, self.weight, self.bias)


class SameConv2d(_SamePadding, nn.Conv2d):
  """nn.Conv2d with flax's SAME padding at any stride."""

  def __init__(self, cin, cout, k, stride=1, bias=True):
    super().__init__(cin, cout, k, stride=stride, padding=0, bias=bias)


class SameConv3d(_SamePadding, nn.Conv3d):
  """nn.Conv3d with flax's SAME padding at any stride (NCTHW)."""

  def __init__(self, cin, cout, k, stride=1, bias=True):
    super().__init__(cin, cout, k, stride=stride, padding=0, bias=bias)


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
               se_ratio: float, norm: str = "gn"):
    super().__init__()
    groups = max(width // group_w, 1)
    self.conv1 = conv(w_in, width, 1, bias=False)
    self.norm1 = make_norm(width, norm)
    self.conv2 = conv(width, width, 3, stride, groups=groups, bias=False)
    self.norm2 = make_norm(width, norm)
    self.se = SqueezeExcite(width, max(int(w_in * se_ratio), 8))
    self.conv3 = conv(width, width, 1, bias=False)
    self.norm3 = make_norm(width, norm)
    self.has_down = stride != 1 or w_in != width
    if self.has_down:
      self.down_conv = conv(w_in, width, 1, stride, bias=False)
      self.down_norm = make_norm(width, norm)

  def forward(self, x):
    h = self.norm1(self.conv1(x), relu=True)
    h = self.norm2(self.conv2(h), relu=True)
    h = self.se(h)
    h = self.norm3(self.conv3(h))
    if self.has_down:
      x = self.down_norm(self.down_conv(x))
    return torch.relu(x + h)


class RegNetYStem(nn.Module):

  def __init__(self, cin: int, stem_w: int, norm: str = "gn"):
    super().__init__()
    self.conv = conv(cin, stem_w, 3, 2, bias=False)
    self.norm = make_norm(stem_w, norm)

  def forward(self, x):
    return self.norm(self.conv(x), relu=True)


class RegNetYStage(nn.Sequential):

  def __init__(self, w_in: int, depth: int, width: int, group_w: int,
               se_ratio: float, norm: str = "gn"):
    super().__init__()
    for bi in range(depth):
      self.add_module(f"b{bi}", YBlock(w_in if bi == 0 else width, width,
                                       2 if bi == 0 else 1, group_w,
                                       se_ratio, norm))


class RegNetY(nn.Module):
  """Stem + 4 stages; forward(x NCHW) returns the 4 stage maps, at strides
  4, 8, 16 and 32 of the input."""

  def __init__(self, in_channels: int = 3,
               depths=REGNETY_032["depths"], widths=REGNETY_032["widths"],
               group_w: int = REGNETY_032["group_w"],
               se_ratio: float = REGNETY_032["se_ratio"],
               stem_w: int = REGNETY_032["stem_w"], norm: str = "gn"):
    super().__init__()
    self.stem = RegNetYStem(in_channels, stem_w, norm)
    w_in = stem_w
    for si, (d, w) in enumerate(zip(depths, widths)):
      self.add_module(f"stage{si}", RegNetYStage(w_in, d, w, group_w,
                                                 se_ratio, norm))
      w_in = w
    self.n_stages = len(depths)

  def forward(self, x) -> Tuple[torch.Tensor, ...]:
    h = self.stem(x)
    feats = []
    for si in range(self.n_stages):
      h = getattr(self, f"stage{si}")(h)
      feats.append(h)
    return tuple(feats)


def make_encoder(arch: str = "regnety_032", norm: str = "gn") -> RegNetY:
  """The camera encoder (3 input channels) of an arch."""
  return RegNetY(3, norm=norm, **arch_spec(arch))
