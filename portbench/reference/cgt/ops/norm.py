"""GroupNorm with the JAX package's numerics (port of
carla_garage_tpu/ops/norm.py ``TpuGroupNorm``).

Per-channel moments over the spatial axes in float32, aggregated per
group, variance as E[x^2] - E[x]^2 clipped at 0, eps 1e-6, then one
x * a + b pass. ``F.group_norm`` uses eps 1e-5 and another variance
formula, so it is not used. Works on NCHW (channels at dim 1); parameters
are ``scale`` and ``bias`` [C] as in flax.
"""

from __future__ import annotations

import torch
from torch import nn


class TpuGroupNorm(nn.Module):

  def __init__(self, num_groups: int, num_channels: int,
               eps: float = 1e-6):
    super().__init__()
    if num_channels % num_groups:
      raise ValueError(f"{num_channels} channels in {num_groups} groups")
    self.num_groups = num_groups
    self.eps = eps
    self.scale = nn.Parameter(torch.ones(num_channels))
    self.bias = nn.Parameter(torch.zeros(num_channels))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    B, C = x.shape[:2]
    G = self.num_groups
    spatial = tuple(range(2, x.ndim))
    xf = x.float()
    m1 = xf.mean(spatial)                                 # [B,C]
    m2 = xf.square().mean(spatial)
    gm1 = m1.reshape(B, G, C // G).mean(-1)               # [B,G]
    gm2 = m2.reshape(B, G, C // G).mean(-1)
    var = torch.clamp(gm2 - gm1.square(), min=0.0)
    inv_c = torch.rsqrt(var + self.eps).repeat_interleave(C // G, -1)
    mean_c = gm1.repeat_interleave(C // G, -1)
    a = inv_c * self.scale.float()[None]
    b = self.bias.float()[None] - mean_c * a
    shape = (B, C) + (1,) * (x.ndim - 2)
    return (xf * a.reshape(shape) + b.reshape(shape)).to(x.dtype)
