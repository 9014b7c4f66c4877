"""AIM, the camera-only baseline backbone (port of
carla_garage_tpu/models/aim.py).

One image encoder whose pooled last stage, projected, drives the same
planning heads as TransFuser; there is no LiDAR branch.
"""

from __future__ import annotations

from torch import nn

from carla_garage_tpu_torch.models.backbones import arch_spec, make_encoder
from carla_garage_tpu_torch.models.layers import Linear


class AIMBackbone(nn.Module):

  def __init__(self, arch: str = "regnety_032", out_features: int = 256):
    super().__init__()
    self.encoder = make_encoder(arch)
    self.proj = Linear(arch_spec(arch)["widths"][-1], out_features)

  def forward(self, rgb):
    """rgb [B,3,H,W] -> (last stage map [B,C,H/32,W/32], projected pooled
    features [B,out_features])."""
    last = self.encoder(rgb)[-1]
    return last, self.proj(last.mean((2, 3)))
