"""SimpleBEV-style geometric camera-to-BEV encoder (port of
carla_garage_tpu/models/bev_encoder.py).

A RegNetY encoder with a U-Net style top-down path gives the image
features; a precomputed pinhole projection samples them at every voxel of
a fixed BEV grid (``ops.sampling.grid_sample_2d``), the height axis is
averaged, the LiDAR BEV is concatenated and one BEV CNN follows. Maps run
NCHW.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from carla_garage_tpu_torch.models.backbones import (SameConv2d, arch_spec,
                                                     conv, make_encoder)
from carla_garage_tpu_torch.models.fusion import upsample_bilinear
from carla_garage_tpu_torch.ops.sampling import grid_sample_2d


@dataclasses.dataclass(frozen=True)
class BevProjection:
  """Precomputed pinhole image coordinates for every BEV voxel."""
  coords: np.ndarray   # [D,Hb,Wb,2] (x,y) image pixel coords
  valid: np.ndarray    # [D,Hb,Wb] in-frustum mask


def make_projection_grid(bev_h=64, bev_w=64, n_height=8,
                         min_x=-32.0, max_x=32.0, min_y=-32.0, max_y=32.0,
                         min_z=-10.0, max_z=14.0,
                         img_h=256, img_w=1024, fov_deg=110.0,
                         cam_pos=(-1.5, 0.0, 2.0)) -> BevProjection:
  """Voxel centre -> image pixel. The camera looks along +x with
  CARLA-style axes (x forward, y right, z up)."""
  f = img_w / (2.0 * np.tan(np.radians(fov_deg) / 2.0))
  cx, cy = img_w / 2.0, img_h / 2.0
  xs = np.linspace(min_x, max_x, bev_w)
  ys = np.linspace(min_y, max_y, bev_h)
  zs = np.linspace(min_z, max_z, n_height)
  Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")       # [D,Hb,Wb]
  rx = X - cam_pos[0]
  ry = Y - cam_pos[1]
  rz = Z - cam_pos[2]
  eps = 1e-6
  u = cx + f * ry / np.maximum(rx, eps)
  v = cy - f * rz / np.maximum(rx, eps)
  valid = (rx > 0.1) & (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
  coords = np.stack([u, v], -1).astype(np.float32)
  return BevProjection(coords=coords, valid=valid.astype(np.float32))


class UpsamplingConcat(nn.Module):
  """Bilinear upsample x to skip's size, concatenate, two 3x3 convs."""

  def __init__(self, in_x: int, in_skip: int, out_ch: int):
    super().__init__()
    self.conv1 = conv(in_x + in_skip, out_ch, 3)
    self.conv2 = conv(out_ch, out_ch, 3)

  def forward(self, x, skip):
    x = upsample_bilinear(x, skip.shape[-2:])
    h = torch.relu(self.conv1(torch.cat([x, skip], 1)))
    return torch.relu(self.conv2(h))


class BevEncoder(nn.Module):
  """Camera U-Net -> BEV projection -> concat LiDAR BEV -> BEV CNN.

  The top-down path ends at the encoder's second stage map, at stride 8
  of the camera, yet the projection's pixel coordinates are divided by 4
  (the JAX module's comment calls the map stride 4). Kept as the JAX
  module computes it: points past the map clamp to its right and bottom
  border. projection: the ``BevProjection`` of the camera and grid.
  lidar_channels: the LiDAR BEV's channels, which the fused conv takes
  after the camera's ``bev_latent``."""

  def __init__(self, arch: str = "regnety_032", image_features: int = 512,
               bev_latent: int = 32, bev_out: int = 64, *,
               projection: BevProjection, lidar_channels: int = 2):
    super().__init__()
    widths = arch_spec(arch)["widths"]
    self.encoder = make_encoder(arch)
    self.up1 = UpsamplingConcat(widths[3], widths[2], image_features // 2)
    self.up2 = UpsamplingConcat(image_features // 2, widths[1],
                                image_features)
    self.latent_proj = conv(image_features, bev_latent, 1)
    self.grid_shape = tuple(projection.coords.shape[:3])      # D, Hb, Wb
    # float32 on every device the module runs on, also under a bf16 cast
    # of the module (bf16 would round the pixel coordinates)
    self._coords = np.asarray(projection.coords, np.float32).reshape(-1, 2)
    self._valid = np.asarray(projection.valid, np.float32)
    self._grid = {}
    self.bev_conv1 = conv(bev_latent + lidar_channels, bev_out, 3)
    self.bev_conv2 = SameConv2d(bev_out, bev_out, 3, stride=2)
    self.bev_conv3 = SameConv2d(bev_out, bev_out, 3, stride=2)

  def image_features(self, rgb):
    """The top-down path's map [B,latent,H/8,W/8] (NCHW)."""
    feats = self.encoder(rgb)
    h = self.up1(feats[3], feats[2])
    h = self.up2(h, feats[1])
    return self.latent_proj(h)

  def sample_grid(self, device):
    """(coords [D*Hb*Wb,2] in image-feature pixels, valid [D,Hb,Wb]),
    float32 on `device`, made on first use there."""
    key = str(device)
    if key not in self._grid:
      self._grid[key] = (torch.from_numpy(self._coords).to(device) / 4.0,
                         torch.from_numpy(self._valid).to(device))
    return self._grid[key]

  def camera_bev(self, rgb):
    """The camera's BEV features [B,latent,Hb,Wb]: the image features
    sampled at every voxel, masked to the frustum, averaged over height
    (float32 math on bf16 features, as JAX promotes them)."""
    h = self.image_features(rgb).permute(0, 2, 3, 1)          # [B,H,W,c]
    coords, valid = self.sample_grid(h.device)
    D, Hb, Wb = self.grid_shape
    vox = grid_sample_2d(h, coords).reshape(h.shape[0], D, Hb, Wb, -1)
    return (vox * valid[None, ..., None]).mean(1).permute(0, 3, 1, 2)

  def forward(self, rgb, lidar_bev):
    """rgb [B,3,Hi,Wi], lidar_bev [B,C,Hb,Wb] -> BEV features
    [B,bev_out,Hb/4,Wb/4]."""
    fused = torch.cat([self.camera_bev(rgb).to(rgb.dtype),
                       lidar_bev.to(rgb.dtype)], 1)
    h = torch.relu(self.bev_conv1(fused))
    h = torch.relu(self.bev_conv2(h))
    return torch.relu(self.bev_conv3(h))
