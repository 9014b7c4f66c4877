"""LiDAR point-cloud voxelization (port of carla_garage_tpu/sensors/voxelize.py).

A 2-slice 256x256 histogram with at most 5 points per cell, normalized
(the reference's lidar_to_histogram_features). The JAX package computes
it as a scatter (``voxelize``) and as a one-hot matmul
(``voxelize_matmul``), which are exactly equal; here it is one
``index_add_`` of 0/1 weights over flat cells per batch, whose sums are
exact integers in any order of accumulation, with no host sync.
"""

from __future__ import annotations

import torch

from portbench.reference.cgt.config import GlobalConfig
from portbench.reference.cgt.device import to_int32


def voxelize(points: torch.Tensor, valid: torch.Tensor,
             cfg: GlobalConfig) -> torch.Tensor:
  """points [B,N,3] ego-frame, valid [B,N] bool -> [B,2,H,W] float32.

  Slice 0: points at or below lidar_split_height, slice 1: above. Cell
  indices truncate toward zero, as ``astype(int32)`` does, so points in
  (-1, 0) cells count in cell 0."""
  sc = cfg.sensor
  B = points.shape[0]
  H, W = sc.lidar_resolution_height, sc.lidar_resolution_width
  x, y, z = points[..., 0], points[..., 1], points[..., 2]
  cx = to_int32((x - sc.min_x) / (sc.max_x - sc.min_x) * W)
  cy = to_int32((y - sc.min_y) / (sc.max_y - sc.min_y) * H)
  inb = valid & (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
  above = ~(z <= sc.lidar_split_height)
  cell = cy.clamp(0, H - 1).long() * W + cx.clamp(0, W - 1).long()
  b = torch.arange(B, device=points.device)[:, None]
  flat = (b * 2 + above.long()) * (H * W) + cell              # [B,N]
  counts = torch.zeros(B * 2 * H * W, dtype=torch.float32,
                       device=points.device)
  counts.index_add_(0, flat.reshape(-1), inb.reshape(-1).to(torch.float32))
  counts = torch.clamp(counts, max=float(sc.hist_max_per_pixel))
  return (counts / sc.hist_max_per_pixel).reshape(B, 2, H, W)
