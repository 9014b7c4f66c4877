"""Bilinear grid sampling as index gathers (port of
carla_garage_tpu/ops/sampling.py).

The JAX function is plain XLA gathers, outside any Pallas kernel; this is
the same arithmetic in PyTorch: coordinates clamped to the border, the
corners at floor and floor + 1 (clamped), weights from the clamped
coordinate.
"""

from __future__ import annotations

import torch


def grid_sample_2d(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
  """Bilinear sample. img [..., H, W, C] (a leading batch axis samples
  every map at the same points); coords [..., 2] as (x, y) pixel floats.
  Out-of-bounds points clamp to the border. Returns [..., *coords[:-1], C]
  with img's leading axes first."""
  H, W = img.shape[-3], img.shape[-2]
  x = coords[..., 0].clamp(0.0, W - 1.0)
  y = coords[..., 1].clamp(0.0, H - 1.0)
  x0 = torch.floor(x).long()
  y0 = torch.floor(y).long()
  x1 = torch.clamp(x0 + 1, max=W - 1)
  y1 = torch.clamp(y0 + 1, max=H - 1)
  wx = (x - x0.to(x.dtype))[..., None]
  wy = (y - y0.to(y.dtype))[..., None]
  v00 = img[..., y0, x0, :]
  v01 = img[..., y0, x1, :]
  v10 = img[..., y1, x0, :]
  v11 = img[..., y1, x1, :]
  return ((1 - wy) * ((1 - wx) * v00 + wx * v01) +
          wy * ((1 - wx) * v10 + wx * v11))
