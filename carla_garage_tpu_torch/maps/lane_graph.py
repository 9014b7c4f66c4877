"""Lane-direction raster (the part of carla_garage_tpu/maps/lane_graph.py
that the synthetic town needs; host side, numpy).

Skeleton and lane-graph recovery from imported rasters come with the town
importer, which is not ported yet.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

DIR_BINS = 16          # lane-direction raster quantization


def rasterize_direction(lane_polys: list, road: np.ndarray,
                        pixel_m: float,
                        world_offset: np.ndarray) -> np.ndarray:
  """[H,W] uint8 lane-direction channel: 0 = none, 1..DIR_BINS = yaw bin.

  Lanes are stamped as sampled seeds, then the nearest seed is propagated
  over all road pixels (EDT indices). Two-way corridors stamp both
  directions; the nearest lane wins, so each half of the road carries its
  own direction, as the wrong-way criterion needs. `pixel_m` is the
  raster's metres per pixel."""
  H, W = road.shape
  seeds = np.zeros((H, W), np.uint8)
  for poly in lane_polys:
    if len(poly) < 2:
      continue
    seg = np.linalg.norm(np.diff(poly, axis=0), axis=-1)
    arc = np.concatenate([[0.0], np.cumsum(seg)])
    total = arc[-1]
    if total < pixel_m:
      continue
    t = np.arange(0.0, total, 0.5 * pixel_m)
    xs = np.interp(t, arc, poly[:, 0])
    ys = np.interp(t, arc, poly[:, 1])
    yaw = np.arctan2(np.gradient(ys), np.gradient(xs))
    bins = (np.round(yaw / (2 * np.pi / DIR_BINS)).astype(int)
            % DIR_BINS) + 1
    px = np.clip(np.round((xs - world_offset[0]) / pixel_m).astype(int),
                 0, W - 1)
    py = np.clip(np.round((ys - world_offset[1]) / pixel_m).astype(int),
                 0, H - 1)
    seeds[py, px] = bins
  if not seeds.any():
    return seeds
  _, (iy, ix) = ndimage.distance_transform_edt(seeds == 0,
                                               return_indices=True)
  out = seeds[iy, ix]
  out[~road] = 0
  return out


def bin_to_yaw(bins: np.ndarray) -> np.ndarray:
  """Inverse of the direction-bin quantization (bins 1..DIR_BINS)."""
  return (bins - 1) * (2 * np.pi / DIR_BINS)
