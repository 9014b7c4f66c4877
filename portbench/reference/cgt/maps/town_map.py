"""Tensorized town maps (port of carla_garage_tpu/maps/town_map.py).

A stacked uint8 raster per town plus lane-graph polylines for NPC routing,
queried on the device with pure gathers.

Pixel convention: px = (world_xy - world_offset) * pixels_per_meter,
row = py, col = px. Rounding is half to even (``torch.round``, as
``jnp.round``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.cgt.device import resolve_device, to_int32
from portbench.reference.cgt.structs import Struct


class Layer:
  """Raster channel indices."""
  ROAD = 0
  SIDEWALK = 1
  LANE_MARKING_ALL = 2
  LANE_MARKING_BROKEN = 3
  STOPLINE = 4
  JUNCTION = 5
  OBSTACLE = 6
  GROUND_SEM = 7
  LANE_DIR = 8
  NUM = 9


@dataclasses.dataclass
class MapStack(Struct):
  """layers [T,C,H,W] uint8 (0/255 occupancy), ppm [] float,
  world_offset [T,2] float (meters of pixel (0,0))."""
  layers: torch.Tensor
  ppm: torch.Tensor
  world_offset: torch.Tensor

  def world_to_pixel(self, town_id: torch.Tensor, xy: torch.Tensor):
    """xy [..,2] world meters -> float pixel coords [..,2] (px, py)."""
    return (xy - self.world_offset[town_id.long()]) * self.ppm

  def _pixel(self, town_id, xy):
    tid = town_id[..., None] if town_id.ndim and \
        town_id.ndim < xy.ndim - 1 else town_id
    p = self.world_to_pixel(tid, xy)
    px = to_int32(torch.round(p[..., 0]))
    py = to_int32(torch.round(p[..., 1]))
    h, w = self.layers.shape[-2], self.layers.shape[-1]
    inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    return px.clamp(0, w - 1).long(), py.clamp(0, h - 1).long(), inb

  def sample(self, town_id: torch.Tensor, channel: int,
             xy: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor occupancy sample. xy [..,2] -> bool [..];
    out-of-bounds samples are False."""
    pxc, pyc, inb = self._pixel(town_id, xy)
    val = self.layers[town_id.long(), channel, pyc, pxc]
    return inb & (val > 0)

  def sample_value(self, town_id: torch.Tensor, channel: int,
                   xy: torch.Tensor) -> torch.Tensor:
    """Raw raster value (0 out of bounds) as int32. xy [..,2] -> [..]."""
    pxc, pyc, inb = self._pixel(town_id, xy)
    val = self.layers[town_id.long(), channel, pyc, pxc]
    return torch.where(inb, val.to(torch.int32), 0).to(torch.int32)

  def window(self, town_id: torch.Tensor, channel: int,
             center_xy: torch.Tensor, size_px: int):
    """Contiguous [B,S,S] window of one channel around per-episode centers,
    its start clamped into the raster as ``lax.dynamic_slice`` clamps.
    Returns (window [B,S,S], origin_px [B,2] int32)."""
    p = self.world_to_pixel(town_id, center_xy)        # [B,2]
    h, w = self.layers.shape[-2], self.layers.shape[-1]
    ox = (to_int32(torch.round(p[..., 0])) - size_px // 2).clamp(
        0, max(w - size_px, 0))
    oy = (to_int32(torch.round(p[..., 1])) - size_px // 2).clamp(
        0, max(h - size_px, 0))
    dev = self.layers.device
    ys = oy[:, None].long() + torch.arange(min(size_px, h), device=dev)
    xs = ox[:, None].long() + torch.arange(min(size_px, w), device=dev)
    win = self.layers[town_id.long()[:, None, None], channel,
                      ys[:, :, None], xs[:, None, :]]
    return win, torch.stack([ox, oy], -1)

  @staticmethod
  def sample_window(win: torch.Tensor, origin_px: torch.Tensor,
                    pix: torch.Tensor) -> torch.Tensor:
    """Sample [B,S,S] windows at float pixel coords pix [B,N,2]
    (edge-clamped). Returns [B,N] int32 values."""
    S = win.shape[-1]
    px = (to_int32(torch.round(pix[..., 0])) - origin_px[:, None, 0]).clamp(
        0, S - 1)
    py = (to_int32(torch.round(pix[..., 1])) - origin_px[:, None, 1]).clamp(
        0, S - 1)
    flat = (py * S + px).long()
    return torch.gather(win.reshape(win.shape[0], -1), 1,
                        flat).to(torch.int32)


def stack_towns(rasters: list, offsets: list, ppm: float,
                device="cuda") -> MapStack:
  """Pad per-town [C,H,W] uint8 rasters to a common size and stack them to
  [T,C,H,W] on `device`."""
  max_h = max(r.shape[1] for r in rasters)
  max_w = max(r.shape[2] for r in rasters)
  padded = np.zeros((len(rasters), rasters[0].shape[0], max_h, max_w),
                    np.uint8)
  for i, r in enumerate(rasters):
    padded[i, :, :r.shape[1], :r.shape[2]] = r
  dev = resolve_device(device)
  return MapStack(
      layers=torch.from_numpy(padded).to(dev),
      ppm=torch.tensor(np.float32(ppm), device=dev),
      world_offset=torch.from_numpy(
          np.stack(offsets).astype(np.float32)).to(dev))


@dataclasses.dataclass
class LaneGraph(Struct):
  """NPC routing lanes as fixed-shape polylines: points [N,P,2],
  num_valid [N], successor [N,MAX_SUCC] (-1 = none), seg_len [N,P],
  total_len [N]."""
  points: torch.Tensor
  num_valid: torch.Tensor
  successor: torch.Tensor
  seg_len: torch.Tensor
  total_len: torch.Tensor

  @staticmethod
  def from_polylines(polys: list, successors: list,
                     max_points: int | None = None, max_succ: int = 4,
                     device="cuda") -> "LaneGraph":
    """Pad host polylines [P_i,2] and successor lists into a LaneGraph on
    `device` (points past a polyline's end repeat its last point)."""
    n = len(polys)
    if max_points is None:   # fit the longest polyline (rounded up)
      longest = max(len(p) for p in polys) if polys else 2
      max_points = max(-(-longest // 64) * 64, 64)
    pts = np.zeros((n, max_points, 2), np.float32)
    nv = np.zeros((n,), np.int32)
    suc = -np.ones((n, max_succ), np.int32)
    seg = np.zeros((n, max_points), np.float32)
    tot = np.zeros((n,), np.float32)
    for i, poly in enumerate(polys):
      poly = np.asarray(poly, np.float32)[:max_points]
      pts[i, :len(poly)] = poly
      pts[i, len(poly):] = poly[-1]
      nv[i] = len(poly)
      seg[i, 1:len(poly)] = np.linalg.norm(np.diff(poly, axis=0), axis=-1)
      tot[i] = seg[i].sum()
      for j, s in enumerate(successors[i][:max_succ]):
        suc[i, j] = s
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(a).to(dev)
    return LaneGraph(points=t(pts), num_valid=t(nv), successor=t(suc),
                     seg_len=t(seg), total_len=t(tot))

  def position_at(self, lane_id: torch.Tensor, t: torch.Tensor):
    """Interpolated (pos [..,2], yaw [..]) at arc-length t on lane lane_id."""
    lid = lane_id.long()
    seg = self.seg_len[lid]                          # [..,P]
    cum = torch.cumsum(seg, -1)
    idx = torch.sum((cum <= t[..., None]).to(torch.int64), -1)
    idx = idx.clamp(1, self.points.shape[1] - 1)
    pts = self.points[lid]                           # [..,P,2]

    def take_pt(i):
      return torch.gather(pts, -2, i[..., None, None].expand(
          *i.shape, 1, 2))[..., 0, :]

    p0 = take_pt(idx - 1)
    p1 = take_pt(idx)
    c0 = torch.gather(cum, -1, (idx - 1)[..., None])[..., 0]
    s = torch.gather(seg, -1, idx[..., None])[..., 0]
    frac = ((t - c0) / torch.clamp(s, min=1e-6)).clamp(0.0, 1.0)
    pos = p0 + (p1 - p0) * frac[..., None]
    d = p1 - p0
    yaw = torch.atan2(d[..., 1], d[..., 0])
    return pos, yaw
