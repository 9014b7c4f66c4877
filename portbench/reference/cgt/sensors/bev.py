"""BEV semantic rasterizer (port of carla_garage_tpu/sensors/bev.py).

An 11-class [B,H,W] uint8 label map around each ego: the static layers are
gathered from a window of the town raster at every pixel's world position,
and the stop-sign, traffic-light, vehicle and walker boxes are painted on
top by the ``fill_boxes_bev`` kernel (ops/bev_fill.py).

Class ids: 0 unlabeled, 1 road, 2 sidewalk, 3 lane marking, 4 broken lane
marking, 5 stop sign, 6 light green, 7 light yellow, 8 light red,
9 vehicle, 10 walker.

Grid convention: [H,W] with x (forward) increasing along columns and y
(right) along rows, ego at the grid center; extent +-32 m at 4 px/m, the
LiDAR BEV grid's, so the two align channel for channel.
"""

from __future__ import annotations

import torch

from portbench.reference.cgt.config import GlobalConfig
from portbench.reference.cgt.maps.town_map import Layer, MapStack
from portbench.reference.cgt.ops.bev_fill import fill_boxes_bev
from portbench.reference.cgt.sim import geometry as geo
from portbench.reference.cgt.structs import LightState, Scene, SimState


class BevClass:
  UNLABELED = 0
  ROAD = 1
  SIDEWALK = 2
  LANE_MARKING = 3
  LANE_MARKING_BROKEN = 4
  STOP_SIGN = 5
  LIGHT_GREEN = 6
  LIGHT_YELLOW = 7
  LIGHT_RED = 8
  VEHICLE = 9
  WALKER = 10
  NUM = 11


def bev_grid_world(cfg: GlobalConfig, ego_pos: torch.Tensor,
                   ego_yaw: torch.Tensor) -> torch.Tensor:
  """World coordinates [..,H,W,2] of each BEV pixel for ego poses
  ego_pos [..,2] and ego_yaw [..] (broadcast against [H,W])."""
  sc = cfg.sensor
  H, W = sc.lidar_resolution_height, sc.lidar_resolution_width
  dev = ego_pos.device
  xs = (torch.arange(W, device=dev) + 0.5) / sc.pixels_per_meter + sc.min_x
  ys = (torch.arange(H, device=dev) + 0.5) / sc.pixels_per_meter + sc.min_y
  local = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1)  # [H,W,2]
  return geo.ego_to_world(local, ego_pos, ego_yaw)


def _boxes_to_grid(cfg: GlobalConfig, state: SimState, pos, yaw, extent,
                   valid, cls):
  """World OBBs -> (cx, cy, yaw, ex, ey, cls, valid) in BEV grid-pixel
  units (grid frame = ego frame scaled by pixels per meter: x along
  columns, y along rows)."""
  sc = cfg.sensor
  rel = geo.world_to_ego(pos, state.ego.pos[:, None], state.ego.yaw[:, None])
  ryaw = yaw - state.ego.yaw[:, None]
  cx = (rel[..., 0] - sc.min_x) * sc.pixels_per_meter - 0.5
  cy = (rel[..., 1] - sc.min_y) * sc.pixels_per_meter - 0.5
  ex = extent[..., 0] * sc.pixels_per_meter
  ey = extent[..., 1] * sc.pixels_per_meter
  return cx, cy, ryaw, ex, ey, cls, valid


def render_bev_semantics(cfg: GlobalConfig, maps: MapStack, scene: Scene,
                         state: SimState) -> torch.Tensor:
  """[B,H,W] uint8 class map for the whole batch.

  Static layers, lowest priority first: road, sidewalk, lane marking,
  broken lane marking, each a lookup in a 512 px window of the town
  raster around the ego. Then one kernel launch paints the boxes in
  priority order (later boxes win): stop signs, lights colored by their
  state at the frame's time, vehicles, walkers."""
  sc = cfg.sensor
  B = state.ego.yaw.shape[0]
  H, W = sc.lidar_resolution_height, sc.lidar_resolution_width

  grid = bev_grid_world(cfg, state.ego.pos[:, None, None],
                        state.ego.yaw[:, None, None])          # [B,H,W,2]
  out = torch.zeros((B, H, W), dtype=torch.uint8,
                    device=state.ego.pos.device)
  pix = maps.world_to_pixel(scene.town_id[:, None], grid.reshape(B, -1, 2))

  def sample_layer(ch):
    win, orig = maps.window(scene.town_id, ch, state.ego.pos, 512)
    return MapStack.sample_window(win, orig, pix).reshape(B, H, W) > 0

  for layer, cls in ((Layer.ROAD, BevClass.ROAD),
                     (Layer.SIDEWALK, BevClass.SIDEWALK),
                     (Layer.LANE_MARKING_ALL, BevClass.LANE_MARKING),
                     (Layer.LANE_MARKING_BROKEN,
                      BevClass.LANE_MARKING_BROKEN)):
    out = torch.where(sample_layer(layer), cls, out).to(torch.uint8)

  stops, lights = scene.stops, scene.lights
  lstate = lights.state_at(state.time_s)                        # [B,L]
  light_cls = torch.where(
      lstate == LightState.GREEN, BevClass.LIGHT_GREEN,
      torch.where(lstate == LightState.YELLOW, BevClass.LIGHT_YELLOW,
                  BevClass.LIGHT_RED)).to(torch.int32)
  veh, wlk = state.vehicles, state.walkers

  def const_cls(v, like):
    return torch.full(like.shape[:2], v, dtype=torch.int32,
                      device=like.device)

  groups = [
      _boxes_to_grid(cfg, state, stops.pos, stops.yaw, stops.extent,
                     stops.valid, const_cls(BevClass.STOP_SIGN, stops.pos)),
      _boxes_to_grid(cfg, state, lights.pos, lights.yaw, lights.extent,
                     lights.valid, light_cls),
      _boxes_to_grid(cfg, state, veh.pos, veh.yaw, veh.extent, veh.valid,
                     const_cls(BevClass.VEHICLE, veh.pos)),
      _boxes_to_grid(cfg, state, wlk.pos, wlk.yaw, wlk.extent, wlk.valid,
                     const_cls(BevClass.WALKER, wlk.pos)),
  ]
  args = [torch.cat([g[i] for g in groups], dim=1) for i in range(7)]
  boxes = fill_boxes_bev(*args, h=H, w=W)
  return torch.where(boxes > 0, boxes, out)
