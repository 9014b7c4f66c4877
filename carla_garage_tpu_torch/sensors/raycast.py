"""Shared ray-casting core for camera and LiDAR rendering (port of
carla_garage_tpu/sensors/raycast.py, kernel path).

The scene is analytic: a textured ground plane (the town raster gives
per-point semantics), extruded actor boxes (vehicles, walkers) and
traffic-light poles. Box intersections run in the ``raycast_boxes`` CUDA
kernel after ``cull_boxes`` keeps the 48 nearest boxes per episode. The
JAX package's dense path (every ray against every box, lights in three
passes), which it takes on the CPU, is not ported yet.

Semantic ids follow the reference camera palette: 0 unlabeled/sky,
1 vehicle, 2 road, 3 traffic light, 4 pedestrian, 5 road line, 6 sidewalk.
"""

from __future__ import annotations

import torch

from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.maps.town_map import Layer, MapStack
from carla_garage_tpu_torch.ops.raycast import raycast_boxes
from carla_garage_tpu_torch.structs import LightState, Scene, SimState

MAX_DEPTH = 1000.0
VEHICLE_HEIGHT = 1.55
WALKER_HEIGHT = 1.8
LIGHT_POLE_HEIGHT = 5.0


class Sem:
  SKY = 0
  VEHICLE = 1
  ROAD = 2
  LIGHT = 3        # red (the safety-critical default)
  WALKER = 4
  ROAD_LINE = 5
  SIDEWALK = 6
  # render-only light states; the 7-class semantic output collapses them
  # back to LIGHT
  LIGHT_GREEN = 7
  LIGHT_YELLOW = 8
  NUM_RENDER = 9


def light_render_class(lstate: torch.Tensor) -> torch.Tensor:
  """Per-light render class from a LightState array."""
  return torch.where(lstate == LightState.GREEN, Sem.LIGHT_GREEN,
                     torch.where(lstate == LightState.YELLOW,
                                 Sem.LIGHT_YELLOW, Sem.LIGHT)
                     ).to(torch.int32)


def _gather_boxes(cfg: GlobalConfig, scene: Scene, state: SimState):
  """All scene boxes as one [B,K,9] array (kernel layout:
  cx, cy, cos, sin, ex, ey, ez, class, valid)."""
  veh, wlk = state.vehicles, state.walkers
  lights = scene.lights

  def pack(pos, yaw, ext_xy, ez, cls_id, valid):
    cls_arr = cls_id.to(torch.float32) if torch.is_tensor(cls_id) else \
        torch.full_like(yaw, cls_id)
    return torch.stack([
        pos[..., 0], pos[..., 1], torch.cos(yaw), torch.sin(yaw),
        ext_xy[..., 0], ext_xy[..., 1],
        torch.full_like(yaw, ez), cls_arr,
        valid.to(torch.float32)], -1)

  light_cls = light_render_class(lights.state_at(state.time_s))
  pole = torch.full(lights.pos.shape, 0.3, device=lights.pos.device)
  return torch.cat([
      pack(veh.pos, veh.yaw, veh.extent, VEHICLE_HEIGHT / 2,
           Sem.VEHICLE, veh.valid),
      pack(wlk.pos, wlk.yaw, wlk.extent, WALKER_HEIGHT / 2,
           Sem.WALKER, wlk.valid),
      pack(lights.pos, lights.yaw, pole, LIGHT_POLE_HEIGHT / 2, light_cls,
           lights.valid),
  ], dim=1)


def cull_boxes(boxes: torch.Tensor, ego_pos: torch.Tensor,
               max_boxes: int = 48, max_range: float = MAX_DEPTH,
               light_slots: int = 8) -> torch.Tensor:
  """Keep the max_boxes nearest valid boxes per episode (ego-centric),
  light_slots of them reserved for traffic-light poles (lights and
  dynamic actors are culled in separate top-k pools). Boxes beyond
  max_range (+15 m slack) are invalidated.

  Invalid boxes sit at an infinite distance, so which of them fill the
  unused slots may differ from ``lax.top_k``'s choice on a tie; they are
  marked invalid either way and hit no ray."""
  K = boxes.shape[1]
  if K <= max_boxes:
    return boxes
  d2 = (boxes[..., 0] - ego_pos[:, 0:1]) ** 2 + \
       (boxes[..., 1] - ego_pos[:, 1:2]) ** 2
  d2 = torch.where(boxes[..., 8] > 0, d2, torch.inf)
  cls = boxes[..., 7]
  is_light = (cls == Sem.LIGHT) | (cls >= Sem.LIGHT_GREEN)
  lim = (max_range + 15.0) ** 2

  def pool(mask, k):
    dd = torch.where(mask, d2, torch.inf)
    _, idx = torch.topk(-dd, k, dim=1)
    sel = torch.gather(boxes, 1, idx[..., None].expand(-1, -1,
                                                       boxes.shape[2]))
    sel_d2 = torch.gather(dd, 1, idx)
    keep = torch.where(sel_d2 <= lim, sel[..., 8], 0.0)
    return torch.cat([sel[..., :8], keep[..., None]], -1)

  return torch.cat([pool(~is_light, max_boxes - light_slots),
                    pool(is_light, light_slots)], dim=1)


def cast_rays(cfg: GlobalConfig, maps: MapStack, scene: Scene,
              state: SimState, origins: torch.Tensor, dirs: torch.Tensor,
              max_range: float = MAX_DEPTH, need_ground_sem: bool = True,
              grid_hw=None, ground_subsample: int = 1):
  """origins/dirs [B,N,3] world frame -> dict(depth [B,N], sem [B,N]).

  One ray origin per episode (true for camera and LiDAR mounts): the
  kernel takes origins[:, 0]. need_ground_sem=False skips the ground
  semantic lookup (LiDAR needs only depth); ground_subsample=s with
  grid_hw=(H, W) samples the ground class on an s-strided grid and
  nearest-upsamples it."""
  B, N = dirs.shape[:2]
  dz_ = dirs[..., 2]
  t_ground = torch.where(dz_ < -1e-6, -origins[..., 2] / dz_, torch.inf)
  if need_ground_sem:
    gpt = origins[..., :2] + dirs[..., :2] * t_ground[..., None]
    win, origin_px = maps.window(scene.town_id, Layer.GROUND_SEM,
                                 state.ego.pos, 512)
    s = ground_subsample
    if s > 1 and grid_hw is not None:
      H, W = grid_hw
      g = gpt.reshape(B, H, W, 2)[:, ::s, ::s]
      hs, ws = g.shape[1], g.shape[2]
      pix = maps.world_to_pixel(scene.town_id[:, None], g.reshape(B, -1, 2))
      gs = MapStack.sample_window(win, origin_px, pix).reshape(B, hs, ws)
      gs = gs.repeat_interleave(s, 1).repeat_interleave(s, 2)[:, :H, :W]
      ground_sem = gs.reshape(B, N)
    else:
      pix = maps.world_to_pixel(scene.town_id[:, None], gpt)
      ground_sem = MapStack.sample_window(win, origin_px, pix)
  else:
    ground_sem = torch.full((B, N), Sem.ROAD, dtype=torch.int32,
                            device=dirs.device)
  best_t = t_ground
  best_sem = torch.where(torch.isfinite(t_ground), ground_sem, Sem.SKY)

  boxes = cull_boxes(_gather_boxes(cfg, scene, state), state.ego.pos,
                     max_range=max_range)
  t_box, cls_box = raycast_boxes(origins[:, 0].contiguous(),
                                 dirs.contiguous(), boxes.contiguous())
  closer = t_box < best_t
  best_t = torch.where(closer, t_box, best_t)
  best_sem = torch.where(closer, cls_box, best_sem)
  depth = torch.where(torch.isfinite(best_t) & (best_t < 1e8), best_t,
                      max_range)
  depth = torch.clamp(depth, max=max_range)
  sem = torch.where(best_t <= max_range, best_sem, Sem.SKY)
  return {"depth": depth, "sem": sem.to(torch.int32)}
