"""Pinhole camera rendering: RGB / semantic / depth from the analytic scene
(port of carla_garage_tpu/sensors/camera.py)."""

from __future__ import annotations

import numpy as np
import torch

from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.device import const
from carla_garage_tpu_torch.maps.town_map import MapStack
from carla_garage_tpu_torch.sensors.raycast import Sem, cast_rays
from carla_garage_tpu_torch.sim import geometry as geo
from carla_garage_tpu_torch.structs import Scene, SimState

# camera palette (rows 7/8: render-only green / yellow light states)
PALETTE = np.array([
    [0, 0, 0],          # unlabeled / sky
    [30, 170, 250],     # vehicle
    [200, 200, 200],    # road
    [255, 40, 20],      # traffic light — RED state
    [220, 20, 60],      # pedestrian
    [0, 255, 255],      # road line
    [255, 255, 255],    # sidewalk
    [40, 255, 70],      # traffic light — GREEN state
    [255, 210, 40],     # traffic light — YELLOW state
], np.float32) / 255.0


def camera_ray_grid(cfg: GlobalConfig, scale: int = 1) -> np.ndarray:
  """Unit ray directions [H,W,3] in the camera (=ego, yaw 0) frame."""
  sc = cfg.sensor
  H, W = sc.camera_height // scale, sc.camera_width // scale
  f = sc.camera_width / (2.0 * np.tan(np.radians(sc.camera_fov) / 2.0))
  us = (np.arange(W) + 0.5) * scale - sc.camera_width / 2.0
  vs = (np.arange(H) + 0.5) * scale - sc.camera_height / 2.0
  uu, vv = np.meshgrid(us, vs)
  d = np.stack([np.full_like(uu, f), uu, -vv], -1)   # x fwd, y right, z up
  return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def render_camera(cfg: GlobalConfig, maps: MapStack, scene: Scene,
                  state: SimState, ray_grid):
  """-> dict(rgb [B,H,W,3] f32 0..1, semantic [B,H,W] i32, depth [B,H,W])."""
  sc = cfg.sensor
  H, W = ray_grid.shape[:2]
  dev = state.ego.pos.device
  B = state.ego.yaw.shape[0]
  dirs_local = torch.as_tensor(ray_grid, device=dev).reshape(1, -1, 3)
  N = dirs_local.shape[1]
  yaw = state.ego.yaw[:, None]
  dxy = geo.ego_to_world(dirs_local[..., :2], torch.zeros((B, 1, 2),
                                                          device=dev), yaw)
  dirs = torch.cat([dxy, dirs_local[..., 2:].expand(B, N, 1)], -1)
  cam_off = const(sc.camera_pos[:2], dev)
  cam_xy = geo.ego_to_world(cam_off[None, None], state.ego.pos[:, None], yaw)
  origins = torch.cat([cam_xy.expand(B, N, 2),
                       torch.full((B, 1, 1), sc.camera_pos[2],
                                  device=dev).expand(B, N, 1)], -1)
  out = cast_rays(cfg, maps, scene, state, origins, dirs,
                  grid_hw=(H, W), ground_subsample=4)
  sem_render = out["sem"].reshape(B, H, W)
  depth = out["depth"].reshape(B, H, W)
  shade = 1.0 / (1.0 + 0.02 * depth)
  palette = const(PALETTE, dev)
  rgb = palette[sem_render.long()] * shade[..., None]
  sem = torch.where(sem_render >= Sem.LIGHT_GREEN, Sem.LIGHT, sem_render)
  return {"rgb": rgb, "semantic": sem, "depth": depth}
