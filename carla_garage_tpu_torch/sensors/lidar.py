"""Rotating LiDAR raycaster (port of carla_garage_tpu/sensors/lidar.py).

A half sweep is one cast_rays call over a precomputed direction grid; the
dropoff model is a Bernoulli thinning whose uniforms are an explicit input
(or drawn from the caller's generator)."""

from __future__ import annotations

import numpy as np
import torch

from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.device import const
from carla_garage_tpu_torch.maps.town_map import MapStack
from carla_garage_tpu_torch.sensors.raycast import cast_rays
from carla_garage_tpu_torch.sim import geometry as geo
from carla_garage_tpu_torch.structs import Scene, SimState

RANGE_M = 85.0
CHANNELS = 64
UPPER_FOV = 10.0
LOWER_FOV = -30.0
DROPOFF_RATE = 0.45          # dropoff_general_rate


def lidar_ray_grid(cfg: GlobalConfig, half: int = 0,
                   decimate: int = 1) -> np.ndarray:
  """Ray directions [C, A, 3] for one half-rotation (half 0: front 180°,
  half 1: rear). Azimuth count matches 600k pts/s / 10 Hz / 64 ch / 2."""
  sc = cfg.sensor
  n_az = sc.lidar_points_per_second // sc.lidar_rotation_frequency \
      // CHANNELS // 2 // decimate
  az0 = -np.pi / 2 if half == 0 else np.pi / 2
  az = az0 + np.pi * (np.arange(n_az) + 0.5) / n_az
  el = np.radians(np.linspace(UPPER_FOV, LOWER_FOV, CHANNELS))
  A, E = np.meshgrid(az, el)
  d = np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A),
                np.sin(E)], -1)
  return d.astype(np.float32)


def render_lidar(cfg: GlobalConfig, maps: MapStack, scene: Scene,
                 state: SimState, ray_grid, uniform=None,
                 per_episode: bool = False, generator=None):
  """One half-sweep -> points [B,N,3] in the EGO frame + valid mask [B,N]
  (range + dropoff).

  uniform [B,N] in [0,1) are the dropoff draws (a ray is kept where
  uniform > DROPOFF_RATE); when None they are drawn from `generator`.
  per_episode=True takes ray_grid as a [B,N,3] tensor (the sensor agent
  picks the front or rear half per episode before casting)."""
  sc = cfg.sensor
  dev = state.ego.pos.device
  B = state.ego.yaw.shape[0]
  dirs_local = ray_grid if per_episode else \
      torch.as_tensor(ray_grid, device=dev).reshape(1, -1, 3)
  N = dirs_local.shape[-2]
  yaw = state.ego.yaw[:, None]
  dxy = geo.ego_to_world(dirs_local[..., :2], torch.zeros((B, 1, 2),
                                                          device=dev), yaw)
  dirs = torch.cat([dxy, dirs_local[..., 2:].expand(B, N, 1)], -1)
  lid_xy = geo.ego_to_world(const(sc.lidar_pos[:2], dev)[None, None],
                            state.ego.pos[:, None], yaw)
  origins = torch.cat([lid_xy.expand(B, N, 2),
                       torch.full((B, 1, 1), sc.lidar_pos[2],
                                  device=dev).expand(B, N, 1)], -1)
  out = cast_rays(cfg, maps, scene, state, origins, dirs,
                  max_range=RANGE_M, need_ground_sem=False)
  depth = out["depth"]
  hit = depth < RANGE_M - 1e-3
  if uniform is None:
    uniform = torch.rand((B, N), generator=generator, device=dev)
  valid = hit & (uniform > DROPOFF_RATE)
  pts_local = dirs_local * depth[..., None]
  pts = pts_local + const(sc.lidar_pos, dev)
  return pts, valid
