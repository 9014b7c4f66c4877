"""Kinematic bicycle dynamics (port of carla_garage_tpu/sim/dynamics.py)."""

from __future__ import annotations

import torch

from carla_garage_tpu_torch.config import SimConfig


def bicycle_step(pos, yaw, speed, steer, throttle, brake, cfg: SimConfig,
                 dt: float | None = None):
  """One dt step of the WoR-tuned kinematic bicycle.

  All args broadcastable; pos [..,2], others [..]. Returns (pos, yaw, speed).
    accel = brake ? brake_accel : throt_accel * throttle
    beta  = atan(rear/(front+rear) * tan(steer_gain * steer))
    x    += v cos(yaw+beta) dt ;  y += v sin(yaw+beta) dt
    yaw  += v / rear * sin(beta) dt ;  v = max(v + accel dt, 0)
  """
  dt = cfg.dt if dt is None else dt
  braking = brake > 0.5
  accel = torch.where(braking, cfg.brake_accel, cfg.throt_accel * throttle)
  wheel = cfg.steer_gain * steer
  beta = torch.atan(cfg.rear_wb / (cfg.front_wb + cfg.rear_wb)
                    * torch.tan(wheel))
  heading = yaw + beta
  dpos = speed[..., None] * torch.stack(
      [torch.cos(heading), torch.sin(heading)], -1) * dt
  new_pos = pos + dpos
  new_yaw = yaw + speed / cfg.rear_wb * torch.sin(beta) * dt
  new_speed = torch.clamp(speed + accel * dt, min=0.0)
  return new_pos, new_yaw, new_speed

