"""Inference-time controllers — model outputs -> vehicle control (port of
carla_garage_tpu/agents/controllers.py)."""

from __future__ import annotations

import torch

from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.sim.pid import PIDParams, pid_step
from carla_garage_tpu_torch.structs import PIDState


def waypoint_speed(waypoints: torch.Tensor) -> torch.Tensor:
  """The desired speed [B] of waypoints [B,P,2] at 4 Hz: the distance
  from the half-second to the one-second waypoint, per second."""
  one_second = 4
  half_second = 2
  return torch.linalg.vector_norm(
      waypoints[:, half_second - 1] - waypoints[:, one_second - 1],
      dim=-1) * 2.0


def control_pid(pid_turn: PIDState, pid_speed: PIDState,
                waypoints: torch.Tensor, speed: torch.Tensor,
                cfg: GlobalConfig):
  """Waypoint-output controller. waypoints [B,P,2] ego-frame future
  positions at 4 Hz; speed [B]. Returns (steer, throttle, brake, states...)."""
  e = cfg.expert
  desired_speed = waypoint_speed(waypoints)
  brake = (desired_speed < 0.4) | \
      ((speed / torch.clamp(desired_speed, min=1e-6)) > e.brake_ratio)
  delta = torch.clamp(desired_speed - speed, 0.0, e.clip_delta)
  pid_speed2, thr = pid_step(pid_speed, delta,
                             PIDParams(e.speed_kp, e.speed_ki, e.speed_kd,
                                       e.speed_n))
  throttle = torch.clamp(thr, 0.0, e.clip_throttle)
  throttle = torch.where(brake, 0.0, throttle)
  aim_distance = torch.where(desired_speed < 5.5, 2.25, 3.0)
  dist = torch.linalg.vector_norm(waypoints, dim=-1)            # [B,P]
  far_enough = dist >= aim_distance[:, None]
  first = torch.argmax(far_enough.to(torch.uint8), dim=-1)      # first True
  none_far = ~far_enough.any(-1)
  aim_idx = torch.where(none_far, waypoints.shape[1] - 1, first)
  aim = torch.gather(waypoints, 1,
                     aim_idx[:, None, None].expand(-1, 1, 2))[:, 0]
  angle = torch.rad2deg(torch.atan2(aim[:, 1], aim[:, 0])) / 90.0
  angle = torch.where((speed < 0.01) | brake, 0.0, angle)
  pid_turn2, st = pid_step(pid_turn, angle,
                           PIDParams(e.turn_kp, e.turn_ki, e.turn_kd,
                                     e.turn_n))
  steer = torch.clamp(st, -1.0, 1.0)
  return steer, throttle, brake.to(torch.float32), pid_turn2, pid_speed2


def control_pid_direct(pid_turn: PIDState, pid_speed: PIDState,
                       target_speed: torch.Tensor, angle: torch.Tensor,
                       speed: torch.Tensor, cfg: GlobalConfig):
  """Direct-output controller: classified target speed (m/s, 0 = brake)
  + predicted route angle (normalized [-1,1])."""
  e = cfg.expert
  brake = target_speed < 0.01
  angle = torch.where(speed < 0.01, 0.0, angle)
  pid_turn2, st = pid_step(pid_turn, angle,
                           PIDParams(e.turn_kp, e.turn_ki, e.turn_kd,
                                     e.turn_n))
  steer = torch.clamp(st, -1.0, 1.0)
  brake = brake | ((speed / torch.clamp(target_speed, min=1e-6)) >
                   e.brake_ratio)
  ts = torch.where(brake, 0.0, target_speed)
  delta = torch.clamp(ts - speed, 0.0, e.clip_delta)
  pid_speed2, thr = pid_step(pid_speed, delta,
                             PIDParams(e.speed_kp, e.speed_ki, e.speed_kd,
                                       e.speed_n))
  throttle = torch.clamp(thr, 0.0, e.clip_throttle)
  throttle = torch.where(brake, 0.0, throttle)
  return steer, throttle, brake.to(torch.float32), pid_turn2, pid_speed2
