"""Atomic trigger conditions as masked predicates (port of
carla_garage_tpu/sim/triggers.py).

srunner's py_trees conditions as [B,K]-shaped predicates that the scenario
step evaluates every tick:

  InTriggerDistanceToLocation -> in_trigger_distance
  InTimeToArrivalToLocation   -> in_time_to_arrival
  InTriggerRegion             -> in_trigger_region
  TriggerVelocity             -> trigger_velocity
"""

from __future__ import annotations

import torch


class TriggerKind:
  DISTANCE = 0          # d(actor, location) < dist
  TIME_TO_ARRIVAL = 1   # d / max(v, eps) < t
  REGION = 2            # |dx| < ex and |dy| < ey
  VELOCITY = 3          # v > v_min


def in_trigger_distance(pos, target, dist):
  """InTriggerDistanceToLocation: Euclidean proximity."""
  return torch.linalg.vector_norm(target - pos, dim=-1) < dist


def in_time_to_arrival(pos, speed, target, t_max, eps: float = 0.001):
  """InTimeToArrivalToLocation: distance / velocity < t_max; a (near-)
  stopped actor has infinite time-to-arrival."""
  d = torch.linalg.vector_norm(target - pos, dim=-1)
  return d / torch.clamp(speed, min=eps) < t_max


def in_trigger_region(pos, center, half_extent):
  """InTriggerRegion: axis-aligned x/y window membership."""
  return torch.all(torch.abs(pos - center) < half_extent, dim=-1)


def trigger_velocity(speed, v_min):
  """TriggerVelocity (operator.gt)."""
  return speed > v_min


def evaluate(kind, pos, speed, target, dist, param, half_extent):
  """Dispatch over TriggerKind rows; all arguments broadcast over [B,K]
  (pos and speed are the ego's, broadcast to every spec row). The first
  matching kind wins and an unknown kind is False, as ``jnp.select``
  with ``default=False``."""
  rows = [(kind == TriggerKind.DISTANCE,
           in_trigger_distance(pos, target, dist)),
          (kind == TriggerKind.TIME_TO_ARRIVAL,
           in_time_to_arrival(pos, speed, target, param)),
          (kind == TriggerKind.REGION,
           in_trigger_region(pos, target, half_extent)),
          (kind == TriggerKind.VELOCITY, trigger_velocity(speed, param))]
  out = torch.zeros_like(rows[0][0])
  for cond, value in reversed(rows):
    out = torch.where(cond, value, out)
  return out
