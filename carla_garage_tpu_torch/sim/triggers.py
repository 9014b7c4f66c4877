"""Atomic trigger conditions as masked predicates (port of the part of
carla_garage_tpu/sim/triggers.py that the sensor-on loop runs)."""

from __future__ import annotations

import torch


def in_time_to_arrival(pos, speed, target, t_max, eps: float = 0.001):
  """InTimeToArrivalToLocation: distance / velocity < t_max; a (near-)
  stopped actor has infinite time-to-arrival."""
  d = torch.linalg.vector_norm(target - pos, dim=-1)
  return d / torch.clamp(speed, min=eps) < t_max
