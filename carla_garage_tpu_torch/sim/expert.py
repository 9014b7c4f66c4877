"""The parts of carla_garage_tpu/sim/expert.py that the sensor-on loop
uses: the Control container and the route-planner parameters.
``expert_step`` itself is ported in a later slice."""

from __future__ import annotations

import dataclasses

import torch

from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.sim.route_planner import PlannerParams
from carla_garage_tpu_torch.structs import Struct


@dataclasses.dataclass
class Control(Struct):
  steer: torch.Tensor     # [B]
  throttle: torch.Tensor  # [B]
  brake: torch.Tensor     # [B]


def _dense_planner_params(cfg: GlobalConfig) -> PlannerParams:
  e = cfg.expert
  return PlannerParams(e.dense_route_planner_min_distance,
                       e.dense_route_planner_max_distance,
                       cfg.sim.route_window)


def _sparse_planner_params(cfg: GlobalConfig) -> PlannerParams:
  e = cfg.expert
  return PlannerParams(e.route_planner_min_distance,
                       e.route_planner_max_distance,
                       cfg.sim.route_window)


def _sparse_seg_len(points: torch.Tensor, num_valid: torch.Tensor):
  """Segment lengths of padded sparse routes. points [B,Rs,2],
  num_valid [B] -> [B,Rs] (0 at index 0 and past num_valid)."""
  d = torch.linalg.vector_norm(torch.diff(points, dim=-2), dim=-1)
  seg = torch.cat([torch.zeros_like(d[..., :1]), d], -1)
  mask = torch.arange(points.shape[-2], device=points.device) < \
      num_valid[..., None]
  return torch.where(mask, seg, 0.0)
