"""Episode -> leaderboard scores (port of carla_garage_tpu/sim/scoring.py).

Turns the CriteriaState accumulators into the CARLA leaderboard metrics:
  score_route    RC = route completion % (100 once completed)
  score_penalty  IS = product of infraction penalties, discounted by the
                      share of distance driven outside the route's lanes
  score_composed DS = RC x IS
plus infractions per km, as tensor reductions on the state's device.
"""

from __future__ import annotations

import dataclasses

import torch

from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.structs import CriteriaState, Struct


@dataclasses.dataclass
class RouteScores(Struct):
  score_route: torch.Tensor      # [B] percent 0-100
  score_penalty: torch.Tensor    # [B] 0-1
  score_composed: torch.Tensor   # [B] percent
  completed: torch.Tensor        # [B] bool
  infractions_per_km: dict


def compute_scores(cfg: GlobalConfig, cr: CriteriaState,
                   route_len_m: torch.Tensor) -> RouteScores:
  """route_len_m [B]: each route's length in metres."""
  c = cfg.criteria
  # OutsideRouteLanes discounts the penalty by the share of distance driven
  # off-lane (statistics penalty 1 - percentage / 100)
  off_frac = torch.where(cr.driven_m > 0,
                         cr.outside_lane_m / cr.driven_m, 0.0)
  penalty = cr.penalty * (1.0 - off_frac)
  rc = cr.route_completion * 100.0
  completed = cr.route_completion >= c.min_route_completion
  rc = torch.where(completed, 100.0, rc)
  ds = torch.clamp(rc * penalty, min=0.0)
  km = torch.clamp(cr.route_completion * route_len_m / 1000.0, min=1e-3)
  inf_km = {
      'collisions_vehicle': cr.n_collision_vehicle / km,
      'collisions_pedestrian': cr.n_collision_walker / km,
      'collisions_layout': cr.n_collision_static / km,
      'red_light': cr.n_red_light / km,
      'stop_infraction': cr.n_stop_sign / km,
  }
  return RouteScores(score_route=rc, score_penalty=penalty,
                     score_composed=ds, completed=completed,
                     infractions_per_km=inf_km)


def global_stats(scores: RouteScores) -> dict:
  """Benchmark aggregation (compute_global_statistics): means over the
  routes as 0-d tensors, and the route count."""
  return {
      'driving_score': torch.mean(scores.score_composed),
      'route_completion': torch.mean(scores.score_route),
      'infraction_score': torch.mean(scores.score_penalty),
      'num_routes': scores.score_route.shape[0],
  }
