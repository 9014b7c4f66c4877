"""Scenario annotations along a route (the part of
carla_garage_tpu/maps/importer.py that the scene builder needs; numpy).

Loading CARLA towns and their annotation files needs the CARLA assets and
is not ported yet; the synthetic town has no annotations.
"""

from __future__ import annotations

import numpy as np


def scenarios_near_route(scenarios: dict, dense: np.ndarray,
                         radius: float = 8.0,
                         yaw_tol: float = np.radians(20.0)) -> dict:
  """Trigger points near the route AND facing its travel direction, with
  their route progress index: {name: (points [M,3], route_idx [M])}.

  The reference's RouteParser matches a trigger to the route by position
  and heading; without the heading gate, annotations of the cross street
  at a junction attach to the route. The yaw test runs per dense point so
  a self-overlapping route matches the pass whose direction agrees."""
  seg = np.diff(dense[:, :2], axis=0)
  ryaw = np.arctan2(seg[:, 1], seg[:, 0])
  ryaw = np.append(ryaw, ryaw[-1])                       # [N]
  out = {}
  for k, pts in scenarios.items():
    if not len(pts):
      continue
    d = np.linalg.norm(dense[None, :, :2] - pts[:, None, :2], axis=-1)
    dyaw = np.abs(np.arctan2(np.sin(pts[:, 2:3] - ryaw[None]),
                             np.cos(pts[:, 2:3] - ryaw[None])))   # [K,N]
    ok = (d < radius) & (dyaw < yaw_tol)
    near = ok.any(1)
    route_idx = np.where(ok, d, np.inf).argmin(1)
    sel = np.nonzero(near)[0]
    out[k] = (pts[sel], route_idx[sel])
  return out
