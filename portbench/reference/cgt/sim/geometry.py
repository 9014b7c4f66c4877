"""Vectorized 2D geometry (port of carla_garage_tpu/sim/geometry.py):
transforms, angles, oriented-box intersection."""

from __future__ import annotations

import math

import torch


def normalize_angle(a: torch.Tensor) -> torch.Tensor:
  """Wrap angle(s) to [-pi, pi) (``jnp.mod`` semantics: sign of divisor)."""
  return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def rot2d(yaw: torch.Tensor) -> torch.Tensor:
  """Rotation matrices [..,2,2] for yaw [..]."""
  c, s = torch.cos(yaw), torch.sin(yaw)
  return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                     -2)


def world_to_ego(points: torch.Tensor, ego_pos: torch.Tensor,
                 ego_yaw: torch.Tensor) -> torch.Tensor:
  """World xy -> ego frame (x forward, y left). points [..,2]; broadcasts."""
  d = points - ego_pos
  c, s = torch.cos(ego_yaw), torch.sin(ego_yaw)
  x = c * d[..., 0] + s * d[..., 1]
  y = -s * d[..., 0] + c * d[..., 1]
  return torch.stack([x, y], -1)


def ego_to_world(points: torch.Tensor, ego_pos: torch.Tensor,
                 ego_yaw: torch.Tensor) -> torch.Tensor:
  c, s = torch.cos(ego_yaw), torch.sin(ego_yaw)
  x = c * points[..., 0] - s * points[..., 1]
  y = s * points[..., 0] + c * points[..., 1]
  return torch.stack([x, y], -1) + ego_pos


def angle_to_target_deg(pos: torch.Tensor, yaw: torch.Tensor,
                        target: torch.Tensor) -> torch.Tensor:
  """Signed angle (degrees) from heading to target point."""
  local = world_to_ego(target, pos, yaw)
  return -torch.rad2deg(torch.atan2(-local[..., 1], local[..., 0]))


def obb_intersect(c1, y1, e1, c2, y2, e2) -> torch.Tensor:
  """Batched 2D OBB overlap via the separating-axis theorem.

  c* [..,2] centers, y* [..] yaws, e* [..,2] half-extents; broadcasts over
  leading dims; returns bool [..]."""
  d = c2 - c1
  cs1, sn1 = torch.cos(y1), torch.sin(y1)
  cs2, sn2 = torch.cos(y2), torch.sin(y2)
  f1 = torch.stack([cs1, sn1], -1)
  r1 = torch.stack([-sn1, cs1], -1)
  f2 = torch.stack([cs2, sn2], -1)
  r2 = torch.stack([-sn2, cs2], -1)

  def separated(axis):
    proj_d = torch.abs(torch.sum(d * axis, -1))
    rad1 = (torch.abs(torch.sum(f1 * axis, -1)) * e1[..., 0] +
            torch.abs(torch.sum(r1 * axis, -1)) * e1[..., 1])
    rad2 = (torch.abs(torch.sum(f2 * axis, -1)) * e2[..., 0] +
            torch.abs(torch.sum(r2 * axis, -1)) * e2[..., 1])
    return proj_d > rad1 + rad2

  sep = separated(f1) | separated(r1) | separated(f2) | separated(r2)
  return ~sep


def point_in_obb(p, c, yaw, e) -> torch.Tensor:
  """Point-in-oriented-box test. p [..,2], box (c,yaw,e) broadcastable."""
  local = world_to_ego(p, c, yaw)
  return (torch.abs(local[..., 0]) <= e[..., 0]) & (
      torch.abs(local[..., 1]) <= e[..., 1])


def box_corners(c, yaw, e) -> torch.Tensor:
  """Corner points [..,4,2] of OBBs."""
  ex, ey = e[..., 0], e[..., 1]
  local = torch.stack([torch.stack([ex, ey], -1), torch.stack([ex, -ey], -1),
                       torch.stack([-ex, -ey], -1),
                       torch.stack([-ex, ey], -1)], -2)
  return ego_to_world(local, c[..., None, :], yaw[..., None])
