"""Windowed route-pointer planner (port of
carla_garage_tpu/sim/route_planner.py), batched over episodes where the
JAX package vmaps the unbatched core.

Pop rule: consider candidates i = ptr+1 .. while the cumulative
inter-point distance *before* i stays <= max_distance; among candidates
whose distance to the ego is <= min_distance pick the FARTHEST (first on
ties); advance ptr by that many, never leaving fewer than 2 un-popped
points.
"""

from __future__ import annotations

import dataclasses

import torch

from carla_garage_tpu_torch.structs import PlannerState


@dataclasses.dataclass(frozen=True)
class PlannerParams:
  min_distance: float
  max_distance: float
  window: int = 64


def planner_step(state: PlannerState, points: torch.Tensor,
                 seg_len: torch.Tensor, num_valid: torch.Tensor,
                 pos: torch.Tensor, p: PlannerParams) -> PlannerState:
  """Advance the route pointers of a batch.

  state.idx [B], points [B,R,2], seg_len [B,R] (seg_len[:,i] =
  |points[:,i]-points[:,i-1]|), num_valid [B] int32, pos [B,2]."""
  idx = state.idx.long()
  nv = num_valid.long()
  remaining = nv - idx
  w = torch.arange(1, p.window + 1, device=points.device)      # [Wd]
  q = idx[:, None] + w[None]                                  # [B,Wd]
  in_route = q < nv[:, None]
  qc = q.clamp(0, points.shape[1] - 1)
  seg = torch.where(in_route, torch.gather(seg_len, 1, qc), 0.0)
  cum_before = torch.cumsum(seg, -1) - seg
  considered = in_route & (cum_before <= p.max_distance)
  pts = torch.gather(points, 1, qc[..., None].expand(*qc.shape, 2))
  d = torch.linalg.vector_norm(pts - pos[:, None], dim=-1)
  eligible = considered & (d <= p.min_distance)
  score = torch.where(eligible, d, -torch.inf)
  best = torch.argmax(score, -1)                       # first max on ties
  to_pop = torch.where(eligible.any(-1), w[best], 0)
  max_pop = torch.clamp(remaining - 2, min=0)
  new_idx = idx + torch.minimum(to_pop, max_pop)
  is_last = (nv - new_idx) <= 2
  return PlannerState(idx=new_idx.to(torch.int32), is_last=is_last)


def route_lookup(points: torch.Tensor, cmd: torch.Tensor,
                 num_valid: torch.Tensor, idx: torch.Tensor, offset: int):
  """route[offset] relative to the pointer, clamped to the last valid
  point. points [B,R,2], cmd [B,R], num_valid [B], idx [B]."""
  j = torch.minimum(idx.long() + offset,
                    torch.clamp(num_valid.long() - 1, min=0))
  j = j.clamp(0, points.shape[1] - 1)
  return (torch.gather(points, 1, j[:, None, None].expand(-1, 1, 2))[:, 0],
          torch.gather(cmd, 1, j[:, None])[:, 0])
