"""Adversarial scenario engine: srunner's scenario types as masked state
machines (port of carla_garage_tpu/sim/scenarios.py).

Each scenario is a row of fixed-shape spec tensors [B,K]; triggering and
the scripted actors' behaviour are masked per-tick updates:

  CONTROL_LOSS: a steering disturbance on the ego for a short window.
  FOLLOW_LEADING / OTHER_LEADING: an NPC ahead on the ego's route brakes
    abruptly / drives slowly.
  CROSSING_WALKER: a walker crosses the road (``traffic.walker_step`` with
    ``WalkerSpec``; listed for the inventory).
  OPPOSITE_DIRECTION: an NPC drives toward the ego in the opposite lane.
  JUNCTION_CROSSING: an NPC crosses the junction when the ego nears it.

The CONTROL_LOSS noise is the one random draw: [B,K] standard normals
that the caller passes in (``sim_step`` takes them from
``draws["control_loss"]``, else from its generator).
"""

from __future__ import annotations

import torch

from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.device import resolve_device
from carla_garage_tpu_torch.sim.triggers import evaluate
from carla_garage_tpu_torch.structs import (ScenarioSpecs, ScenarioState,
                                            SimState)

__all__ = ["ScenarioType", "ScenarioSpecs", "ScenarioState",
           "scenarios_reset", "make_empty_specs", "scenario_step"]


class ScenarioType:
  NONE = 0
  CONTROL_LOSS = 1
  FOLLOW_LEADING = 2
  CROSSING_WALKER = 3
  OTHER_LEADING = 5
  OPPOSITE_DIRECTION = 6
  JUNCTION_CROSSING = 7


def scenarios_reset(B: int, K: int, device="cuda") -> ScenarioState:
  dev = resolve_device(device)
  z = lambda dtype: torch.zeros((B, K), dtype=dtype, device=dev)
  return ScenarioState(triggered=z(torch.bool), ticks_active=z(torch.int32),
                       wait_ticks=z(torch.int32))


def make_empty_specs(B: int, K: int, device="cuda") -> ScenarioSpecs:
  dev = resolve_device(device)
  full = lambda shape, v, dtype=torch.float32: torch.full(
      shape, v, dtype=dtype, device=dev)
  return ScenarioSpecs(
      kind=full((B, K), 0, torch.int32),
      trigger_pos=full((B, K, 2), 0.0),
      trigger_dist=full((B, K), 15.0),
      trigger_kind=full((B, K), 0, torch.int32),
      trigger_param=full((B, K), 0.0),
      trigger_extent=full((B, K, 2), 5.0),
      actor_slot=full((B, K), -1, torch.int32),
      duration=full((B, K), 60, torch.int32),
      magnitude=full((B, K), 0.0),
      valid=full((B, K), False, torch.bool))


def scenario_step(cfg: GlobalConfig, specs: ScenarioSpecs,
                  sstate: ScenarioState, state: SimState,
                  control_loss: torch.Tensor):
  """Advance the triggers; return (new ScenarioState, effects dict).

  effects:
    steer_noise [B]          additive ego steering disturbance
    npc_brake_override [B,V] force an NPC to brake (FOLLOW_LEADING)
    npc_speed_cap [B,V]      cap an NPC's target speed (OTHER_LEADING and
                             the parked scripted actors; +inf = no cap)

  control_loss: [B,K] standard normals for the CONTROL_LOSS noise."""
  ego = state.ego
  B, K = specs.kind.shape
  V = state.vehicles.yaw.shape[1]
  dev = ego.pos.device

  armed = specs.valid & evaluate(
      specs.trigger_kind, ego.pos[:, None], ego.speed[:, None],
      specs.trigger_pos, specs.trigger_dist, specs.trigger_param,
      specs.trigger_extent)
  triggered = sstate.triggered | armed

  # force-trigger failsafe: a scripted actor waits parked until its trigger
  # arms, but the ego can end up stopped right behind it without ever
  # satisfying the predicate (a route passing the guarded junction on
  # another leg, or a TTA trigger whose TTA goes to infinity once the ego
  # brakes for the parked actor itself). After 3 s stopped within 12 m
  # behind an untriggered waiting actor, fire the scenario.
  waiting_kind = specs.valid & ~triggered & (
      (specs.kind == ScenarioType.JUNCTION_CROSSING) |
      (specs.kind == ScenarioType.OPPOSITE_DIRECTION) |
      (specs.kind == ScenarioType.FOLLOW_LEADING) |
      (specs.kind == ScenarioType.OTHER_LEADING))
  has_actor = specs.actor_slot >= 0
  # one-hot of each row's actor slot; a row without an actor (slot -1)
  # clips onto slot 0 and is masked out by has_actor, so it never aliases
  # vehicle 0
  slot = specs.actor_slot.clamp(0, V - 1).long()
  slot_oh = (slot[..., None] == torch.arange(V, device=dev)) & \
      has_actor[..., None]                                          # [B,K,V]
  actor_pos = torch.gather(state.vehicles.pos, 1,
                           slot[..., None].expand(B, K, 2))
  actor_pos = torch.where(has_actor[..., None], actor_pos, 0.0)
  rel = actor_pos - ego.pos[:, None]                                # [B,K,2]
  gap = torch.linalg.vector_norm(rel, dim=-1)
  fwd = torch.stack([torch.cos(ego.yaw), torch.sin(ego.yaw)], -1)  # [B,2]
  ahead = (rel[..., 0] * fwd[:, None, 0] + rel[..., 1] * fwd[:, None, 1]) \
      > 0.0
  blocking = (waiting_kind & has_actor & ahead & (gap < 12.0) &
              (ego.speed[:, None] < 0.3))
  wait_ticks = torch.where(blocking, sstate.wait_ticks + 1, 0).to(torch.int32)
  triggered = triggered | (blocking & (wait_ticks >= 3 * cfg.sim.fps))

  active = triggered & (sstate.ticks_active < specs.duration)
  ticks = torch.where(active, sstate.ticks_active + 1,
                      sstate.ticks_active).to(torch.int32)

  # CONTROL_LOSS: steering disturbance while active
  is_cl = active & (specs.kind == ScenarioType.CONTROL_LOSS)
  noise = control_loss * specs.magnitude
  steer_noise = torch.sum(torch.where(is_cl, noise, 0.0), -1)

  is_brake = active & (specs.kind == ScenarioType.FOLLOW_LEADING)
  npc_brake = torch.any(slot_oh & is_brake[..., None], 1)           # [B,V]

  is_slow = active & (specs.kind == ScenarioType.OTHER_LEADING)
  slow_cap = torch.where(is_slow[..., None] & slot_oh,
                         specs.magnitude[..., None], torch.inf)
  npc_speed_cap = torch.amin(slow_cap, 1)                            # [B,V]

  # scripted actors sit parked (speed cap 0) until triggered, then drive;
  # rows forced by the failsafe drive too
  is_wait = waiting_kind & ~triggered
  wait_cap = torch.where(is_wait[..., None] & slot_oh, 0.0, torch.inf)
  npc_speed_cap = torch.minimum(npc_speed_cap, torch.amin(wait_cap, 1))

  return (ScenarioState(triggered=triggered, ticks_active=ticks,
                        wait_ticks=wait_ticks),
          {"steer_noise": steer_noise,
           "npc_brake_override": npc_brake,
           "npc_speed_cap": npc_speed_cap})
