"""Episode loop (port of carla_garage_tpu/sim/episode.py).

One tick advances the whole batch: policy control -> ego dynamics -> NPC
traffic -> walkers -> criteria. Episodes that finish freeze in place by
masking, not branching, and a tick makes no host sync, so a later step can
capture a chunk of ticks as one CUDA graph. ``rollout`` is a Python loop
over ticks where the JAX package scans.

Randomness: a policy draws its noise from the ``torch.Generator`` passed
to ``sim_step`` / ``rollout``, or takes it as explicit tensors in
``draws`` (see ``agents/sensor_agent.py``). Scenarios are not ported yet:
a scene must carry none.
"""

from __future__ import annotations

from typing import Callable

import torch

from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.maps.town_map import LaneGraph, MapStack
from carla_garage_tpu_torch.sim.criteria import criteria_step, episode_done
from carla_garage_tpu_torch.sim.dynamics import bicycle_step
from carla_garage_tpu_torch.sim.geometry import normalize_angle
from carla_garage_tpu_torch.sim.traffic import traffic_step, walker_step
from carla_garage_tpu_torch.structs import Scene, SimState, tree_map

# Control policy signature:
#   (cfg, maps, scene, state, generator=None, draws=None)
#     -> (Control, dict of SimState field updates)
PolicyFn = Callable


def freeze_done(done: torch.Tensor, old, new):
  """Keep `old` wherever the episode is done. done [B]; leaves [B,...]."""
  def sel(o, n):
    d = done.reshape(done.shape + (1,) * (n.ndim - 1))
    return torch.where(d, o, n)
  return tree_map(sel, old, new)


@torch.no_grad()
def sim_step(cfg: GlobalConfig, maps: MapStack, lanes: LaneGraph,
             scene: Scene, state: SimState, policy: PolicyFn,
             generator: torch.Generator | None = None,
             draws: dict | None = None) -> SimState:
  """Advance the whole batch one tick.

  draws: the policy's random numbers for this tick as tensors (their
  names are the policy's); what it is not given it draws from
  `generator`."""
  if scene.scenarios != () or state.scenario != ():
    raise NotImplementedError("scenarios are not ported yet")
  control, updates = policy(cfg, maps, scene, state, generator=generator,
                            draws=draws)

  # all agents advance simultaneously (world.tick semantics)
  pos, yaw, speed = bicycle_step(state.ego.pos, state.ego.yaw,
                                 state.ego.speed, control.steer,
                                 control.throttle, control.brake, cfg.sim)
  new_ego = state.ego.replace(pos=pos, yaw=normalize_angle(yaw), speed=speed)
  new_veh = traffic_step(cfg, lanes, scene, state)
  new_wlk = walker_step(cfg, scene, state)

  moved = state.replace(ego=new_ego, vehicles=new_veh, walkers=new_wlk,
                        tick=state.tick + 1, **updates)
  moved = moved.replace(criteria=criteria_step(cfg, maps, scene,
                                               state.ego.pos, moved))
  done = state.done | episode_done(cfg, moved)
  return freeze_done(state.done, state, moved).replace(done=done)


def rollout(cfg: GlobalConfig, maps: MapStack, lanes: LaneGraph,
            scene: Scene, state: SimState, n_ticks: int, policy: PolicyFn,
            generator: torch.Generator | None = None) -> SimState:
  """Run n_ticks of simulation, drawing every tick's noise from
  `generator`."""
  for _ in range(n_ticks):
    state = sim_step(cfg, maps, lanes, scene, state, policy,
                     generator=generator)
  return state
