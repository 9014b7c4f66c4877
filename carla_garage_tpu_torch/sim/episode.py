"""Episode loop (port of carla_garage_tpu/sim/episode.py).

One tick advances the whole batch: policy control -> scenario triggers and
effects -> ego dynamics -> NPC traffic -> walkers -> criteria. Episodes
that finish freeze in place by masking, not branching, and a tick makes no
host sync. ``rollout`` is a Python loop over ticks where the JAX package
scans; ``rollout_chunked`` checks once per chunk of ticks whether every
episode is done, and ``rollout_recorded`` also keeps a decimated
trajectory log. A tick is the span ``sim.tick`` (``utils/profiling.py``)
around the spans of its layers: ``sim.policy``, ``sim.scenarios``,
``sim.dynamics``, ``sim.traffic`` (vehicles and walkers) and
``sim.criteria``; a chunk's done check is ``rollout.done_check``.

On the card, the work after the policy replays as CUDA graphs
(``utils/cuda_graph.GraphedStages``): one a layer, each inside its span,
captured once per signature of the state, the policy's control and
updates and the scenario draws, and holding the launches that the layer
made eagerly. The policy stays an eager call (its model's forward is a
graph of its own), and so do the tick's copies in and out of the graphs,
the scenario engine's draw where the caller gives none, and the freeze of
the policy's own carry (``SimState.agent``), which no layer after the
policy reads and which the graphs therefore neither copy nor hold. On
the CPU, and wherever the inputs cannot be keyed, the layers run eagerly,
the same operations in the same order.

The policy is the privileged expert (``sim/expert.expert_step``) unless
the caller passes another, such as the sensor agent's. Randomness: the
policy and the scenario engine draw their noise from the
``torch.Generator`` passed to ``sim_step`` / ``rollout``, or take it as
explicit tensors in ``draws``: ``draws["control_loss"]`` [B,K] is the
scenario engine's (``sim/scenarios.py``), every other key the policy's
(see ``sim/expert.py`` and ``agents/sensor_agent.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.maps.town_map import LaneGraph, MapStack
from carla_garage_tpu_torch.sim.criteria import criteria_step, episode_done
from carla_garage_tpu_torch.sim.dynamics import bicycle_step
from carla_garage_tpu_torch.sim.expert import expert_step
from carla_garage_tpu_torch.sim.geometry import normalize_angle
from carla_garage_tpu_torch.sim.scenarios import scenario_step
from carla_garage_tpu_torch.sim.traffic import traffic_step, walker_step
from carla_garage_tpu_torch.structs import (ScenarioSpecs, ScenarioState,
                                            Scene, SimState, tree_map)
from carla_garage_tpu_torch.utils.cuda_graph import GraphedStages
from carla_garage_tpu_torch.utils.profiling import span
from carla_garage_tpu_torch.utils.watchdog import Watchdog

# Control policy signature:
#   (cfg, maps, scene, state, generator=None, draws=None)
#     -> (Control, dict of SimState field updates)
PolicyFn = Callable

N_NEAREST_VEHICLES = 8   # rollout_recorded's snapshot: nearest actors kept
N_NEAREST_WALKERS = 2


def freeze_done(done: torch.Tensor, old, new):
  """Keep `old` wherever the episode is done. done [B]; leaves [B,...]."""
  def sel(o, n):
    d = done.reshape(done.shape + (1,) * (n.ndim - 1))
    return torch.where(d, o, n)
  return tree_map(sel, old, new)


def _scenarios(fixed: tuple, c: dict) -> dict:
  """Scenario triggers and effects; the steer noise is added after the
  policy and before the dynamics."""
  cfg, _, _, scene = fixed
  state, control = c["state"], c["control"]
  new_scn, effects = scenario_step(cfg, scene.scenarios, state.scenario,
                                   state, control_loss=c["control_loss"])
  return dict(c, control=control.replace(steer=control.steer +
                                         effects["steer_noise"]),
              updates=dict(c["updates"], scenario=new_scn), effects=effects)


def _dynamics(fixed: tuple, c: dict) -> dict:
  cfg = fixed[0]
  state, control = c["state"], c["control"]
  pos, yaw, speed = bicycle_step(state.ego.pos, state.ego.yaw,
                                 state.ego.speed, control.steer,
                                 control.throttle, control.brake, cfg.sim)
  return dict(c, ego=state.ego.replace(pos=pos, yaw=normalize_angle(yaw),
                                       speed=speed))


def _traffic(fixed: tuple, c: dict) -> dict:
  cfg, _, lanes, scene = fixed
  state = c["state"]
  return dict(c, vehicles=traffic_step(cfg, lanes, scene, state,
                                       c.get("effects")),
              walkers=walker_step(cfg, scene, state))


def _criteria(fixed: tuple, c: dict) -> SimState:
  cfg, maps, _, scene = fixed
  state = c["state"]
  moved = state.replace(ego=c["ego"], vehicles=c["vehicles"],
                        walkers=c["walkers"], tick=state.tick + 1,
                        **c["updates"])
  moved = moved.replace(criteria=criteria_step(cfg, maps, scene,
                                               state.ego.pos, moved))
  done = state.done | episode_done(cfg, moved)
  # a finished episode keeps its whole state, scenario state included
  return freeze_done(state.done, state, moved).replace(done=done)


# the layers after the policy, in order; all agents advance simultaneously
# (world.tick semantics)
_LAYERS = (("sim.dynamics", _dynamics), ("sim.traffic", _traffic),
           ("sim.criteria", _criteria))
_SCENARIO_LAYERS = (("sim.scenarios", _scenarios),) + _LAYERS
# one cache for the process, as sim_step's callers (the rollouts, datagen,
# the benchmark) hold no state of their own between ticks; a new scene
# storage drops what it holds
_GRAPHS = GraphedStages()


@torch.no_grad()
def sim_step(cfg: GlobalConfig, maps: MapStack, lanes: LaneGraph,
             scene: Scene, state: SimState, policy: PolicyFn = expert_step,
             generator: torch.Generator | None = None,
             draws: dict | None = None) -> SimState:
  """Advance the whole batch one tick.

  draws: this tick's random numbers as tensors: "control_loss" [B,K] for
  the scenario engine, the rest under the policy's names; what is not
  given is drawn from `generator`."""
  with span("sim.tick"):
    draws = dict(draws or {})
    control_loss = draws.pop("control_loss", None)
    with span("sim.policy"):
      control, updates = policy(cfg, maps, scene, state,
                                generator=generator, draws=draws)
    # the policy's own carry (the sensor agent's LiDAR history: about
    # 100 MB at B=16 and 16 sweeps) goes through no layer but the freeze,
    # so it stays out of the graphs' buffers and is frozen here, a launch
    # a leaf
    updates = dict(updates)
    agent = freeze_done(state.done, state.agent,
                        updates.pop("agent", state.agent))
    carry = dict(state=state.replace(agent=()), control=control,
                 updates=updates)
    layers = _LAYERS
    if isinstance(scene.scenarios, ScenarioSpecs) and \
        isinstance(state.scenario, ScenarioState):
      layers = _SCENARIO_LAYERS
      if control_loss is None:       # the draw scenario_step would make
        control_loss = torch.randn(tuple(scene.scenarios.kind.shape),
                                   generator=generator,
                                   device=state.ego.pos.device)
      carry["control_loss"] = control_loss
    return _GRAPHS(layers, (cfg, maps, lanes, scene),
                   carry).replace(agent=agent)


def rollout(cfg: GlobalConfig, maps: MapStack, lanes: LaneGraph,
            scene: Scene, state: SimState, n_ticks: int,
            policy: PolicyFn = expert_step,
            generator: torch.Generator | None = None,
            draws: list | None = None, draw_fn=None) -> SimState:
  """Run n_ticks of simulation. draws: one dict of draws per tick, or None
  to take each tick's from draw_fn() when given (a data-parallel rank's
  slice of the global draws, ``eval/benchmark._sharded_draw_fn``), else to
  draw every tick's noise from `generator`."""
  for i in range(n_ticks):
    tick = draws[i] if draws is not None else \
        (draw_fn() if draw_fn is not None else None)
    state = sim_step(cfg, maps, lanes, scene, state, policy,
                     generator=generator, draws=tick)
  return state


def _snapshot(st: SimState) -> dict:
  """One decimated log entry: the ego (x, y, yaw, speed), the nearest
  vehicles and walkers (position, yaw, valid), tick and alive. Invalid
  slots sort last at +inf distance, ties in slot order (a stable sort, as
  XLA's)."""
  def nearest(pos, valid, n):
    d = torch.linalg.vector_norm(pos - st.ego.pos[:, None], dim=-1)
    d = torch.where(valid, d, torch.inf)
    idx = torch.argsort(d, dim=-1, stable=True)[:, :n]
    return idx, torch.isfinite(torch.gather(d, 1, idx))

  def take(a, idx):
    if a.ndim == 3:
      return torch.gather(a, 1, idx[..., None].expand(*idx.shape,
                                                      a.shape[-1]))
    return torch.gather(a, 1, idx)

  veh, wlk = st.vehicles, st.walkers
  iv, fin_v = nearest(veh.pos, veh.valid, N_NEAREST_VEHICLES)
  iw, fin_w = nearest(wlk.pos, wlk.valid, N_NEAREST_WALKERS)
  return dict(
      ego=torch.cat([st.ego.pos, st.ego.yaw[:, None],
                     st.ego.speed[:, None]], -1),
      veh_pos=take(veh.pos, iv), veh_yaw=take(veh.yaw, iv),
      veh_valid=take(veh.valid, iv) & fin_v,
      wlk_pos=take(wlk.pos, iw),
      wlk_valid=take(wlk.valid, iw) & fin_w,
      tick=st.tick, alive=~st.done)


def rollout_recorded(cfg: GlobalConfig, maps: MapStack, lanes: LaneGraph,
                     scene: Scene, state: SimState, n_ticks: int,
                     every: int = 10, policy: PolicyFn = expert_step,
                     generator: torch.Generator | None = None,
                     draws: list | None = None, draw_fn=None):
  """Rollout that also records a decimated trajectory log (the
  ScenarioLogger analog: every 10th frame, the nearby actors) for replay
  clips and infraction maps.

  Returns (final_state, traj dict of [T',B,...] tensors) with
  T' = n_ticks // every snapshots, each taken after `every` ticks: ego
  (x, y, yaw, speed), the 8 nearest vehicles and 2 nearest walkers
  (position, yaw, valid), tick and alive. draws: one dict per tick
  (T' * every of them), or None to take them from draw_fn or
  `generator` as ``rollout`` does."""
  snaps = []
  for f in range(n_ticks // every):
    state = rollout(cfg, maps, lanes, scene, state, every, policy,
                    generator=generator,
                    draws=draws[f * every:(f + 1) * every]
                    if draws is not None else None, draw_fn=draw_fn)
    snaps.append(_snapshot(state))
  if not snaps:
    return state, {}
  return state, {k: torch.stack([s[k] for s in snaps]) for k in snaps[0]}


def rollout_chunked(cfg: GlobalConfig, maps: MapStack, lanes: LaneGraph,
                    scene: Scene, state: SimState, max_ticks: int,
                    chunk: int = 256, policy: PolicyFn = expert_step,
                    watchdog_s: float | None = 1800.0,
                    generator: torch.Generator | None = None,
                    draw_fn=None) -> SimState:
  """Rollout in chunks of `chunk` ticks with an early exit once every
  episode is done. Whole chunks run, so the ticks may pass max_ticks.

  The only host sync is the done check after each chunk; the ticks inside
  a chunk make none. watchdog_s arms a hang watchdog, re-armed once per
  chunk, that raises KeyboardInterrupt on the main thread when a chunk
  takes longer (a wedged device or a pathological first compile).
  draw_fn: as ``rollout`` takes it."""
  wd = Watchdog(watchdog_s) if watchdog_s else None
  if wd:
    wd.start()
  try:
    ticks = 0
    while ticks < max_ticks:
      state = rollout(cfg, maps, lanes, scene, state, chunk, policy,
                      generator=generator, draw_fn=draw_fn)
      ticks += chunk
      with span("rollout.done_check"):
        all_done = bool(torch.all(state.done))   # the chunk's one host sync
      if wd:
        wd.update()                      # re-arm once per completed chunk
      if all_done:
        break
  finally:
    if wd:
      wd.stop()
  return state
