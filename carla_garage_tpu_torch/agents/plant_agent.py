"""PlanT closed-loop agent: the learned object-level policy in the env step
(port of carla_garage_tpu/agents/plant_agent.py).

Per tick: route planners on the true pose -> the nearest objects
(vehicles, walkers, red or yellow lights, stop signs) and the route
points in the ego frame -> the privileged hazard flags PlanT takes as
inputs -> the PlanT forward -> PID control, plus the stuck/creep recovery
with a privileged box test ahead of the ego. The policy is object-level:
it renders no sensor, launches no hand kernel and draws no random number
(``DRAW_KEYS`` is empty), so the scenario engine's draws stay in step
between runs on the card and on the CPU. It makes no host sync. The spans
of a tick (``utils/profiling.py``): ``agent.localize`` (the planners),
``agent.inputs`` (objects, route and flags), ``agent.model`` and
``agent.control``. On the card each replays a CUDA graph
(``utils/cuda_graph``): the first two one ``GraphedStages`` call, the
forward its ``GraphedForward``, the control a second ``GraphedStages``
call, so a tick's thousand small launches become a few grouped copies and
four replays.
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import torch

from carla_garage_tpu_torch.agents.controllers import (control_pid,
                                                       control_pid_direct)
from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.device import const, resolve_device
from carla_garage_tpu_torch.maps.town_map import Layer
from carla_garage_tpu_torch.models.plant import ObjType, PlanT, PlanTConfig
from carla_garage_tpu_torch.sim import geometry as geo
from carla_garage_tpu_torch.sim.expert import (Control, _dense_planner_params,
                                               _sparse_planner_params,
                                               _sparse_seg_len)
from carla_garage_tpu_torch.sim.route_planner import planner_step
from carla_garage_tpu_torch.structs import (LightState, PIDState,
                                            PlannerState, Scene, SimState,
                                            Struct)
from carla_garage_tpu_torch.utils.cuda_graph import (GraphedForward,
                                                     GraphedStages)
from carla_garage_tpu_torch.utils.profiling import span

TARGET_SPEEDS = (0.0, 2.0, 5.0, 8.0)   # m/s of the target-speed classes
OBJECT_RANGE_M = 32.0                  # PlanT's observation radius
DRAW_KEYS = ()                         # the policy draws nothing


@dataclasses.dataclass
class PlanTAgentState(Struct):
  planner_dense: PlannerState
  planner_sparse: PlannerState
  pid_turn: PIDState
  pid_speed: PIDState
  cleared_stop_signs: torch.Tensor   # [B,S] bool
  stuck_count: torch.Tensor          # [B] int32 ticks at ~zero speed
  force_move: torch.Tensor           # [B] int32 remaining creep frames


def plant_agent_reset(cfg: GlobalConfig, B: int,
                      device="cuda") -> PlanTAgentState:
  dev = resolve_device(device)

  def planner():
    return PlannerState(idx=torch.zeros((B,), dtype=torch.int32, device=dev),
                        is_last=torch.zeros((B,), dtype=torch.bool,
                                            device=dev))

  zi = torch.zeros((B,), dtype=torch.int32, device=dev)
  return PlanTAgentState(
      planner_dense=planner(), planner_sparse=planner(),
      pid_turn=PIDState.create((B,), cfg.expert.turn_n, device=dev),
      pid_speed=PIDState.create((B,), cfg.expert.speed_n, device=dev),
      cleared_stop_signs=torch.zeros((B, cfg.sim.max_stop_signs),
                                     dtype=torch.bool, device=dev),
      stuck_count=zi, force_move=zi.clone())


def privileged_flags(cfg: GlobalConfig, maps, scene: Scene, state: SimState,
                     cleared_stops: torch.Tensor, dense_idx: torch.Tensor):
  """The light, stop and junction flags PlanT takes as inputs, computed
  as the expert computes them (autopilot.py:944-1070).

  Returns (light [B], stop [B], junction [B] as float32, new cleared
  stop signs [B,S])."""
  e, s = cfg.expert, cfg.sim
  ego = state.ego
  ego_e = const([s.ego_extent_x, s.ego_extent_y], ego.pos.device)
  # a forward probe box of about the braking distance: a light affects
  # the ego if its near future path crosses the light's stop line
  fwd = torch.stack([torch.cos(ego.yaw), torch.sin(ego.yaw)], -1)
  reach = 2.0 + 0.6 * ego.speed
  probe_c = ego.pos + fwd * reach[:, None]
  probe_e = torch.stack([reach + s.ego_extent_x,
                         torch.full_like(reach, s.ego_extent_y)], -1)

  lights = scene.lights
  lstate = lights.state_at(state.time_s)
  ldist = torch.linalg.vector_norm(lights.pos - ego.pos[:, None], dim=-1)
  facing = torch.abs(geo.normalize_angle(
      lights.yaw - ego.yaw[:, None])) < 0.8
  lnear = lights.valid & facing & (ldist < e.light_radius)
  hit = geo.obb_intersect(probe_c[:, None], ego.yaw[:, None],
                          probe_e[:, None], lights.pos, lights.yaw,
                          lights.extent)
  hit = hit | geo.obb_intersect(ego.pos[:, None], ego.yaw[:, None],
                                ego_e[None, None], lights.pos, lights.yaw,
                                lights.extent)
  is_red = (lstate == LightState.RED) | (lstate == LightState.YELLOW)
  # only the nearest affecting light governs (a diagonal approach can
  # face both phase groups)
  affects = lnear & hit
  best = torch.argmin(torch.where(affects, ldist, torch.inf), -1)
  light = torch.any(affects, -1) & \
      torch.gather(is_red, 1, best[:, None])[:, 0]

  stops = scene.stops
  sfacing = torch.abs(geo.normalize_angle(
      stops.yaw - ego.yaw[:, None])) < 0.8
  snear = stops.valid & sfacing & (torch.linalg.vector_norm(
      stops.pos - ego.pos[:, None], dim=-1) < e.light_radius)
  st_hit = geo.obb_intersect(ego.pos[:, None], ego.yaw[:, None],
                             ego_e[None, None], stops.pos, stops.yaw,
                             stops.extent) & snear
  st_probe = geo.obb_intersect(probe_c[:, None], ego.yaw[:, None],
                               probe_e[:, None], stops.pos, stops.yaw,
                               stops.extent) & snear
  uncleared = ~cleared_stops
  moving = ego.speed > 1e-2
  stop = torch.any((st_hit | st_probe) & uncleared, -1) & moving
  newly_cleared = st_hit & uncleared & ~moving[:, None]
  new_cleared = (cleared_stops | newly_cleared) & snear

  junction = maps.sample(scene.town_id[:, None], Layer.JUNCTION,
                         ego.pos[:, None])[:, 0]
  R = scene.route.points.shape[1]
  route_junc = torch.gather(scene.route.is_junction, 1,
                            dense_idx.long().clamp(0, R - 1)[:, None])[:, 0]
  f32 = lambda x: x.to(torch.float32)
  return f32(light), f32(stop), f32(junction | route_junc), new_cleared


def extract_objects(cfg: GlobalConfig, pcfg: PlanTConfig, scene: Scene,
                    state: SimState):
  """Nearest-first object boxes in the ego frame (plant_agent.py:120-154):
  vehicles, walkers, red or yellow lights, stop signs within 32 m; empty
  slots are zero rows of type VEHICLE. Equal distances keep slot order
  (a stable sort, as ``jnp.argsort``). Returns (boxes [B,O,7], types
  [B,O] int32)."""
  ego = state.ego
  veh, wlk = state.vehicles, state.walkers
  B = ego.yaw.shape[0]
  dev = ego.yaw.device

  def rel_attrs(pos, yaw, extent, speed, brake):
    rel = geo.world_to_ego(pos, ego.pos[:, None], ego.yaw[:, None])
    ryaw = geo.normalize_angle(yaw - ego.yaw[:, None])
    return torch.stack([rel[..., 0], rel[..., 1], extent[..., 0],
                        extent[..., 1], ryaw, speed, brake], -1)

  lights, stops = scene.lights, scene.stops
  lstate = lights.state_at(state.time_s)
  l_red = ((lstate == LightState.RED) | (lstate == LightState.YELLOW)) & \
      lights.valid
  zl, zs = torch.zeros_like(lights.yaw), torch.zeros_like(stops.yaw)
  attrs = torch.cat([
      rel_attrs(veh.pos, veh.yaw, veh.extent, veh.speed,
                veh.control[..., 2]),
      rel_attrs(wlk.pos, wlk.yaw, wlk.extent, wlk.speed,
                torch.zeros_like(wlk.speed)),
      rel_attrs(lights.pos, lights.yaw, lights.extent, zl, zl),
      rel_attrs(stops.pos, stops.yaw, stops.extent, zs, zs)], 1)
  full = lambda n, t: torch.full((B, n), t, dtype=torch.int32, device=dev)
  types = torch.cat([full(veh.yaw.shape[1], ObjType.VEHICLE),
                     full(wlk.yaw.shape[1], ObjType.WALKER),
                     full(lights.yaw.shape[1], ObjType.LIGHT),
                     full(stops.yaw.shape[1], ObjType.STOP)], 1)
  valid = torch.cat([veh.valid, wlk.valid, l_red, stops.valid], 1)
  d = torch.linalg.vector_norm(attrs[..., :2], dim=-1)
  valid = valid & (d < OBJECT_RANGE_M)
  order = torch.argsort(torch.where(valid, d, torch.inf), dim=-1,
                        stable=True)[:, :pcfg.max_objects]
  sel_attr = torch.gather(attrs, 1, order[..., None].expand(-1, -1, 7))
  sel_valid = torch.gather(valid, 1, order)
  sel_types = torch.gather(types, 1, order)
  boxes = torch.where(sel_valid[..., None], sel_attr, 0.0)
  box_types = torch.where(sel_valid, sel_types, ObjType.VEHICLE)
  return boxes, box_types.to(torch.int32)


def extract_route(pcfg: PlanTConfig, scene: Scene, state: SimState,
                  dense_idx: torch.Tensor):
  """Route tokens: num_route_points dense points at 2 m spacing, ego
  frame [B,R',2]."""
  ego = state.ego
  R = scene.route.points.shape[1]
  offs = torch.arange(pcfg.num_route_points, device=dense_idx.device) * 2
  q = (dense_idx.long()[:, None] + offs[None]).clamp(0, R - 1)
  pts = torch.gather(scene.route.points, 1, q[..., None].expand(-1, -1, 2))
  return geo.world_to_ego(pts, ego.pos[:, None], ego.yaw[:, None])


def _localize(fixed: tuple, c: dict) -> dict:
  """The route planners on the true pose."""
  cfg, _, _, scene, _ = fixed
  ag, ego, route = c["state"].agent, c["state"].ego, scene.route
  pl_dense = planner_step(ag.planner_dense, route.points, route.seg_len,
                          route.num_valid, ego.pos,
                          _dense_planner_params(cfg))
  pl_sparse = planner_step(
      ag.planner_sparse, route.sparse_points,
      _sparse_seg_len(route.sparse_points, route.sparse_num_valid),
      route.sparse_num_valid, ego.pos, _sparse_planner_params(cfg))
  return dict(c, pl_dense=pl_dense, pl_sparse=pl_sparse)


def _inputs(fixed: tuple, c: dict) -> dict:
  """The forward's inputs but the speed (objects, route, flags) and the
  planners' state; the tick's state stays behind."""
  cfg, pcfg, maps, scene, _ = fixed
  state, pl_dense = c["state"], c["pl_dense"]
  boxes, box_types = extract_objects(cfg, pcfg, scene, state)
  route_tok = extract_route(pcfg, scene, state, pl_dense.idx)
  light, stop, junction, cleared = privileged_flags(
      cfg, maps, scene, state, state.agent.cleared_stop_signs, pl_dense.idx)
  return dict(pl_dense=pl_dense, pl_sparse=c["pl_sparse"], cleared=cleared,
              model_in=(boxes, box_types, route_tok, light, stop, junction))


def _control(direct: bool, brake_threshold: float, creep: bool,
             fixed: tuple, c: dict) -> dict:
  """The forward's outputs -> the control and the agent's next state."""
  cfg, _, _, _, target_speeds = fixed
  state, out = c["state"], c["out"]
  ag, ego = state.agent, state.ego
  if direct:
    probs = torch.softmax(out["pred_target_speed"], -1)
    ts = torch.sum(probs * target_speeds, -1)
    ts = torch.where(probs[:, 0] > brake_threshold, 0.0, ts)
    aim = out["pred_checkpoint"][:, 2]
    angle = torch.rad2deg(torch.atan2(aim[:, 1], aim[:, 0])) / 90.0
    steer, throttle, brake, pt2, ps2 = control_pid_direct(
        ag.pid_turn, ag.pid_speed, ts, angle, ego.speed, cfg)
  else:
    steer, throttle, brake, pt2, ps2 = control_pid(
        ag.pid_turn, ag.pid_speed, out["pred_wp"], ego.speed, cfg)

  stuck, force = ag.stuck_count, ag.force_move
  if creep:
    e, s = cfg.expert, cfg.sim
    stuck = torch.where(ego.speed < 0.1, ag.stuck_count + 1, 0)
    start_creep = stuck > e.stuck_threshold
    force = torch.where(start_creep, e.creep_duration,
                        torch.clamp(ag.force_move - 1, min=0))
    fwd = torch.stack([torch.cos(ego.yaw), torch.sin(ego.yaw)], -1)
    box_c = ego.pos + fwd * (s.ego_extent_x + 1.25)
    box_e = torch.stack([torch.full_like(ego.yaw, 1.25),
                         torch.full_like(ego.yaw, s.ego_extent_y * 0.8)], -1)
    veh, wlk = state.vehicles, state.walkers
    hit_v = geo.obb_intersect(box_c[:, None], ego.yaw[:, None],
                              box_e[:, None], veh.pos, veh.yaw,
                              veh.extent) & veh.valid
    hit_w = geo.obb_intersect(box_c[:, None], ego.yaw[:, None],
                              box_e[:, None], wlk.pos, wlk.yaw,
                              wlk.extent) & wlk.valid
    obstructed = torch.any(hit_v, -1) | torch.any(hit_w, -1)
    creeping = (force > 0) & ~obstructed
    # an obstructed creep re-arms for when the box clears
    force = torch.where((force > 0) & obstructed, e.creep_duration, force)
    throttle = torch.where(creeping, e.creep_throttle, throttle)
    brake = torch.where(creeping, 0.0,
                        torch.where((force > 0) & obstructed, 1.0, brake))
    stuck = torch.where(creeping, 0, stuck)

  new_ag = PlanTAgentState(
      planner_dense=c["pl_dense"], planner_sparse=c["pl_sparse"],
      pid_turn=pt2, pid_speed=ps2, cleared_stop_signs=c["cleared"],
      stuck_count=stuck.to(torch.int32), force_move=force.to(torch.int32))
  return dict(control=Control(steer=steer, throttle=throttle, brake=brake),
              agent=new_ag)


_BEFORE = (("agent.localize", _localize), ("agent.inputs", _inputs))


def make_plant_policy(model: PlanT, params, pcfg: PlanTConfig,
                      direct: bool = False, brake_threshold: float = 0.5,
                      creep: bool = True):
  """A policy for ``sim_step`` that runs PlanT inside the env step.

  model: a PlanT on the device the policy runs on; params: None to drive
  with its own weights, or a state dict to drive with (loaded into a copy
  of the model once, here).

  direct=True drives from the classified target speed (the speed classes'
  expectation, 0 when the brake class's probability exceeds
  brake_threshold; 0.33 is the Longest6 point) and the angle of the third
  checkpoint, else from the waypoints through the waypoint controller.

  creep=True adds the stuck -> creep recovery of the sensor agent: after
  stuck_threshold ticks at ~zero speed, throttle for creep_duration frames
  unless the box just ahead of the ego holds a vehicle or a walker (a
  privileged OBB test in place of the LiDAR returns); an obstructed creep
  brakes fully and re-arms.

  On the card the tick is three replays: ``agent.localize`` and
  ``agent.inputs`` as one ``GraphedStages`` call, the forward's
  ``GraphedForward``, then ``agent.control`` as a second call; the
  policy's own graphs, which no other policy shares. Elsewhere the same
  stages run eagerly."""
  if params is not None:
    model = copy.deepcopy(model)
    model.load_state_dict(params)
  model = model.eval()
  dev = next(model.parameters()).device
  forward = GraphedForward(model)     # a CUDA graph's replay on the card
  before, after = GraphedStages(), GraphedStages()
  control = (("agent.control",
              functools.partial(_control, direct, brake_threshold, creep)),)
  target_speeds = const(TARGET_SPEEDS, dev)

  @torch.no_grad()
  def policy(cfg: GlobalConfig, maps, scene: Scene, state: SimState,
             generator: torch.Generator | None = None,
             draws: dict | None = None):
    if draws:
      raise KeyError(f"unknown draws {sorted(draws)}; the PlanT policy "
                     "draws nothing")
    fixed = (cfg, pcfg, maps, scene, target_speeds)
    # the agent reads neither the expert's, the criteria's nor the
    # scenarios' state: the graphs copy none of it in
    seen = state.replace(expert=(), criteria=(), scenario=())
    got = before(_BEFORE, fixed, dict(state=seen))
    with span("agent.model"):
      out = forward(*got.pop("model_in"), state.ego.speed)
    got = after(control, fixed, dict(got, state=seen, out=out))
    return got["control"], {"agent": got["agent"]}

  policy.draw_specs = ()                # the policy draws nothing
  return policy
