"""Per-tick infraction criteria (port of carla_garage_tpu/sim/criteria.py).

Every criterion is a masked per-tick tensor update over [B] episodes:
route completion and deviation, driving outside the route's lanes,
collisions with per-actor dedup, red lights, the stop-sign state machine,
blocked and timed-out episodes, and the infraction event log.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.cgt.config import GlobalConfig
from portbench.reference.cgt.device import const, resolve_device
from portbench.reference.cgt.maps.town_map import Layer, MapStack
from portbench.reference.cgt.sim import geometry as geo
from portbench.reference.cgt.structs import (CriteriaState, EventKind,
                                            LightState, Scene, SimState)

ROUTE_MATCH_DIST = 10.0   # waypoint pass distance (RouteCompletion WINDOWS)
ROUTE_WINDOW = 64
MAX_EVENTS = 16


def criteria_reset(B: int, V: int, W: int, L: int, S: int,
                   device="cuda") -> CriteriaState:
  dev = resolve_device(device)

  def z(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype, device=dev)

  f32, b = torch.float32, torch.bool
  return CriteriaState(
      event_pos=z(B, MAX_EVENTS, 2, dtype=f32),
      event_kind=z(B, MAX_EVENTS), event_tick=z(B, MAX_EVENTS),
      event_count=z(B),
      penalty=torch.ones((B,), dtype=f32, device=dev),
      n_collision_vehicle=z(B), n_collision_walker=z(B),
      n_collision_static=z(B), n_red_light=z(B), n_stop_sign=z(B),
      route_completion=z(B, dtype=f32), max_route_idx=z(B),
      outside_lane_m=z(B, dtype=f32), driven_m=z(B, dtype=f32),
      blocked_ticks=z(B),
      deviated=z(B, dtype=b), blocked=z(B, dtype=b),
      timed_out=z(B, dtype=b),
      veh_overlap=z(B, V), wlk_overlap=z(B, W), static_overlap=z(B),
      red_light_cooldown=z(B, L, dtype=b),
      stop_pending=z(B, S, dtype=b), stop_done=z(B, S, dtype=b),
      stop_entered=z(B, S, dtype=b))


def _take_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """points [B,R,2], idx [B,...] -> [B,...,2]."""
  flat = idx.reshape(idx.shape[0], -1).long()
  out = torch.gather(points, 1, flat[..., None].expand(*flat.shape, 2))
  return out.reshape(*idx.shape, 2)


def criteria_step(cfg: GlobalConfig, maps: MapStack, scene: Scene,
                  prev_pos: torch.Tensor, state: SimState) -> CriteriaState:
  """Update all criteria after the world advanced one tick."""
  c = cfg.criteria
  s = cfg.sim
  cr = state.criteria
  ego = state.ego
  dev = ego.pos.device
  ego_e = const([s.ego_extent_x, s.ego_extent_y], dev)
  route = scene.route

  step_m = torch.linalg.vector_norm(ego.pos - prev_pos, dim=-1)
  driven_m = cr.driven_m + step_m

  # --- route completion / deviation ---
  R = route.points.shape[1]
  w = torch.arange(ROUTE_WINDOW, device=dev)
  q = torch.clamp(cr.max_route_idx[:, None] + w[None], 0, R - 1)  # [B,Wd]
  wp = _take_point(route.points, q)                               # [B,Wd,2]
  d = torch.linalg.vector_norm(wp - ego.pos[:, None], dim=-1)
  in_route = q < route.num_valid[:, None]
  close = (d < ROUTE_MATCH_DIST) & in_route
  best = torch.amax(torch.where(close, w[None], -1), -1)         # [B]
  new_idx = torch.where(best >= 0, cr.max_route_idx + best,
                        cr.max_route_idx)
  seg = route.seg_len                                             # [B,R]
  ar = torch.arange(R, device=dev)[None]
  mask_r = ar < route.num_valid[:, None]
  total_len = torch.sum(torch.where(mask_r, seg, 0.0), -1)
  cum_mask = ar <= new_idx[:, None]
  passed_len = torch.sum(torch.where(mask_r & cum_mask, seg, 0.0), -1)
  completion = torch.clamp(passed_len / torch.clamp(total_len, min=1e-3),
                           0.0, 1.0)
  at_end = new_idx >= (route.num_valid - 2)
  # the leaderboard grants completion in the goal area
  r_last = torch.clamp(route.num_valid - 1, 0, R - 1)
  goal = _take_point(route.points, r_last)                         # [B,2]
  near_goal = torch.linalg.vector_norm(goal - ego.pos, dim=-1) < \
      ROUTE_MATCH_DIST
  completion = torch.where(at_end | near_goal, 1.0, completion)
  # nearest-route distance, looking behind the match pointer too
  qb = torch.clamp(cr.max_route_idx[:, None] - 16 + w[None], 0, R - 1)
  wpb = _take_point(route.points, qb)
  db = torch.linalg.vector_norm(wpb - ego.pos[:, None], dim=-1)
  in_route_b = qb < route.num_valid[:, None]
  db_in = torch.where(in_route_b, db, torch.inf)
  min_d = torch.amin(db_in, -1)
  deviated = cr.deviated | (min_d > c.route_deviation_m)

  # --- outside route lanes: off road, or against the nearest lane's
  # direction outside a junction, probed at {0, +-half-lane} ---
  tid = scene.town_id[:, None]
  on_road = maps.sample(tid, Layer.ROAD, ego.pos[:, None])[:, 0]
  in_junc = maps.sample(tid, Layer.JUNCTION, ego.pos[:, None])[:, 0]
  nb_rel = torch.argmin(db_in, -1)                                 # [B]
  nb = torch.gather(qb, 1, nb_rel[:, None])[:, 0]                  # [B]
  p0 = _take_point(route.points, nb)
  p1 = _take_point(route.points, torch.clamp(nb + 1, 0, R - 1))
  seg_d = p1 - p0
  degenerate = torch.linalg.vector_norm(seg_d, dim=-1) < 1e-3
  route_yaw = torch.where(degenerate, ego.yaw,
                          torch.atan2(seg_d[..., 1], seg_d[..., 0]))
  lat = torch.stack([-torch.sin(ego.yaw), torch.cos(ego.yaw)], -1)  # [B,2]
  offs = const([0.0, -1.75, 1.75], dev)
  probes = ego.pos[:, None] + offs[None, :, None] * lat[:, None]   # [B,3,2]
  dir_bin = maps.sample_value(tid, Layer.LANE_DIR, probes)          # [B,3]
  lane_yaw = (dir_bin - 1).to(torch.float32) * (2 * torch.pi / 16.0)
  yaw_diff = torch.abs(geo.normalize_angle(route_yaw[:, None] - lane_yaw))
  has_dir = dir_bin > 0
  agrees = has_dir & (yaw_diff <= 2.0)
  moving = ego.speed > c.blocked_speed_threshold
  wrong_lane = on_road & ~in_junc & torch.any(has_dir, -1) & \
      ~torch.any(agrees, -1) & moving
  off = ~on_road | wrong_lane
  outside_lane_m = cr.outside_lane_m + torch.where(off, step_m, 0.0)

  # --- collisions, counted on overlap onset per actor ---
  veh, wlk = state.vehicles, state.walkers
  ov_v = geo.obb_intersect(
      ego.pos[:, None], ego.yaw[:, None], ego_e[None, None],
      veh.pos, veh.yaw, veh.extent) & veh.valid                   # [B,V]
  ov_w = geo.obb_intersect(
      ego.pos[:, None], ego.yaw[:, None], ego_e[None, None],
      wlk.pos, wlk.yaw, wlk.extent) & wlk.valid                   # [B,W]
  # layout collision: the ego touches solid static geometry
  corners = geo.box_corners(ego.pos, ego.yaw, ego_e[None])        # [B,4,2]
  probe = torch.cat([corners, ego.pos[:, None]], 1)
  ov_s = torch.any(maps.sample(tid, Layer.OBSTACLE, probe), -1)
  dedup_ticks = int(round(c.collision_dedup_seconds * s.fps))
  hit_v = ov_v & (cr.veh_overlap == 0)
  hit_w = ov_w & (cr.wlk_overlap == 0)
  hit_s = ov_s & (cr.static_overlap == 0)

  def cooldown(ov, cd):
    return torch.where(ov, dedup_ticks, torch.clamp(cd - 1, min=0)).to(
        torch.int32)

  cd_v = cooldown(ov_v, cr.veh_overlap)
  cd_w = cooldown(ov_w, cr.wlk_overlap)
  cd_s = cooldown(ov_s, cr.static_overlap)
  new_v = torch.sum(hit_v, -1).to(torch.int32)
  new_w = torch.sum(hit_w, -1).to(torch.int32)
  new_s = hit_s.to(torch.int32)
  penalty = cr.penalty
  penalty = penalty * torch.pow(c.penalty_collision_pedestrian,
                                new_w.to(torch.float32))
  penalty = penalty * torch.pow(c.penalty_collision_vehicle,
                                new_v.to(torch.float32))
  penalty = penalty * torch.pow(c.penalty_collision_static,
                                new_s.to(torch.float32))

  # --- running a red light: the ego center crosses a facing stop line
  # while red, latched per entry; only the nearest box scores ---
  lights = scene.lights
  lstate = lights.state_at(state.time_s)
  facing_l = torch.abs(geo.normalize_angle(
      lights.yaw - ego.yaw[:, None])) < 0.8
  inside = geo.point_in_obb(ego.pos[:, None], lights.pos, lights.yaw,
                            lights.extent) & lights.valid & facing_l
  ld = torch.linalg.vector_norm(lights.pos - ego.pos[:, None], dim=-1)
  d_in = torch.where(inside, ld, torch.inf)
  nearest = F.one_hot(torch.argmin(d_in, -1), inside.shape[-1]).bool() & \
      inside
  red_run = nearest & (lstate == LightState.RED) & ~cr.red_light_cooldown \
      & (ego.speed > c.blocked_speed_threshold)[:, None]
  n_red_new = torch.sum(red_run, -1).to(torch.int32)
  penalty = penalty * torch.pow(c.penalty_traffic_light,
                                n_red_new.to(torch.float32))
  red_latch = inside

  # --- stop signs: the RunningStopTest state machine, with a straight
  # 20 m heading ray as the lane lookahead ---
  stops = scene.stops
  facing_s = torch.abs(geo.normalize_angle(
      stops.yaw - ego.yaw[:, None])) < 0.8
  fwd = torch.stack([torch.cos(ego.yaw), torch.sin(ego.yaw)], -1)   # [B,2]
  t_look = torch.linspace(0.0, 20.0, 11, device=dev)
  look = ego.pos[:, None] + t_look[None, :, None] * fwd[:, None]    # [B,T,2]
  rel = look[:, None] - stops.pos[:, :, None]                   # [B,S,T,2]
  cy, sy = torch.cos(stops.yaw), torch.sin(stops.yaw)           # [B,S]
  lx = rel[..., 0] * cy[..., None] + rel[..., 1] * sy[..., None]
  ly = -rel[..., 0] * sy[..., None] + rel[..., 1] * cy[..., None]
  inside_pt = (torch.abs(lx) <= stops.extent[..., 0:1]) & \
      (torch.abs(ly) <= stops.extent[..., 1:2])                 # [B,S,T]
  gate = stops.valid & facing_s
  targeted = torch.any(inside_pt, -1) & gate
  center_in = inside_pt[..., 0] & gate
  stopped = ego.speed < c.blocked_speed_threshold
  pending_now = targeted & ~cr.stop_done
  released = cr.stop_pending & ~targeted
  violated = released & cr.stop_entered & ~cr.stop_done
  satisfied = pending_now & stopped[:, None]
  stop_done = cr.stop_done | satisfied | released
  stop_pending = pending_now
  stop_entered = (cr.stop_entered | (pending_now & center_in)) & ~stop_done
  n_stop_new = torch.sum(violated, -1).to(torch.int32)
  penalty = penalty * torch.pow(c.penalty_stop, n_stop_new.to(torch.float32))

  # --- blocked / timeout ---
  slow = ego.speed < c.blocked_speed_threshold
  blocked_ticks = torch.where(slow, cr.blocked_ticks + 1, 0).to(torch.int32)
  blocked = cr.blocked | (blocked_ticks > int(c.blocked_seconds * s.fps))
  timed_out = cr.timed_out | (state.tick >= scene.timeout_ticks)

  # --- infraction event log: (pos, kind, tick) per NEW infraction ---
  ev_pos, ev_kind, ev_tick, ev_n = (cr.event_pos, cr.event_kind,
                                    cr.event_tick, cr.event_count)
  E = ev_kind.shape[1]
  for flag, kind in ((new_v > 0, EventKind.COLLISION_VEHICLE),
                     (new_w > 0, EventKind.COLLISION_WALKER),
                     (new_s > 0, EventKind.COLLISION_STATIC),
                     (n_red_new > 0, EventKind.RED_LIGHT),
                     (n_stop_new > 0, EventKind.STOP_SIGN)):
    slot = torch.clamp(ev_n, 0, E - 1).long()
    oh = F.one_hot(slot, E).bool() & flag[:, None] & (ev_n < E)[:, None]
    ev_pos = torch.where(oh[..., None], ego.pos[:, None], ev_pos)
    ev_kind = torch.where(oh, kind, ev_kind)
    ev_tick = torch.where(oh, state.tick[:, None], ev_tick)
    ev_n = ev_n + (flag & (ev_n < E)).to(torch.int32)

  return CriteriaState(
      event_pos=ev_pos, event_kind=ev_kind, event_tick=ev_tick,
      event_count=ev_n,
      penalty=penalty,
      n_collision_vehicle=cr.n_collision_vehicle + new_v,
      n_collision_walker=cr.n_collision_walker + new_w,
      n_collision_static=cr.n_collision_static + new_s,
      n_red_light=cr.n_red_light + n_red_new,
      n_stop_sign=cr.n_stop_sign + n_stop_new,
      route_completion=torch.maximum(cr.route_completion, completion),
      max_route_idx=new_idx.to(torch.int32),
      outside_lane_m=outside_lane_m, driven_m=driven_m,
      blocked_ticks=blocked_ticks,
      deviated=deviated, blocked=blocked, timed_out=timed_out,
      veh_overlap=cd_v, wlk_overlap=cd_w, static_overlap=cd_s,
      red_light_cooldown=red_latch,
      stop_pending=stop_pending, stop_done=stop_done,
      stop_entered=stop_entered)


def episode_done(cfg: GlobalConfig, state: SimState) -> torch.Tensor:
  cr = state.criteria
  completed = cr.route_completion >= cfg.criteria.min_route_completion
  return completed | cr.blocked | cr.deviated | cr.timed_out
