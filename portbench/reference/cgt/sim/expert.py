"""The privileged expert (port of carla_garage_tpu/sim/expert.py).

One call controls every episode of the batch: the dense route planner,
the closed-loop ego forecast with the Bremsweg safety box, constant-action
vehicle forecasts, linear walker forecasts, oriented-box intersection
tests, the traffic-light and stop-sign logic, and the PID controllers, as
masked [B,V] / [B,W] tensor math. The JAX package's scans are Python loops
here: the forecast runs 20 blocks of 4 unrolled bicycle steps, the
back-only exclusion chain 80 steps. A call makes no host sync.

The steer noise is the one random draw: ``draws["steer_noise"]`` [B]
standard normals, or drawn from the caller's generator.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.cgt.config import GlobalConfig
from portbench.reference.cgt.device import const, to_int32
from portbench.reference.cgt.maps.town_map import Layer, MapStack
from portbench.reference.cgt.sim import geometry as geo
from portbench.reference.cgt.sim.dynamics import bicycle_step
from portbench.reference.cgt.sim.pid import PIDParams, pid_step
from portbench.reference.cgt.sim.route_planner import (PlannerParams,
                                                      planner_step,
                                                      route_lookup)
from portbench.reference.cgt.structs import (Cmd, ExpertState, LightState,
                                            PIDState, PlannerState, Scene,
                                            SimState, Struct)

REPLAN_EVERY = 4   # the forecast re-plans steering every 4 frames (0.2 s)
LOCAL = 128        # route points the forecast reads ahead of the pointer
# draws: steer_noise [B] standard normals
DRAW_KEYS = ("steer_noise",)
# (key, per-episode shape, distribution) of each draw, in the order the
# policy draws them from a generator (``expert_step.draw_specs``)
DRAW_SPECS = (("steer_noise", (), "normal"),)


@dataclasses.dataclass
class Control(Struct):
  steer: torch.Tensor     # [B]
  throttle: torch.Tensor  # [B]
  brake: torch.Tensor     # [B]


def _turn_params(cfg: GlobalConfig) -> PIDParams:
  e = cfg.expert
  return PIDParams(e.turn_kp, e.turn_ki, e.turn_kd, e.turn_n)


def _speed_params(cfg: GlobalConfig) -> PIDParams:
  e = cfg.expert
  return PIDParams(e.speed_kp, e.speed_ki, e.speed_kd, e.speed_n)


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


def _pid_throttle(pid_state: PIDState, target_speed, speed, brake, is_last,
                  cfg: GlobalConfig):
  """_get_throttle (autopilot.py:473-496)."""
  e = cfg.expert
  control_brake = (speed / torch.clamp(target_speed, min=1e-6)) > \
      e.brake_ratio
  ts = torch.where(brake, 0.0, target_speed)
  ts = torch.where(is_last, 0.0, ts)
  delta = torch.clamp(ts - speed, 0.0, e.clip_delta)
  new_state, out = pid_step(pid_state, delta, _speed_params(cfg))
  throttle = torch.clamp(out, 0.0, e.clip_throttle)
  throttle = torch.where(brake, 0.0, throttle)
  return new_state, throttle, control_brake


def _pid_steer(pid_state: PIDState, pos, yaw, target, speed, brake, is_last,
               cfg: GlobalConfig):
  """_get_steer (autopilot.py:421-448)."""
  angle = geo.angle_to_target_deg(pos, yaw, target) / 90.0
  angle = torch.where(is_last | ((speed < 0.01) & brake), 0.0, angle)
  new_state, out = pid_step(pid_state, angle, _turn_params(cfg))
  return new_state, torch.clamp(out, -1.0, 1.0), angle


def _vehicle_forecast_parallel(cfg: GlobalConfig, veh, n_future: int):
  """Constant-action bicycle rollout of every vehicle in closed form.

  With constant (steer, throttle, brake) the Euler recurrence unrolls to
  cumulative sums over the horizon: the speed is an affine ramp clipped
  at 0, the yaw a cumulative sum of speed, the position a cumulative sum
  of headings. Returns (loc [T,B,V,2], yaw [T,B,V]) at steps 1..T."""
  e, s = cfg.expert, cfg.sim
  dt = 1.0 / e.bicycle_frame_rate
  steer = veh.control[..., 0]
  throttle = veh.control[..., 1]
  brake = veh.control[..., 2] > 0.5
  accel = torch.where(brake, s.brake_accel, s.throt_accel * throttle)
  wheel = s.steer_gain * steer
  beta = torch.atan(s.rear_wb / (s.front_wb + s.rear_wb) * torch.tan(wheel))
  k = torch.sin(beta) / s.rear_wb

  t = torch.arange(n_future, dtype=torch.float32, device=accel.device)
  # speed BEFORE each step t (v_0 = current speed)
  v = torch.clamp(veh.speed[None] + accel[None] * t[:, None, None] * dt,
                  min=0.0)
  # yaw BEFORE each step: exclusive cumulative sum of v*k*dt
  yaw_pre = veh.yaw[None] + (torch.cumsum(v, 0) - v) * k[None] * dt
  head = yaw_pre + beta[None]
  dpos = v[..., None] * torch.stack([torch.cos(head), torch.sin(head)],
                                    -1) * dt
  loc = veh.pos[None] + torch.cumsum(dpos, 0)            # pos AFTER step t
  yaw_post = yaw_pre + v * k[None] * dt
  return loc, yaw_post


def _forecast(cfg: GlobalConfig, scene: Scene, state: SimState,
              planner_idx: torch.Tensor):
  """Closed-loop ego forecast and the Bremsweg safety box in one pass over
  the horizon (autopilot.forcast_ego_agent:810-881 and :744-772).

  The safety box steers at step o with the forecast's steering of step
  o-1, which is the ego's carried steer. The ego re-plans steering and
  throttle every REPLAN_EVERY frames and integrates the bicycle between
  re-plans; boxes are still emitted every frame.

  planner_idx [B]: the dense planner's pointer after this tick's advance.
  Returns the ego's front- and back-half centers [T,B,2] and yaw [T,B],
  the half-box extent, and the safety box's center, yaw and extent."""
  e, s = cfg.expert, cfg.sim
  n_future = int(e.extrapolation_seconds * e.bicycle_frame_rate)       # 80
  dt = 1.0 / e.bicycle_frame_rate
  ego, ex = state.ego, state.expert
  B = ego.yaw.shape[0]
  dev = ego.yaw.device
  dpp = _dense_planner_params(cfg)
  zeros_b = torch.zeros(B, dtype=torch.bool, device=dev)

  # initial rollout controls (autopilot.py:812-820)
  tgt_speed = ex.target_speed                       # previous tick's target
  _, throttle0, _ = _pid_throttle(ex.pid_speed, tgt_speed, ego.speed,
                                  zeros_b, zeros_b, cfg)

  # safety-box rollout bounds (autopilot.py:744-756)
  tgt = torch.clamp(tgt_speed, min=1e-3)
  bremsweg = ((ego.speed * 3.6) / 10.0) ** 2 / 2.0 + \
      e.safety_box_safety_margin
  idx_orient = to_int32(bremsweg / tgt * e.bicycle_frame_rate)
  idx_margin = to_int32(1.0 / tgt * e.bicycle_frame_rate)
  bound = torch.clamp(idx_margin + idx_orient, max=n_future)     # [B]

  # the pointer advances ~35 points over the 4 s horizon: the forecast
  # reads a [B,LOCAL] slice of the route
  R = scene.route.points.shape[1]
  offs = torch.arange(LOCAL, device=dev)
  qidx = (planner_idx.long()[:, None] + offs[None]).clamp(0, R - 1)
  local_pts = torch.gather(scene.route.points, 1,
                           qidx[..., None].expand(-1, -1, 2))
  local_seg = torch.gather(scene.route.seg_len, 1, qidx)
  local_cmd = torch.gather(scene.route.cmd, 1, qidx)
  local_nv = torch.clamp(scene.route.num_valid - planner_idx, 0, LOCAL)

  loc, yaw, spd = ego.pos, ego.yaw, ego.speed
  steer_a, throt_a, brake_a = ex.steer, throttle0, zeros_b
  pidx = torch.zeros_like(planner_idx)
  ptw, psw = ex.pid_turn.window, ex.pid_speed.window
  sb_loc = torch.zeros((B, 2), device=dev)
  sb_yaw = torch.zeros(B, device=dev)
  sb_spd, sb_brake = tgt, zeros_b
  no_throttle = torch.zeros(B, device=dev)
  half_x = s.ego_extent_x / 2.0
  front, back, yaws = [], [], []
  for blk in range(n_future // REPLAN_EVERY):
    for k in range(REPLAN_EVERY):
      o = blk * REPLAN_EVERY + k
      sb_brake = sb_brake | (o >= idx_margin)
      live = o < bound
      nloc, nyaw, nspd = bicycle_step(sb_loc, sb_yaw, sb_spd, steer_a,
                                      no_throttle, sb_brake.float(), s,
                                      dt=dt)
      sb_loc = torch.where(live[:, None], nloc, sb_loc)
      sb_yaw = torch.where(live, nyaw, sb_yaw)
      sb_spd = torch.where(live, nspd, sb_spd)

      loc, yaw, spd = bicycle_step(loc, yaw, spd, steer_a, throt_a,
                                   brake_a.float(), s, dt=dt)
      fwd = torch.stack([torch.cos(yaw), torch.sin(yaw)], -1)
      front.append(loc + fwd * half_x)
      back.append(loc - fwd * half_x)
      yaws.append(yaw)

    pl = planner_step(PlannerState(idx=pidx, is_last=zeros_b), local_pts,
                      local_seg, local_nv, loc, dpp)
    is_last = pl.is_last
    target, _ = route_lookup(local_pts, local_cmd, local_nv, pl.idx, 1)
    angle = geo.angle_to_target_deg(loc, yaw, target) / 90.0
    angle = torch.where(is_last, 0.0, angle)
    ptw2, steer_out = pid_step(PIDState(ptw), angle, _turn_params(cfg))
    steer = torch.clamp(steer_out, -1.0, 1.0)
    delta = torch.clamp(torch.where(is_last, 0.0, tgt_speed) - spd, 0.0,
                        e.clip_delta)
    psw2, thr_out = pid_step(PIDState(psw), delta, _speed_params(cfg))
    throt_a = torch.clamp(thr_out, 0.0, e.clip_throttle)
    brake_a = is_last
    steer_a = torch.where(is_last, 0.0, steer)
    pidx, ptw, psw = pl.idx, ptw2.window, psw2.window

  return dict(
      ego_front=torch.stack(front), ego_back=torch.stack(back),
      ego_yaw=torch.stack(yaws),                                # [T,B,...]
      ego_half_extent=const([half_x, s.ego_extent_y], dev),
      sb_center=geo.ego_to_world(sb_loc, ego.pos, ego.yaw),
      sb_yaw=geo.normalize_angle(ego.yaw + sb_yaw),
      sb_extent=const([s.ego_extent_x, s.ego_extent_y], dev))


def expert_step(cfg: GlobalConfig, maps: MapStack, scene: Scene,
                state: SimState, generator: torch.Generator | None = None,
                draws: dict | None = None):
  """One expert control step for the whole batch, as a policy for
  ``sim_step``. Returns (Control, {"expert": new ExpertState}). Mirrors
  _get_control (autopilot.py:260-334)."""
  draws = draws or {}
  unknown = set(draws) - set(DRAW_KEYS)
  if unknown:
    raise KeyError(f"unknown draws {sorted(unknown)}; known: {DRAW_KEYS}")
  e, s = cfg.expert, cfg.sim
  ego, veh, wlk, ex = state.ego, state.vehicles, state.walkers, state.expert
  route = scene.route
  dev = ego.yaw.device
  B = ego.yaw.shape[0]
  T = int(e.extrapolation_seconds * e.bicycle_frame_rate)
  t_nj = int(e.extrapolation_seconds_no_junction * e.bicycle_frame_rate)

  # dense route planner advance (autopilot.py:265-268)
  pl_dense = planner_step(ex.planner_dense, route.points, route.seg_len,
                          route.num_valid, ego.pos,
                          _dense_planner_params(cfg))
  near_target, near_cmd = route_lookup(route.points, route.cmd,
                                       route.num_valid, pl_dense.idx, 1)
  lane_change = (near_cmd == Cmd.CHANGE_LANE_LEFT) | \
                (near_cmd == Cmd.CHANGE_LANE_RIGHT)

  # forecasts; the previous tick's junction flag gates the horizon
  fc = _forecast(cfg, scene, state, pl_dense.idx)
  t_idx = torch.arange(T, device=dev)
  step_valid = ex.junction[None, :] | (t_idx[:, None] <= t_nj)     # [T,B]

  veh_dist = torch.linalg.vector_norm(veh.pos - ego.pos[:, None], dim=-1)
  veh_near = veh.valid & (veh_dist < e.detection_radius)          # [B,V]
  wlk_dist = torch.linalg.vector_norm(wlk.pos - ego.pos[:, None], dim=-1)
  wlk_near = wlk.valid & (wlk_dist < e.detection_radius) & \
      (wlk.seen_frames > 0)                         # one frame of delay

  # stuck vehicles keep their current box at every future step
  # (autopilot.py:669-672, :694-695)
  stuck = (torch.mean(veh.buf_vel, -1) < e.stuck_vel_threshold) & \
          (torch.mean(veh.buf_throttle, -1) > e.stuck_throttle_threshold) & \
          (torch.mean(veh.buf_brake, -1) < e.stuck_brake_threshold)
  veh_loc, veh_yaw_t = _vehicle_forecast_parallel(cfg, veh, T)
  vloc = torch.where(stuck[None, :, :, None], veh_loc[0:1], veh_loc)
  vyaw = torch.where(stuck[None], veh_yaw_t[0:1], veh_yaw_t)

  # ego half-boxes vs vehicles over the future steps, [T,B,V]
  he = fc["ego_half_extent"]
  front_int = geo.obb_intersect(
      fc["ego_front"][:, :, None], fc["ego_yaw"][:, :, None],
      he[None, None, None], vloc, vyaw, veh.extent[None])
  back_int = geo.obb_intersect(
      fc["ego_back"][:, :, None], fc["ego_yaw"][:, :, None],
      he[None, None, None], vloc, vyaw, veh.extent[None])
  gate = step_valid[:, :, None] & veh_near[None]
  front_int = front_int & gate
  back_int = back_int & gate

  # back-only exclusion chain (autopilot.py:699-713): a vehicle that
  # intersected only the back half keeps being skipped while it still
  # back-intersects
  flag = torch.zeros_like(veh.valid)
  front_hazard = torch.zeros_like(veh.valid)
  for t in range(T):
    f_t, b_t = front_int[t], back_int[t]
    front_hazard = front_hazard | (f_t & ~flag)
    flag = torch.where(flag, b_t, b_t & ~f_t)
  vehicle_hazard = torch.any(front_hazard, -1)
  # lane changes also count back hits as hazards
  vehicle_hazard = vehicle_hazard | \
      (torch.any(back_int.any(0), -1) & lane_change)

  # walkers: linear forecast in closed form (autopilot.py:883-942)
  dt_b = 1.0 / e.bicycle_frame_rate
  steps = (t_idx.to(torch.float32) + 1.0)[:, None, None, None]
  wpos_t = wlk.pos[None] + wlk.direction[None] * \
      (wlk.speed[None, :, :, None] * steps * dt_b)                 # [T,B,W,2]
  wgate = step_valid[:, :, None] & wlk_near[None]
  walker_int = geo.obb_intersect(
      fc["ego_front"][:, :, None], fc["ego_yaw"][:, :, None],
      he[None, None, None], wpos_t, wlk.yaw[None], wlk.extent[None])
  walker_hazard = torch.any((walker_int & wgate).any(0), -1)

  # walker_close: any forecastable walker ahead (autopilot.py:897-902)
  rel = geo.world_to_ego(wlk.pos, ego.pos[:, None], ego.yaw[:, None])
  walker_close = torch.any(wlk_near & (rel[..., 0] > s.ego_extent_x), -1)

  # Bremsweg safety box
  sb_c, sb_yaw, sb_e = fc["sb_center"], fc["sb_yaw"], fc["sb_extent"]
  sb_veh = geo.obb_intersect(sb_c[:, None], sb_yaw[:, None],
                             sb_e[None, None], veh.pos, veh.yaw,
                             veh.extent) & veh_near
  vehicle_hazard = vehicle_hazard | torch.any(sb_veh, -1)
  sb_wlk = geo.obb_intersect(sb_c[:, None], sb_yaw[:, None],
                             sb_e[None, None], wlk.pos, wlk.yaw,
                             wlk.extent) & wlk_near
  walker_hazard = walker_hazard | torch.any(sb_wlk, -1)

  # red light (autopilot.py:944-1011): only lights facing the ego, and
  # only the nearest affecting one governs
  lights = scene.lights
  lstate = lights.state_at(state.time_s)                            # [B,L]
  ldist = torch.linalg.vector_norm(lights.pos - ego.pos[:, None], dim=-1)
  facing = torch.abs(geo.normalize_angle(
      lights.yaw - ego.yaw[:, None])) < 0.8
  lnear = lights.valid & (ldist < e.light_radius) & facing
  ego_e = sb_e
  hit_sb = geo.obb_intersect(sb_c[:, None], sb_yaw[:, None],
                             sb_e[None, None], lights.pos, lights.yaw,
                             lights.extent)
  hit_ego = geo.obb_intersect(ego.pos[:, None], ego.yaw[:, None],
                              ego_e[None, None], lights.pos, lights.yaw,
                              lights.extent)
  affects = lnear & (hit_sb | hit_ego)
  is_red = (lstate == LightState.RED) | (lstate == LightState.YELLOW)
  d_aff = torch.where(affects, ldist, torch.inf)
  best = torch.argmin(d_aff, -1)
  light_hazard = torch.any(affects, -1) & \
      torch.gather(is_red, 1, best[:, None])[:, 0]

  # stop signs (autopilot.py:1013-1070), targeted as the RunningStop
  # criterion targets them (a 20 m own-lane lookahead)
  stops = scene.stops
  sdist = torch.linalg.vector_norm(stops.pos - ego.pos[:, None], dim=-1)
  sfacing = torch.abs(geo.normalize_angle(
      stops.yaw - ego.yaw[:, None])) < 0.8
  svalid = stops.valid & sfacing
  fwd2 = torch.stack([torch.cos(ego.yaw), torch.sin(ego.yaw)], -1)
  t_look = torch.linspace(0.0, 20.0, 11, device=dev)
  look = ego.pos[:, None] + t_look[None, :, None] * fwd2[:, None]  # [B,T,2]
  rel_s = look[:, None] - stops.pos[:, :, None]                # [B,S,T,2]
  cy_s, sy_s = torch.cos(stops.yaw), torch.sin(stops.yaw)
  lx_s = rel_s[..., 0] * cy_s[..., None] + rel_s[..., 1] * sy_s[..., None]
  ly_s = -rel_s[..., 0] * sy_s[..., None] + rel_s[..., 1] * cy_s[..., None]
  inside_s = (torch.abs(lx_s) <= stops.extent[..., 0:1]) & \
      (torch.abs(ly_s) <= stops.extent[..., 1:2])              # [B,S,T]
  targeted = torch.any(inside_s, -1) & svalid                  # [B,S]
  hit_d = torch.amin(torch.where(inside_s, t_look[None, None], torch.inf),
                     -1)
  uncleared = ~ex.cleared_stop_signs
  stopped_now = ego.speed < 0.05
  stop_sign_hazard = torch.any(targeted & uncleared & (hit_d < 8.0), -1) \
      & ~stopped_now
  newly_cleared = targeted & uncleared & stopped_now[:, None]
  stop_sign_close = torch.any(targeted & uncleared, -1)
  # the cleared latch holds while the sign stays near
  cleared = (ex.cleared_stop_signs | newly_cleared) & \
      (stops.valid & (sdist < e.light_radius))

  brake = vehicle_hazard | light_hazard | walker_hazard | stop_sign_hazard

  # junction (raster layer or the route's flag) and target speed
  junction = maps.sample(scene.town_id[:, None], Layer.JUNCTION,
                         ego.pos[:, None])[:, 0]
  R = route.points.shape[1]
  route_junc = torch.gather(route.is_junction, 1,
                            pl_dense.idx.long().clamp(0, R - 1)[:, None])[:, 0]
  junction = junction | route_junc
  target_speed = torch.where(
      walker_close | stop_sign_close, e.target_speed_walker,
      torch.where(junction, e.target_speed_slow, e.target_speed_fast))

  # controllers (autopilot.py:291-298)
  pid_speed2, throttle, control_brake = _pid_throttle(
      ex.pid_speed, target_speed, ego.speed, brake, pl_dense.is_last, cfg)
  pid_turn2, steer, _ = _pid_steer(
      ex.pid_turn, ego.pos, ego.yaw, near_target, ego.speed, brake,
      pl_dense.is_last, cfg)
  noise = draws.get("steer_noise")
  if noise is None:
    noise = torch.randn((B,), generator=generator, device=dev)
  steer_noisy = steer + e.steer_noise * noise
  out_brake = (brake | control_brake).to(torch.float32)

  # sparse command planner advance (autopilot.py:308-323)
  pl_sparse = planner_step(
      ex.planner_sparse, route.sparse_points,
      _sparse_seg_len(route.sparse_points, route.sparse_num_valid),
      route.sparse_num_valid, ego.pos, _sparse_planner_params(cfg))

  new_ex = ExpertState(
      planner_dense=pl_dense, planner_sparse=pl_sparse,
      pid_turn=pid_turn2, pid_speed=pid_speed2,
      steer=steer_noisy, target_speed=target_speed, junction=junction,
      cleared_stop_signs=cleared,
      vehicle_hazard=vehicle_hazard, walker_hazard=walker_hazard,
      light_hazard=light_hazard, stop_sign_hazard=stop_sign_hazard,
      walker_close=walker_close, stop_sign_close=stop_sign_close)
  control = Control(steer=steer_noisy,
                    throttle=torch.where(brake, 0.0, throttle),
                    brake=out_brake)
  return control, {"expert": new_ex}


expert_step.draw_specs = DRAW_SPECS
