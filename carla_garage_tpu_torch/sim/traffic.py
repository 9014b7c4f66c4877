"""Vectorized NPC traffic policy (port of carla_garage_tpu/sim/traffic.py).

Every NPC follows a directed lane polyline of the town lane graph exactly
(rail following), with IDM-style longitudinal control: leader gap keeping,
red-light compliance at stop-line triggers, junction conflict yielding with
deterministic right of way, and don't-block-the-box holds at junction
entries. All [B,V] masked tensor ops. Scenario effects are not ported yet,
so ``traffic_step`` takes none.
"""

from __future__ import annotations

import torch

from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.device import const
from carla_garage_tpu_torch.maps.town_map import LaneGraph
from carla_garage_tpu_torch.sim import geometry as geo
from carla_garage_tpu_torch.sim.triggers import in_time_to_arrival
from carla_garage_tpu_torch.structs import (LightState, Scene, SimState,
                                            VehicleStates, WalkerStates)

NPC_TARGET_SPEED = 5.0     # m/s ~ TM default (30 km/h limit minus offset)
NPC_ACCEL = 1.0            # m/s^2
NPC_BRAKE = -4.95          # m/s^2 (the bicycle's brake_accel)
SAFE_TIME_HEADWAY = 1.6    # IDM
SAFE_MIN_GAP = 8.0         # center to center: ~3 m clear at standstill
LIGHT_STOP_DIST = 5.0


def traffic_step(cfg: GlobalConfig, lanes: LaneGraph, scene: Scene,
                 state: SimState) -> VehicleStates:
  """Advance all NPC vehicles one tick."""
  s = cfg.sim
  veh = state.vehicles
  B, V = veh.yaw.shape
  dev = veh.pos.device

  # --- leader gap: nearest agent ahead in our corridor ---
  def gap_to(others_pos, others_valid):
    rel = geo.world_to_ego(others_pos, veh.pos[:, :, None],
                           veh.yaw[:, :, None])          # [B,V,N,2]
    ahead = (rel[..., 0] > 0.0) & (torch.abs(rel[..., 1]) < 2.0)
    d = torch.where(ahead & others_valid, rel[..., 0], torch.inf)
    return torch.amin(d, -1)

  not_self = ~torch.eye(V, dtype=torch.bool, device=dev)[None]
  gap_veh = gap_to(veh.pos[:, None, :, :], veh.valid[:, None] & not_self)
  gap_ego = gap_to(state.ego.pos[:, None, None, :],
                   torch.ones((B, 1, 1), dtype=torch.bool, device=dev))
  wlk = state.walkers
  gap_wlk = gap_to(wlk.pos[:, None, :, :], (wlk.valid & wlk.active)[:, None])
  gap = torch.minimum(torch.minimum(gap_veh, gap_ego), gap_wlk)

  # --- junction conflict yielding over a few short horizons; the LOWER
  # slot index has right of way ---
  horizons = const([0.6, 1.1, 1.6], dev)                       # [H]
  fwd = torch.stack([torch.cos(veh.yaw), torch.sin(veh.yaw)], -1)
  p_h = veh.pos[None] + fwd[None] * (veh.speed[None] *
                                     horizons[:, None, None])[..., None]
  d_fut = torch.amin(torch.linalg.vector_norm(
      p_h[:, :, :, None] - p_h[:, :, None], dim=-1), 0)        # [B,V,V]
  hdiff = torch.abs(geo.normalize_angle(veh.yaw[:, :, None] -
                                        veh.yaw[:, None]))
  crossing = (hdiff > 0.4) & (hdiff < 2.7)
  conflict = (d_fut < 4.5) & crossing & veh.valid[:, None] & \
      veh.valid[:, :, None] & not_self
  rank = torch.arange(V, device=dev)
  other_moving = veh.speed[:, None, :] > 0.3
  yield_to = conflict & (rank[None, None, :] < rank[None, :, None]) & \
      other_moving
  ego_fwd = torch.stack([torch.cos(state.ego.yaw),
                         torch.sin(state.ego.yaw)], -1)
  ego_h = state.ego.pos[None] + ego_fwd[None] * \
      (state.ego.speed[None] * horizons[:, None])[..., None]    # [H,B,2]
  ego_hdiff = torch.abs(geo.normalize_angle(veh.yaw -
                                            state.ego.yaw[:, None]))
  rel_e = geo.world_to_ego(state.ego.pos[:, None], veh.pos, veh.yaw)
  headon_pass = (ego_hdiff > 2.7) & (torch.abs(rel_e[..., 1]) > 2.0)
  d_ego_fut = torch.amin(torch.linalg.vector_norm(
      p_h - ego_h[:, :, None], dim=-1), 0)
  ego_conflict = (d_ego_fut < 4.5) & ~headon_pass & \
      (state.ego.speed[:, None] > 0.3)
  junction_yield = torch.any(yield_to, -1) | ego_conflict

  # --- red light: stop if an affecting stop line is close ahead and red ---
  lights = scene.lights
  lstate = lights.state_at(state.time_s)                 # [B,L]
  rel_l = geo.world_to_ego(lights.pos[:, None], veh.pos[:, :, None],
                           veh.yaw[:, :, None])          # [B,V,L,2]
  ahead_l = (rel_l[..., 0] > 0.0) & (rel_l[..., 0] < LIGHT_STOP_DIST) & \
            (torch.abs(rel_l[..., 1]) < 2.0)
  facing = torch.abs(geo.normalize_angle(
      lights.yaw[:, None] - veh.yaw[:, :, None])) < 0.5
  red = (lstate == LightState.RED) | (lstate == LightState.YELLOW)
  light_block = torch.any(ahead_l & facing & red[:, None] &
                          lights.valid[:, None], -1)

  # --- successor choice + don't-block-the-box ---
  lane_id = veh.lane_id.long()
  total_here = lanes.total_len[lane_id]
  succs = lanes.successor[lane_id]                        # [B,V,MS]
  n_succ = torch.sum(succs >= 0, -1)
  choice = torch.where(n_succ > 0,
                       rank[None] % torch.clamp(n_succ, min=1), 0)
  nxt = torch.gather(succs, -1, choice[..., None])[..., 0]   # [B,V]
  near_end = (total_here - veh.lane_t) < 3.0
  nxt_safe = torch.clamp(nxt, min=0).long()
  exit_pt, _ = lanes.position_at(nxt_safe,
                                 lanes.total_len[nxt_safe] - 1.0)   # [B,V,2]
  d_exit = torch.linalg.vector_norm(exit_pt[:, :, None] - veh.pos[:, None],
                                    dim=-1)                         # [B,V,V]
  exit_occupied = torch.any((d_exit < 5.0) & veh.valid[:, None] & not_self,
                            -1)
  exit_occupied |= torch.linalg.vector_norm(
      exit_pt - state.ego.pos[:, None], dim=-1) < 5.0
  box_hold = near_end & (nxt >= 0) & exit_occupied

  # --- frontal protection vs the ego along the NPC's own rail ---
  look_d = const([0.0, 1.0, 2.5, 4.5, 7.0, 10.0], dev)
  lt_f = torch.minimum(veh.lane_t[..., None] + look_d[None, None],
                       total_here[..., None])                 # [B,V,D]
  lid_f = torch.broadcast_to(lane_id[..., None], lt_f.shape)
  pos_f, yaw_f = lanes.position_at(lid_f, lt_f)               # [B,V,D,2]
  ego_e = const([s.ego_extent_x, s.ego_extent_y], dev)
  ego_block = torch.any(geo.obb_intersect(
      pos_f, yaw_f, veh.extent[:, :, None],
      state.ego.pos[:, None, None], state.ego.yaw[:, None, None],
      ego_e[None, None, None]), -1) & veh.valid

  # --- IDM-style longitudinal control on the rail ---
  dead_ahead = (nxt < 0) & ((total_here - veh.lane_t) < 12.0)
  target_speed = torch.where(dead_ahead, 2.0, NPC_TARGET_SPEED)
  desired_gap = SAFE_MIN_GAP + veh.speed * SAFE_TIME_HEADWAY
  brake = (gap < desired_gap) | light_block | junction_yield | box_hold | \
      ego_block | (veh.speed > target_speed + 0.5)
  accel = torch.where(brake, NPC_BRAKE,
                      torch.where(veh.speed < target_speed, NPC_ACCEL, 0.0))
  speed = torch.clamp(veh.speed + accel * s.dt, min=0.0)
  speed = torch.minimum(speed, torch.maximum(target_speed, veh.speed))
  speed = torch.where(veh.valid, speed, 0.0)

  # --- rail following: position is a pure function of lane progress ---
  lane_t = veh.lane_t + speed * s.dt
  wrap = (lane_t >= total_here) & (nxt >= 0)
  new_lane = torch.where(wrap, nxt, veh.lane_id).to(torch.int32)
  lane_t2 = torch.where(wrap, lane_t - total_here,
                        torch.minimum(lane_t, total_here))
  pos, yaw = lanes.position_at(new_lane, lane_t2)
  yaw = geo.normalize_angle(yaw)
  pos = torch.where(veh.valid[..., None], pos, veh.pos)
  yaw = torch.where(veh.valid, yaw, veh.yaw)

  # equivalent bicycle controls for the expert's constant-action forecast
  yaw_rate = geo.normalize_angle(yaw - veh.yaw) / s.dt
  steer = torch.clamp(yaw_rate * (s.front_wb + s.rear_wb) /
                      (torch.clamp(speed, min=0.5) * s.steer_gain), -1.0, 1.0)
  throttle = torch.where(accel > 0, accel / s.throt_accel, 0.0)

  # --- despawn at dead ends and on long standstill ---
  stand = torch.where(speed < 0.05, veh.stand_ticks + 1, 0).to(torch.int32)
  deadlocked = stand > 800
  despawn = ((lane_t2 >= total_here - 1.0) & (nxt < 0)) | deadlocked
  valid = veh.valid & ~despawn

  # --- stuck-detection ring buffers ---
  def push(buf, v):
    return torch.cat([buf[..., 1:], v[..., None]], -1)

  brake_f = brake.to(torch.float32)
  return veh.replace(
      pos=pos, yaw=yaw, speed=speed, valid=valid,
      control=torch.stack([steer, throttle, brake_f], -1),
      buf_vel=push(veh.buf_vel, speed),
      buf_throttle=push(veh.buf_throttle, throttle),
      buf_brake=push(veh.buf_brake, brake_f),
      lane_id=new_lane, lane_t=lane_t2,
      stand_ticks=stand)


def walker_step(cfg: GlobalConfig, scene: Scene,
                state: SimState) -> WalkerStates:
  """Crossing-walker scenario dynamics (DynamicObjectCrossing semantics)."""
  s = cfg.sim
  wlk = state.walkers
  spec = scene.walkers_spec
  d_ego = torch.linalg.vector_norm(wlk.pos - state.ego.pos[:, None], dim=-1)
  tta_hit = (spec.trigger_tta > 0) & in_time_to_arrival(
      state.ego.pos[:, None], state.ego.speed[:, None], wlk.pos,
      spec.trigger_tta)
  trigger = wlk.valid & ((d_ego < spec.trigger_dist) | tta_hit)
  active = wlk.active | trigger
  walking = active & (wlk.walked_m < spec.cross_dist) & wlk.valid
  speed = torch.where(walking, spec.walk_speed, 0.0)
  pos = wlk.pos + wlk.direction * (speed * s.dt)[..., None]
  walked = wlk.walked_m + speed * s.dt
  # the crossing scenario destroys its walker once the cross completes
  finished = active & (walked >= spec.cross_dist)
  valid = wlk.valid & ~finished
  in_radius = valid & (d_ego < cfg.expert.detection_radius)
  seen = wlk.seen_frames + in_radius.to(torch.int32)
  return wlk.replace(pos=pos, speed=speed, active=active, walked_m=walked,
                     seen_frames=seen, valid=valid)
