"""Sensor agent: TransFuser++ driving from rendered sensors (port of
carla_garage_tpu/agents/sensor_agent.py).

Per tick: noisy GNSS and compass -> UKF predict/update -> route planners
-> camera render -> LiDAR half-sweep render, merged with the previous half
sweep -> voxelize -> model forward -> PID control, plus the stuck/creep
recovery with its LiDAR safety box.

The three random draws of a tick (GNSS noise, compass noise, LiDAR
dropoff uniforms) come from the caller's ``torch.Generator``, or as
tensors in ``draws`` under the keys of ``DRAW_KEYS``, so that a test can
feed in the JAX package's own draws.

Options not ported yet raise ``NotImplementedError``: ``map_track``,
``stop_control``, ``jpeg_quality``, a temporal LiDAR buffer
(``seq_len > 1``) and the waypoint controller (``direct=False``, which
needs the model's waypoint GRU).
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn.functional as F

from carla_garage_tpu_torch.agents.controllers import control_pid_direct
from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.device import const, resolve_device
from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                      TransfuserConfig)
from carla_garage_tpu_torch.sensors.camera import render_camera
from carla_garage_tpu_torch.sensors.lidar import render_lidar
from carla_garage_tpu_torch.sensors.voxelize import voxelize
from carla_garage_tpu_torch.sim import geometry as geo
from carla_garage_tpu_torch.sim.expert import (Control, _dense_planner_params,
                                               _sparse_planner_params,
                                               _sparse_seg_len)
from carla_garage_tpu_torch.sim.route_planner import planner_step, route_lookup
from carla_garage_tpu_torch.sim.ukf import (UKFState, ukf_predict, ukf_reset,
                                            ukf_update)
from carla_garage_tpu_torch.structs import (PIDState, PlannerState, Scene,
                                            SimState, Struct, tree_map)

GNSS_NOISE_M = 0.55          # 5e-6 deg lat/lon stddev * earth scale
COMPASS_NOISE = 0.001
TARGET_SPEEDS = (0.0, 2.0, 5.0, 8.0)   # m/s of the target-speed classes
# draws: gps [B,2] and compass [B] standard normals, lidar [B,N] uniforms
DRAW_KEYS = ("gps", "compass", "lidar")


@dataclasses.dataclass
class SensorAgentState(Struct):
  ukf: UKFState
  planner_dense: PlannerState
  planner_sparse: PlannerState
  pid_turn: PIDState
  pid_speed: PIDState
  prev_control: torch.Tensor      # [B,3] steer/throttle/brake last applied
  prev_lidar: torch.Tensor        # [B,K,N,3] buffer of past half sweeps
  prev_lidar_valid: torch.Tensor  # [B,K,N]
  prev_pose: torch.Tensor         # [B,K,3] filtered (x,y,yaw) per sweep
  stuck_count: torch.Tensor       # [B] int32
  force_move: torch.Tensor        # [B] int32 remaining creep frames
  stop_box: torch.Tensor          # [B,5] (stop-sign controller, not ported)
  stop_box_valid: torch.Tensor    # [B] bool
  clear_stop: torch.Tensor        # [B] int32


def sensor_agent_reset(cfg: GlobalConfig, B: int, n_lidar: int,
                       seq_len: int = 1, device="cuda") -> SensorAgentState:
  if seq_len > 1:
    raise NotImplementedError("the temporal LiDAR buffer (seq_len > 1) is "
                              "not ported yet")
  dev = resolve_device(device)
  K = 1

  def planner():
    return PlannerState(idx=torch.zeros((B,), dtype=torch.int32, device=dev),
                        is_last=torch.zeros((B,), dtype=torch.bool,
                                            device=dev))

  zi = torch.zeros((B,), dtype=torch.int32, device=dev)
  return SensorAgentState(
      ukf=ukf_reset(B, device=dev),
      planner_dense=planner(), planner_sparse=planner(),
      pid_turn=PIDState.create((B,), cfg.expert.turn_n, device=dev),
      pid_speed=PIDState.create((B,), cfg.expert.speed_n, device=dev),
      prev_control=torch.zeros((B, 3), device=dev),
      prev_lidar=torch.zeros((B, K, n_lidar, 3), device=dev),
      prev_lidar_valid=torch.zeros((B, K, n_lidar), dtype=torch.bool,
                                   device=dev),
      prev_pose=torch.zeros((B, K, 3), device=dev),
      stuck_count=zi, force_move=zi.clone(),
      stop_box=torch.zeros((B, 5), device=dev),
      stop_box_valid=torch.zeros((B,), dtype=torch.bool, device=dev),
      clear_stop=zi.clone())


def command_onehot(cmd: torch.Tensor) -> torch.Tensor:
  """6-way one-hot of RoadOption values 1..6."""
  return F.one_hot((torch.clamp(cmd, 1, 6) - 1).long(), 6).to(torch.float32)


def _members(model: LidarCenterNet, params, bf16: bool):
  """The modules the policy runs: `model` itself when params is None,
  else one copy of it per state dict (an ensemble for a list), all in
  eval mode and, with bf16, cast to bfloat16 once here."""
  if params is None:
    mods = [model]
  else:
    plist = params if isinstance(params, (list, tuple)) else [params]
    mods = []
    for sd in plist:
      m = copy.deepcopy(model)
      m.load_state_dict(sd)
      mods.append(m)
  if bf16:
    mods = [copy.deepcopy(m).to(torch.bfloat16) for m in mods]
  return [m.eval() for m in mods]


def make_transfuser_policy(model: LidarCenterNet, params,
                           tcfg: TransfuserConfig, camera_grid,
                           lidar_grid_front, lidar_grid_rear,
                           direct: bool = True, map_track: bool = False,
                           uncertainty_weight: bool = True,
                           brake_threshold: float = 0.5,
                           stop_control: bool = False,
                           bf16: bool = False,
                           jpeg_quality: int | None = None):
  """The sensor pipeline + model + control as a policy for ``sim_step``.

  model: a LidarCenterNet on the device the policy runs on. params: None
  to drive with the model's own weights, a state dict, or a list of state
  dicts (an ensemble whose outputs are averaged). bf16=True runs the
  forward in bfloat16 (weights and inputs cast, outputs cast back to
  float32), as the JAX package's bf16 policy does.

  direct=True uses the classified target speed + checkpoint-angle
  controller (the only one ported yet). uncertainty_weight: weighted
  expectation of the speed classes with a brake-probability override,
  else argmax."""
  if not direct or map_track or stop_control or jpeg_quality is not None:
    raise NotImplementedError("direct=False, map_track, stop_control and "
                              "jpeg_quality are not ported yet")
  dev = next(model.parameters()).device
  members = _members(model, params, bf16)
  cam_grid = torch.as_tensor(camera_grid, device=dev)
  g_front = torch.as_tensor(lidar_grid_front, device=dev).reshape(-1, 3)
  g_rear = torch.as_tensor(lidar_grid_rear, device=dev).reshape(-1, 3)
  target_speeds = const(TARGET_SPEEDS, dev)

  def fwd(m, rgb, lidar_bev, target_point, cmd_oh, speed):
    if not bf16:
      return m(rgb, lidar_bev, target_point, cmd_oh, speed)
    cast = lambda x: x.to(torch.bfloat16)
    out = m(cast(rgb), cast(lidar_bev), cast(target_point), cast(cmd_oh),
            cast(speed))
    return tree_map(lambda x: x.to(torch.float32), out)

  @torch.no_grad()
  def policy(cfg: GlobalConfig, maps, scene: Scene, state: SimState,
             generator: torch.Generator | None = None,
             draws: dict | None = None):
    draws = draws or {}
    unknown = set(draws) - set(DRAW_KEYS)
    if unknown:
      raise KeyError(f"unknown draws {sorted(unknown)}; known: {DRAW_KEYS}")
    ag: SensorAgentState = state.agent
    ego = state.ego
    B = ego.yaw.shape[0]

    def draw(key, shape, fn):
      x = draws.get(key)
      return fn(shape, generator=generator, device=dev) if x is None else x

    # --- localization: noisy GNSS/compass -> UKF ---
    gps = ego.pos + GNSS_NOISE_M * draw("gps", (B, 2), torch.randn)
    compass = ego.yaw + COMPASS_NOISE * draw("compass", (B,), torch.randn)
    ukf = ukf_predict(ag.ukf, ag.prev_control[:, 0], ag.prev_control[:, 1],
                      ag.prev_control[:, 2], cfg.sim)
    z = torch.stack([gps[:, 0], gps[:, 1], compass, ego.speed], -1)
    ukf = ukf_update(ukf, z)
    pos_f = ukf.x[:, :2]
    yaw_f = ukf.x[:, 2]

    # --- route planners on the filtered pose ---
    route = scene.route
    pl_dense = planner_step(ag.planner_dense, route.points, route.seg_len,
                            route.num_valid, pos_f,
                            _dense_planner_params(cfg))
    pl_sparse = planner_step(
        ag.planner_sparse, route.sparse_points,
        _sparse_seg_len(route.sparse_points, route.sparse_num_valid),
        route.sparse_num_valid, pos_f, _sparse_planner_params(cfg))
    tp_world, cmd = route_lookup(route.sparse_points, route.sparse_cmd,
                                 route.sparse_num_valid, pl_sparse.idx, 1)
    target_point = geo.world_to_ego(tp_world, pos_f, yaw_f)

    # --- sensors: the camera, then the front or rear LiDAR half by tick
    # parity, selected before the cast ---
    cam = render_camera(cfg, maps, scene, state, cam_grid)
    even = (state.tick % 2 == 0)[:, None, None]
    grid_sel = torch.where(even, g_front[None], g_rear[None])
    pts_now, val_now = render_lidar(cfg, maps, scene, state, grid_sel,
                                    uniform=draws.get("lidar"),
                                    per_episode=True, generator=generator)
    # realign the buffered half sweep into the current ego frame
    prev_pts_world = geo.ego_to_world(ag.prev_lidar[..., :2],
                                      ag.prev_pose[:, :, None, :2],
                                      ag.prev_pose[:, :, 2][:, :, None])
    prev_in_cur = geo.world_to_ego(prev_pts_world, pos_f[:, None, None],
                                   yaw_f[:, None, None])
    prev_pts = torch.cat([prev_in_cur, ag.prev_lidar[..., 2:]], -1)
    merged_pts = torch.cat([pts_now, prev_pts[:, 0]], 1)
    merged_val = torch.cat([val_now, ag.prev_lidar_valid[:, 0]], 1)
    lidar_bev = voxelize(merged_pts, merged_val, cfg).permute(0, 2, 3, 1)

    # --- model forward, averaged over the ensemble ---
    cmd_oh = command_onehot(cmd)
    outs = [fwd(m, cam["rgb"], lidar_bev, target_point, cmd_oh, ego.speed)
            for m in members]
    out = tree_map(lambda *xs: sum(xs) / len(xs), *outs)

    # --- control: classified target speed + checkpoint angle ---
    probs = torch.softmax(out["pred_target_speed"], -1)
    if uncertainty_weight:
      ts = torch.sum(probs * target_speeds, -1)         # expectation
      ts = torch.where(probs[:, 0] > brake_threshold, 0.0, ts)
    else:
      ts = target_speeds[torch.argmax(probs, -1)]
    aim = out["pred_checkpoint"][:, 2]                  # ~2nd checkpoint aim
    angle = torch.rad2deg(torch.atan2(aim[:, 1], aim[:, 0])) / 90.0
    steer, throttle, brake, pt2, ps2 = control_pid_direct(
        ag.pid_turn, ag.pid_speed, ts, angle, ego.speed, cfg)

    # --- stuck -> creep recovery, blocked by returns in the LiDAR
    # safety box directly ahead ---
    e, s = cfg.expert, cfg.sim
    stuck = torch.where(ego.speed < 0.1, ag.stuck_count + 1, 0)
    start_creep = stuck > e.stuck_threshold
    force = torch.where(start_creep, e.creep_duration,
                        torch.clamp(ag.force_move - 1, min=0))
    in_box = (merged_val &
              (merged_pts[..., 0] > s.ego_extent_x) &
              (merged_pts[..., 0] < s.ego_extent_x + 2.5) &
              (torch.abs(merged_pts[..., 1]) < s.ego_extent_y * 0.8) &
              (merged_pts[..., 2] > 0.5) & (merged_pts[..., 2] < 1.5))
    obstructed = torch.any(in_box, -1)
    creeping = (force > 0) & ~obstructed
    # an obstructed creep re-arms for when the box clears
    force = torch.where((force > 0) & obstructed, e.creep_duration, force)
    throttle = torch.where(creeping, e.creep_throttle, throttle)
    brake = torch.where(creeping, 0.0,
                        torch.where((force > 0) & obstructed, 1.0, brake))
    stuck = torch.where(creeping, 0, stuck)

    control = Control(steer=steer, throttle=throttle, brake=brake)
    new_pose = torch.stack([pos_f[:, 0], pos_f[:, 1], yaw_f], -1)
    new_ag = ag.replace(
        ukf=ukf, planner_dense=pl_dense, planner_sparse=pl_sparse,
        pid_turn=pt2, pid_speed=ps2,
        prev_control=torch.stack([steer, throttle, brake], -1),
        prev_lidar=torch.cat([pts_now[:, None], ag.prev_lidar[:, :-1]], 1),
        prev_lidar_valid=torch.cat([val_now[:, None],
                                    ag.prev_lidar_valid[:, :-1]], 1),
        prev_pose=torch.cat([new_pose[:, None], ag.prev_pose[:, :-1]], 1),
        stuck_count=stuck.to(torch.int32),
        force_move=force.to(torch.int32))
    return control, {"agent": new_ag}

  return policy
