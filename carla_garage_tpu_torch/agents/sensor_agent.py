"""Sensor agent: TransFuser++ driving from rendered sensors (port of
carla_garage_tpu/agents/sensor_agent.py).

Per tick: noisy GNSS and compass -> UKF predict/update -> route planners
-> camera render -> LiDAR half-sweep render, merged with the previous half
sweep -> voxelize -> model forward -> PID control, plus the stuck/creep
recovery with its LiDAR safety box. The spans of a tick
(``utils/profiling.py``): ``agent.localize`` (GNSS, compass, UKF, route
planners), ``agent.inputs`` (camera, LiDAR, realignment, voxelize;
inside it, with more than one buffered sweep, ``agent.lidar_history``, the
buffer's realignment and the older sweeps' voxelization, counting the
frames voxelized), ``agent.model``
(the forward with its casts and the ensemble's mean) and
``agent.control``.

A camera-only vision-language-action model (``models.vla.SimLingo``,
its config a ``SimLingoConfig``, or ``models.kimi_vl.KimiVL`` with a
``KimiVLConfig``) goes through the same policy: the camera frame becomes
InternVL2's 448-pixel tiles and thumbnail (``camera_tiles``) for
SimLingo, or stays whole at native resolution for Kimi-VL's MoonViT
(``camera_native``), the model takes two target points and no LiDAR BEV
(the half sweep is still rendered for the creep recovery's safety box),
and the controller steers at a point of its predicted path and takes
the speed from its speed waypoints.

The three random draws of a tick (GNSS noise, compass noise, LiDAR
dropoff uniforms) come from the caller's ``torch.Generator``, or as
tensors in ``draws`` under the keys of ``DRAW_KEYS``, so that a test can
feed in the JAX package's own draws.

The published operating points: ensembles (a list of state dicts,
outputs averaged), ``uncertainty_weight`` / ``brake_threshold``, JPEG
artifacts on the live camera (``jpeg_quality``), a temporal LiDAR buffer
(``seq_len > 1``: older half sweeps voxelize into extra channel pairs),
the MAP track (``map_track``), the waypoint controller (``direct=False``,
with the model's ``use_wp_gru`` head) and the detected-stop-sign
controller (``stop_control``, the LAV point).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses

import torch
import torch.nn.functional as F

from carla_garage_tpu_torch.agents.controllers import (control_pid,
                                                       control_pid_direct,
                                                       waypoint_speed)
from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.device import const, resolve_device
from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                      TransfuserConfig,
                                                      lidar_history)
from carla_garage_tpu_torch.models.kimi_vl import KimiVLConfig
from carla_garage_tpu_torch.models.vla import SimLingoConfig
from carla_garage_tpu_torch.ops.detection import topk_decode
from carla_garage_tpu_torch.ops.jpeg import jpeg_artifacts
from carla_garage_tpu_torch.sensors.camera import (camera_ray_grid,
                                                   render_camera)
from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid, render_lidar
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
from carla_garage_tpu_torch.utils.cuda_graph import GraphedForward
from carla_garage_tpu_torch.utils.profiling import span

GNSS_NOISE_M = 0.55          # 5e-6 deg lat/lon stddev * earth scale
COMPASS_NOISE = 0.001
TARGET_SPEEDS = (0.0, 2.0, 5.0, 8.0)   # m/s of the target-speed classes
# draws: gps [B,2] and compass [B] standard normals, lidar [B,N] uniforms
DRAW_KEYS = ("gps", "compass", "lidar")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SIGLIP_MEAN = SIGLIP_STD = 0.5    # MoonViT's normalisation
VLA_CONFIGS = (SimLingoConfig, KimiVLConfig)
PATH_AIM = 2                 # the path point (1 m apart) a VLA steers at


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
  # the detected-stop-sign controller: one tracked stop-sign detection
  # in the current ego frame and the cooldown after it was cleared
  stop_box: torch.Tensor          # [B,5] x, y, ex, ey, yaw
  stop_box_valid: torch.Tensor    # [B] bool
  clear_stop: torch.Tensor        # [B] int32 cooldown ticks


def sensor_agent_reset(cfg: GlobalConfig, B: int, n_lidar: int,
                       seq_len: int = 1, device="cuda") -> SensorAgentState:
  """seq_len > 1 keeps that many past half sweeps, as the model takes them
  (``models.transfuser.lidar_history``)."""
  dev = resolve_device(device)
  K = max(seq_len, 1)

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


def voxelize_older(points: torch.Tensor, valid: torch.Tensor,
                   cfg: GlobalConfig):
  """The buffer's older half sweeps (all but the newest) as channel pairs,
  oldest last: points [B,K,N,3], valid [B,K,N] -> [B,2(K-1),H,W] in one
  voxelization over the merged B(K-1) axis, bit-equal to one call a sweep
  (the histogram's counts are exact); None for K = 1."""
  B, K, N, _ = points.shape
  if K == 1:
    return None
  bev = voxelize(points[:, 1:].reshape(B * (K - 1), N, 3),
                 valid[:, 1:].reshape(B * (K - 1), N), cfg)
  return bev.reshape(B, 2 * (K - 1), *bev.shape[2:])


def camera_tiles(rgb: torch.Tensor, tile: int) -> torch.Tensor:
  """InternVL2's ``dynamic_preprocess`` of a frame whose sides are whole
  multiples of `tile` (its closest aspect ratio is its own, so nothing is
  resized): rgb [B,H,W,3] in 0..1 -> [B,T,3,tile,tile], the tiles row by
  row, then (with more than one) the whole frame resized to one tile by
  antialiased bicubic, each normalized by the ImageNet mean and std."""
  B, H, W, _ = rgb.shape
  rows, cols = H // tile, W // tile
  if rows * tile != H or cols * tile != W:
    raise ValueError(f"a {W}x{H} frame is no whole number of {tile}-pixel "
                     "tiles")
  x = rgb.permute(0, 3, 1, 2)
  tiles = x.reshape(B, 3, rows, tile, cols, tile).permute(0, 2, 4, 1, 3, 5) \
      .reshape(B, rows * cols, 3, tile, tile)
  if rows * cols > 1:
    thumb = F.interpolate(x, size=(tile, tile), mode="bicubic",
                          align_corners=False, antialias=True)
    tiles = torch.cat([tiles, thumb[:, None]], 1)
  mean = const(IMAGENET_MEAN, rgb.device, rgb.dtype)[:, None, None]
  std = const(IMAGENET_STD, rgb.device, rgb.dtype)[:, None, None]
  return (tiles - mean) / std


def camera_native(rgb: torch.Tensor) -> torch.Tensor:
  """The whole frame at native resolution, as MoonViT takes it: rgb
  [B,H,W,3] in 0..1 -> [B,3,H,W], normalised by SigLIP's mean and std
  (0.5 each)."""
  return (rgb.permute(0, 3, 1, 2) - SIGLIP_MEAN) / SIGLIP_STD


def camera_inputs(rgb: torch.Tensor, tcfg) -> torch.Tensor:
  """A VLA's camera input, by its configuration: SimLingo's tiles, or
  Kimi-VL's whole frame."""
  if isinstance(tcfg, SimLingoConfig):
    return camera_tiles(rgb, tcfg.tile)
  return camera_native(rgb)


def path_speed(pred_wp: torch.Tensor) -> torch.Tensor:
  """A VLA's target speed from its speed waypoints: ``control_pid``'s
  desired speed, 0 (a brake) where ``control_pid`` brakes for it."""
  desired = waypoint_speed(pred_wp)
  return torch.where(desired < 0.4, 0.0, desired)


def command_onehot(cmd: torch.Tensor) -> torch.Tensor:
  """6-way one-hot of RoadOption values 1..6."""
  return F.one_hot((torch.clamp(cmd, 1, 6) - 1).long(), 6).to(torch.float32)


def _members(model: LidarCenterNet, params, bf16: bool):
  """The modules the policy runs: `model` itself when params is None,
  else one copy of it per state dict (an ensemble for a list), all in
  eval mode and, with bf16, cast to bfloat16 once here. A model already
  placed in bfloat16 (``bf16_placed``, as ``KimiVL.load_published``
  leaves it, its routers' weights in float32) runs as it is: a copy of
  its 16B parameters would not fit beside it."""
  if bf16 and getattr(model, "bf16_placed", False):
    if params is not None:
      raise ValueError("a model placed in bf16 drives with its own "
                       "weights")
    return [model.eval()]
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

  model: a LidarCenterNet on the device the policy runs on, or a
  ``SimLingo`` with its ``SimLingoConfig`` as `tcfg`, or a ``KimiVL``
  with its ``KimiVLConfig`` (camera only, two
  target points, the path-and-speed controller; `direct`,
  `uncertainty_weight`, `brake_threshold` and `stop_control` do not
  apply to it). params: None
  to drive with the model's own weights, a state dict, or a list of state
  dicts (an ensemble whose outputs are averaged). bf16=True runs the
  forward in bfloat16 (weights and inputs cast, outputs cast back to
  float32), as the JAX package's bf16 policy does.

  direct=True uses the classified target speed + checkpoint-angle
  controller, else the waypoint controller on the model's ``pred_wp``
  (``use_wp_gru``). uncertainty_weight: weighted expectation of the speed
  classes with a brake-probability override, else argmax. map_track aims
  at the HD-map route point ahead instead of the predicted checkpoint
  (the MapAgent). stop_control: the agent tracks its own class-3
  CenterNet detection and stops fully inside it before going on
  (sensor_agent.py:617-657). jpeg_quality: JPEG artifacts on the live
  camera at that libjpeg quality (sensor_agent.py:277-279; cv2's default
  is 95)."""
  dev = next(model.parameters()).device
  # on the card each member's forward replays as a CUDA graph; the bf16
  # path's casts make new tensors of its outputs
  members = [GraphedForward(m, copy_outputs=not bf16)
             for m in _members(model, params, bf16)]
  cam_grid = torch.as_tensor(camera_grid, device=dev)
  g_front = torch.as_tensor(lidar_grid_front, device=dev).reshape(-1, 3)
  g_rear = torch.as_tensor(lidar_grid_rear, device=dev).reshape(-1, 3)
  target_speeds = const(TARGET_SPEEDS, dev)

  vla = isinstance(tcfg, VLA_CONFIGS)

  def fwd(m, *inputs):
    if not bf16:
      return m(*inputs)
    out = m(*(x.to(torch.bfloat16) for x in inputs))
    return tree_map(lambda x: x.to(torch.float32, copy=True), out)

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

    with span("agent.localize"):
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
      if vla:
        # the target point after it too: [B,2,2]
        tp2_world, _ = route_lookup(route.sparse_points, route.sparse_cmd,
                                    route.sparse_num_valid, pl_sparse.idx,
                                    2)
        target_point = torch.stack(
            [target_point, geo.world_to_ego(tp2_world, pos_f, yaw_f)], 1)

    with span("agent.inputs"):
      # --- sensors: the camera, then the front or rear LiDAR half by tick
      # parity, selected before the cast ---
      cam = render_camera(cfg, maps, scene, state, cam_grid)
      if jpeg_quality is not None:
        cam = dict(cam, rgb=jpeg_artifacts(cam["rgb"], quality=jpeg_quality))
      if vla:
        tiles = camera_inputs(cam["rgb"], tcfg)
      even = (state.tick % 2 == 0)[:, None, None]
      grid_sel = torch.where(even, g_front[None], g_rear[None])
      pts_now, val_now = render_lidar(cfg, maps, scene, state, grid_sel,
                                      uniform=draws.get("lidar"),
                                      per_episode=True, generator=generator)
      K = ag.prev_lidar.shape[1]
      history = span("agent.lidar_history", count=B * (K - 1)) if K > 1 \
          else contextlib.nullcontext()
      with history:
        # realign the buffered half sweeps into the current ego frame
        prev_pts_world = geo.ego_to_world(ag.prev_lidar[..., :2],
                                          ag.prev_pose[:, :, None, :2],
                                          ag.prev_pose[:, :, 2][:, :, None])
        prev_in_cur = geo.world_to_ego(prev_pts_world, pos_f[:, None, None],
                                       yaw_f[:, None, None])
        prev_pts = torch.cat([prev_in_cur, ag.prev_lidar[..., 2:]], -1)
        older = voxelize_older(prev_pts, ag.prev_lidar_valid, cfg)
      merged_pts = torch.cat([pts_now, prev_pts[:, 0]], 1)
      merged_val = torch.cat([val_now, ag.prev_lidar_valid[:, 0]], 1)
      if not vla:
        lidar_bev = voxelize(merged_pts, merged_val, cfg)
        # the newest buffered sweep merges with the live one; older sweeps
        # voxelize into extra channel pairs
        if older is not None:
          lidar_bev = torch.cat([lidar_bev, older], 1)
        lidar_bev = lidar_bev.permute(0, 2, 3, 1)

    with span("agent.model"):
      # --- model forward, averaged over the ensemble ---
      cmd_oh = command_onehot(cmd)
      inputs = (tiles, target_point, ego.speed, cmd_oh) if vla else \
          (cam["rgb"], lidar_bev, target_point, cmd_oh, ego.speed)
      outs = [fwd(m, *inputs) for m in members]
      out = tree_map(lambda *xs: sum(xs) / len(xs), *outs)

    with span("agent.control"):
      # --- control ---
      if vla:
        ts = path_speed(out["pred_wp"])
      elif direct:
        probs = torch.softmax(out["pred_target_speed"], -1)
        if uncertainty_weight:
          ts = torch.sum(probs * target_speeds, -1)       # expectation
          ts = torch.where(probs[:, 0] > brake_threshold, 0.0, ts)
        else:
          ts = target_speeds[torch.argmax(probs, -1)]
      if vla or direct:
        if map_track:
          aim_world, _ = route_lookup(route.points, route.cmd,
                                      route.num_valid, pl_dense.idx, 4)
          aim = geo.world_to_ego(aim_world, pos_f, yaw_f)
        elif vla:
          aim = out["pred_path"][:, PATH_AIM]
        else:
          aim = out["pred_checkpoint"][:, 2]              # ~2nd checkpoint
        angle = torch.rad2deg(torch.atan2(aim[:, 1], aim[:, 0])) / 90.0
        steer, throttle, brake, pt2, ps2 = control_pid_direct(
            ag.pid_turn, ag.pid_speed, ts, angle, ego.speed, cfg)
      else:
        steer, throttle, brake, pt2, ps2 = control_pid(
            ag.pid_turn, ag.pid_speed, out["pred_wp"], ego.speed, cfg)

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

      stop_box, stop_valid, clear_stop = ag.stop_box, ag.stop_box_valid, \
          ag.clear_stop
      if stop_control and "pred_bb" in out:
        stop_box, stop_valid, clear_stop, must_stop = _stop_controller(
            cfg, out["pred_bb"], ag, pos_f, yaw_f, ego.speed)
        throttle = torch.where(must_stop, 0.0, throttle)
        brake = torch.where(must_stop, 1.0, brake)

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
          force_move=force.to(torch.int32),
          stop_box=stop_box, stop_box_valid=stop_valid,
          clear_stop=clear_stop.to(torch.int32))
    return control, {"agent": new_ag}

  # the draws in the order the policy takes them from a generator: GNSS,
  # compass, then the LiDAR half sweep's dropoff
  policy.draw_specs = (("gps", (2,), "normal"), ("compass", (), "normal"),
                       ("lidar", (g_front.shape[0],), "uniform"))
  return policy


def sensor_grids(cfg: GlobalConfig, tcfg, camera_scale: int = 1,
                 lidar_decimate: int = 1) -> tuple:
  """The ray grids (camera, LiDAR front half, LiDAR rear half) of
  `cfg`'s sensor rig; a VLA's camera is its own (its config's
  ``camera_*``: InternVL2's tiling needs whole tiles)."""
  if isinstance(tcfg, VLA_CONFIGS):
    cfg = cfg.replace(sensor=dataclasses.replace(
        cfg.sensor, camera_width=tcfg.camera_width,
        camera_height=tcfg.camera_height, camera_fov=tcfg.camera_fov))
  return (camera_ray_grid(cfg, scale=camera_scale),
          lidar_ray_grid(cfg, half=0, decimate=lidar_decimate),
          lidar_ray_grid(cfg, half=1, decimate=lidar_decimate))


def make_sensor_policy(model, params, tcfg, grids: tuple, **policy_kw):
  """(policy, reset): ``make_transfuser_policy`` over the ray grids
  `grids` (``sensor_grids``) and ``reset(cfg, B, device)``, the agent
  state it starts from, with the LiDAR history the model takes (one half
  sweep for a camera-only model, which keeps it for the creep
  recovery's safety box)."""
  cam, lid_f, lid_r = grids
  policy = make_transfuser_policy(model, params, tcfg, cam, lid_f, lid_r,
                                  **policy_kw)
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  seq_len = 1 if isinstance(tcfg, VLA_CONFIGS) else lidar_history(tcfg)

  def reset(cfg: GlobalConfig, B: int, device="cuda") -> SensorAgentState:
    return sensor_agent_reset(cfg, B, n_lidar, seq_len=seq_len,
                              device=device)

  return policy, reset


def _stop_controller(cfg: GlobalConfig, pred_bb: dict, ag: SensorAgentState,
                     pos_f, yaw_f, speed):
  """The detected-stop-sign controller (sensor_agent.py:617-657): carry
  the tracked box into the current ego frame by the filtered pose delta,
  adopt the nearest fresh class-3 detection (score > 0.3) when none is
  tracked, drop it beyond the observable range, and when it overlaps the
  ego box require a full stop, then a 100-tick cooldown. Returns
  (stop_box, valid, clear_stop, must_stop)."""
  s = cfg.sensor
  ppm_grid = pred_bb["heatmap"].shape[1] / (s.max_y - s.min_y)
  det = topk_decode(pred_bb, ppm=ppm_grid, k=20, min_x=s.min_x,
                    min_y=s.min_y)
  stop_box, stop_valid = ag.stop_box, ag.stop_box_valid
  prev_p = ag.prev_pose[:, 0]
  bw = geo.ego_to_world(stop_box[:, :2], prev_p[:, :2], prev_p[:, 2])
  bcur = geo.world_to_ego(bw, pos_f, yaw_f)
  byaw = geo.normalize_angle(stop_box[:, 4] + prev_p[:, 2] - yaw_f)
  stop_box = torch.cat([bcur, stop_box[:, 2:4], byaw[:, None]], -1)
  is_stop = (det["cls"] == 3) & (det["score"] > 0.3)
  d2 = torch.where(is_stop, det["x"] ** 2 + det["y"] ** 2, torch.inf)
  bi = torch.argmin(d2, -1)[:, None]
  take = lambda a: torch.gather(a, 1, bi)[:, 0]
  fresh = torch.stack([take(det["x"]), take(det["y"]), take(det["l"]) / 2,
                       take(det["w"]) / 2, take(det["yaw"])], -1)
  adopt = torch.isfinite(take(d2)) & ~stop_valid
  stop_box = torch.where(adopt[:, None], fresh, stop_box)
  stop_valid = (stop_valid | adopt) & \
      (torch.linalg.vector_norm(stop_box[:, :2], dim=-1) < s.max_x)
  ego_e = const([cfg.sim.ego_extent_x, cfg.sim.ego_extent_y], pos_f.device)
  inter = geo.obb_intersect(
      torch.zeros_like(stop_box[:, None, :2]),
      torch.zeros_like(stop_box[:, None, 4]), ego_e[None, None],
      stop_box[:, None, :2], stop_box[:, None, 4],
      torch.clamp(stop_box[:, None, 2:4], min=0.5))[:, 0]
  active = stop_valid & inter & (ag.clear_stop <= 0)
  must_stop = active & (speed > 0.01)
  cleared = active & (speed <= 0.01)
  stop_valid = stop_valid & ~cleared
  clear_stop = torch.where(cleared, 100,
                           torch.clamp(ag.clear_stop - 1, min=0))
  return stop_box, stop_valid, clear_stop, must_stop
