"""TransFuser++ imitation-learning training with sensors and labels
rendered on the device (port of carla_garage_tpu/train/transfuser_train.py).

Training frames come from expert rollouts (``sim/datagen.py``); camera,
LiDAR and every label channel (semantics, depth, BEV semantics, CenterNet
targets) are rendered at the recorded poses. The loss mirrors
model.compute_loss (model.py:394-445) with train.py's loss weights
(:384-456).

Mixed precision as the JAX package does it: the float32 parameters are
cast to bfloat16 for the forward pass (``torch.func.functional_call``, so
autograd returns float32 gradients through the cast) and so are the
camera and LiDAR inputs; no autocast. A step accumulates the gradients of
K micro-batches, one recorded frame of every episode each, and makes no
host sync: frame indices are host ints, and the random draws (LiDAR
dropoff, speed-input dropout) come as tensors or from a generator.

Data parallel (``mesh``, ``parallel/mesh.py``): every rank holds the whole
dataset and renders its slice of the episodes; the loss's denominators
are summed over the ranks, so each rank's loss is its share of the global
loss; the step sums the ranks' gradients in one bucketed all-reduce, then
clips and steps on every rank (ZeRO-1 AdamW from ``make_optimizer``). The
draws of the global batch are sliced, so n ranks compute what one process
computes on the same draws.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.cgt.agents.sensor_agent import command_onehot
from portbench.reference.cgt.config import GlobalConfig
from portbench.reference.cgt.device import to_int32
from portbench.reference.cgt.models.transfuser import (LidarCenterNet,
                                                      TransfuserConfig)
from portbench.reference.cgt.ops import detection as det
from portbench.reference.cgt.ops.losses import (cross_entropy, l1_masked,
                                               one_hot)
from portbench.reference.cgt.parallel import mesh as mesh_lib
from portbench.reference.cgt.sensors.bev import render_bev_semantics
from portbench.reference.cgt.sensors.camera import render_camera
from portbench.reference.cgt.sensors.lidar import render_lidar
from portbench.reference.cgt.sensors.voxelize import voxelize
from portbench.reference.cgt.sim import geometry as geo
from portbench.reference.cgt.sim.datagen import (Frames, checkpoint_labels,
                                                target_speed_labels,
                                                waypoint_labels)
from portbench.reference.cgt.structs import (EgoState, LightState, Scene,
                                            SimState, VehicleStates,
                                            WalkerStates, tree_map)
from portbench.reference.cgt.train.schedules import (SPEED_WEIGHTS,
                                                    init_log_vars,
                                                    make_schedule,
                                                    uncertainty_weighted_total)

SPEED_DROPOUT = 0.15     # share of samples whose speed input is zeroed
# a step's draws, per micro-batch: lidar [B,N] uniforms (dropoff), and
# speed_drop [B] bool (True zeroes the sample's measured speed)
DRAW_KEYS = ("lidar", "speed_drop")

# normalized loss weights (train.py:384-456 defaults, all 1.0)
LOSS_WEIGHTS = dict(wp=1.0, checkpoint=1.0, target_speed=1.0, semantic=1.0,
                    bev_semantic=1.0, depth=1.0, center_heatmap=1.0,
                    wh=1.0, offset=1.0, yaw_class=1.0, yaw_res=1.0,
                    velocity=1.0, brake=1.0)


def frame_state(frames: Frames, f_idx: int) -> SimState:
  """The world of recorded frame f_idx (a host int) as a SimState the
  sensor renderers take: ego, vehicles (their brake as the control's third
  entry) and walkers, and the tick of the frame's clock, at which the
  lights render in their state."""
  take = lambda x: x[f_idx]
  B, V = frames.veh_yaw.shape[1:3]
  W = frames.wlk_yaw.shape[2]
  dev = frames.ego_pos.device
  zeros = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype,
                                                      device=dev)
  ego = EgoState(pos=take(frames.ego_pos), yaw=take(frames.ego_yaw),
                 speed=take(frames.ego_speed))
  brake = take(frames.veh_brake)
  veh = VehicleStates(
      pos=take(frames.veh_pos), yaw=take(frames.veh_yaw),
      speed=take(frames.veh_speed), extent=take(frames.veh_extent),
      valid=take(frames.veh_valid),
      control=torch.stack([zeros(B, V), zeros(B, V), brake], -1),
      buf_vel=zeros(B, V, 1), buf_throttle=zeros(B, V, 1),
      buf_brake=zeros(B, V, 1), lane_id=zeros(B, V, dtype=torch.int32),
      lane_t=zeros(B, V), stand_ticks=zeros(B, V, dtype=torch.int32))
  wlk = WalkerStates(
      pos=take(frames.wlk_pos), yaw=take(frames.wlk_yaw),
      direction=zeros(B, W, 2), speed=take(frames.wlk_speed),
      extent=take(frames.wlk_extent), valid=take(frames.wlk_valid),
      seen_frames=zeros(B, W, dtype=torch.int32),
      active=zeros(B, W, dtype=torch.bool), walked_m=zeros(B, W))
  # the tick from the recorded time: lights render in their state at the
  # frame's clock
  t_s = take(frames.time_s)
  return SimState(tick=to_int32(torch.round(t_s * 20.0)),
                  done=zeros(B, dtype=torch.bool), ego=ego, vehicles=veh,
                  walkers=wlk, expert=None, criteria=None)


def render_frame_batch(cfg: GlobalConfig, maps, scene: Scene,
                       frames: Frames, f_idx: int, camera_grid, lidar_grid,
                       uniform: torch.Tensor | None = None,
                       generator: torch.Generator | None = None):
  """Render model inputs and labels for frame f_idx (a host int) across
  the batch: the live sensor renderers run on ``frame_state``. uniform
  [B,N]: the LiDAR dropoff draws, or None to draw them from
  `generator`."""
  snap = frame_state(frames, f_idx)
  ego, veh, wlk = snap.ego, snap.vehicles, snap.walkers
  B, V = veh.yaw.shape
  dev = ego.pos.device
  t_s = frames.time_s[f_idx]
  brake = frames.veh_brake[f_idx]
  zeros = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype,
                                                      device=dev)

  cam = render_camera(cfg, maps, scene, snap, camera_grid)
  pts, valid = render_lidar(cfg, maps, scene, snap, lidar_grid,
                            uniform=uniform, generator=generator)
  lidar_bev = voxelize(pts, valid, cfg).permute(0, 2, 3, 1)
  bev_sem = render_bev_semantics(cfg, maps, scene, snap)

  # detection candidates over the four CenterNet classes (vehicle 0,
  # walker 1, red or yellow traffic light 2, stop sign 3)
  lights, stops = scene.lights, scene.stops
  lstate = lights.state_at(t_s)
  l_ok = lights.valid & ((lstate == LightState.RED) |
                         (lstate == LightState.YELLOW))
  zl = torch.zeros_like(lights.yaw)
  zs = torch.zeros_like(stops.yaw)
  L, S = lights.yaw.shape[-1], stops.yaw.shape[-1]
  obj_pos = torch.cat([veh.pos, wlk.pos, lights.pos, stops.pos], 1)
  obj_yaw = torch.cat([veh.yaw, wlk.yaw, lights.yaw, stops.yaw], 1)
  obj_extent = torch.cat(
      [veh.extent, wlk.extent, lights.extent, stops.extent], 1)
  # LiDAR-visibility gate for vehicles and walkers (data.py:959-960): a
  # box needs more than 7 sweep points to be a detection label. The
  # points are in the ego frame; each point is tested against each box
  # without building the [B,D,N,2] offset tensor.
  dyn_pos = torch.cat([veh.pos, wlk.pos], 1)                   # [B,D,2]
  dyn_yaw = torch.cat([veh.yaw, wlk.yaw], 1)
  dyn_ext = torch.cat([veh.extent, wlk.extent], 1)
  rel_d = geo.world_to_ego(dyn_pos, ego.pos[:, None], ego.yaw[:, None])
  d0 = pts[:, None, :, 0] - rel_d[:, :, None, 0]                # [B,D,N]
  d1 = pts[:, None, :, 1] - rel_d[:, :, None, 1]
  cy = torch.cos(dyn_yaw - ego.yaw[:, None])[..., None]
  sy = torch.sin(dyn_yaw - ego.yaw[:, None])[..., None]
  lx = d0 * cy + d1 * sy
  ly = -d0 * sy + d1 * cy
  inside = (torch.abs(lx) <= dyn_ext[..., 0:1] + 0.1) & \
      (torch.abs(ly) <= dyn_ext[..., 1:2] + 0.1) & valid[:, None]
  seen = inside.sum(-1) > 7                                     # [B,D]
  obj_valid = torch.cat(
      [veh.valid & seen[:, :V], wlk.valid & seen[:, V:], l_ok, stops.valid],
      1)
  obj_speed = torch.cat([veh.speed, wlk.speed, zl, zs], 1)
  obj_brake = torch.cat([brake, torch.zeros_like(wlk.speed), zl, zs], 1)
  obj_cls = torch.cat([
      zeros(B, V, dtype=torch.int32), torch.ones_like(seen[:, V:],
                                                      dtype=torch.int32),
      torch.full((B, L), 2, dtype=torch.int32, device=dev),
      torch.full((B, S), 3, dtype=torch.int32, device=dev)], 1)

  return dict(rgb=cam["rgb"], semantic=cam["semantic"],
              depth=cam["depth"], lidar_bev=lidar_bev,
              bev_semantic=bev_sem,
              obj_pos=obj_pos, obj_yaw=obj_yaw, obj_extent=obj_extent,
              obj_valid=obj_valid, obj_speed=obj_speed,
              obj_brake=obj_brake, obj_cls=obj_cls,
              ego_pos=ego.pos, ego_yaw=ego.yaw, speed=ego.speed,
              target_point=frames.target_point[f_idx],
              command=frames.command[f_idx])


def centernet_targets(cfg: GlobalConfig, tcfg: TransfuserConfig, batch,
                      grid_hw: tuple):
  """CenterNet training targets on the BEV feature grid (data.py:698-791):
  every recorded object in the ego frame, gridded at the model's BEV
  stride. Returns a dict of [B,h,w,C] heatmaps and [B,K] box targets with
  their mask."""
  h, w = grid_hw
  sc = cfg.sensor
  ppm_grid = h / (sc.max_y - sc.min_y)          # cells per meter
  rel = geo.world_to_ego(batch["obj_pos"], batch["ego_pos"][:, None],
                         batch["ego_yaw"][:, None])
  ryaw = geo.normalize_angle(batch["obj_yaw"] - batch["ego_yaw"][:, None])
  cx = (rel[..., 0] - sc.min_x) * ppm_grid       # grid col
  cy = (rel[..., 1] - sc.min_y) * ppm_grid       # grid row
  inb = batch["obj_valid"] & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
  gw = batch["obj_extent"][..., 1] * 2 * ppm_grid
  gl = batch["obj_extent"][..., 0] * 2 * ppm_grid
  radius = torch.clamp(det.gaussian_radius(gw, gl), min=2.0)
  centers = torch.stack([cx, cy], -1)
  heat = det.splat_gaussian_heatmap(h, w, centers, radius, inb,
                                    batch["obj_cls"], tcfg.num_bb_classes)
  n_bins = tcfg.num_dir_bins
  angle_per = 2 * np.pi / n_bins
  yaw_pos = torch.remainder(ryaw, 2 * np.pi)
  yaw_cls = to_int32(torch.floor(yaw_pos / angle_per)) % n_bins
  yaw_res = yaw_pos - yaw_cls * angle_per
  return dict(heatmap=heat, center=centers, mask=inb,
              wh=torch.stack([gw, gl], -1),
              yaw_cls=yaw_cls, yaw_res=yaw_res,
              velocity=batch["obj_speed"], brake=batch["obj_brake"])


def mean_iou(pred_cls: torch.Tensor, label: torch.Tensor,
             num_classes: int, mesh=None) -> torch.Tensor:
  """Mean intersection-over-union over the classes present in the labels
  (train.py:822-843 semantic / BEV mIoU). mesh: the inputs are this
  rank's slice; each class's intersection, union and label counts are
  summed over the ranks, so every rank returns the global batch's mIoU."""
  counts = []
  for c in range(num_classes):
    p = pred_cls == c
    lab = label == c
    counts.append(torch.stack([torch.sum(p & lab), torch.sum(p | lab),
                               torch.sum(lab)]))
  inter, union, n_lab = mesh_lib.global_sum(mesh, torch.stack(counts)).T
  ious = inter / torch.clamp(union, min=1)
  present = n_lab > 0
  return torch.sum(torch.where(present, ious, 0.0)) / \
      torch.clamp(torch.sum(present), min=1)


def _forward(model: LidarCenterNet, params, batch):
  """The model's outputs in float32. params: None for the module's own
  parameters, else {name: tensor} (the bf16 casts) for functional_call."""
  args = (batch["rgb"], batch["lidar_bev"], batch["target_point"],
          batch["command_onehot"], batch["speed"])
  out = model(*args) if params is None else \
      torch.func.functional_call(model, params, args)
  return tree_map(lambda x: x.to(torch.float32), out)


def _losses(tcfg: TransfuserConfig, out, batch, log_vars=None,
            speed_weights=SPEED_WEIGHTS, mesh=None):
  # per-sample quality weights [B] (post-done frames weigh 0)
  sw = batch.get("sample_w")
  if sw is None:
    sw = torch.ones_like(batch["speed"])
  swn = torch.clamp(mesh_lib.global_sum(mesh, torch.sum(sw)), min=1e-6)

  def wmean(x):
    per = x.reshape(x.shape[0], -1).mean(1)
    return torch.sum(per * sw) / swn

  losses = {}
  losses["checkpoint"] = wmean(
      torch.abs(out["pred_checkpoint"] - batch["ckpt_label"]))
  losses["target_speed"] = cross_entropy(
      out["pred_target_speed"], batch["speed_label"],
      weights=speed_weights, label_smoothing=0.1, sample_weight=sw,
      mesh=mesh)
  if "pred_wp" in out:
    # wp_w 0 for DAgger frames: their future ego positions are the learned
    # policy's own trajectory, not expert waypoints
    losses["wp"] = wmean(torch.abs(out["pred_wp"] - batch["wp_label"])) * \
        batch.get("wp_w", 1.0)
  if "pred_semantic" in out:
    losses["semantic"] = cross_entropy(out["pred_semantic"],
                                       batch["semantic"], sample_weight=sw,
                                       mesh=mesh)
  if "pred_depth" in out:
    losses["depth"] = wmean(torch.abs(out["pred_depth"] -
                                      batch["depth_norm"]))
  if "pred_bev_semantic" in out:
    losses["bev_semantic"] = cross_entropy(
        out["pred_bev_semantic"], batch["bev_semantic_ds"],
        sample_weight=sw, mesh=mesh)
  if "pred_bb" in out:
    bb = out["pred_bb"]
    tgt = batch["centernet"]
    pred_heat = torch.sigmoid(bb["heatmap"])
    losses["center_heatmap"] = wmean(
        det.gaussian_focal_loss(pred_heat, tgt["heatmap"]))
    h, w = bb["wh"].shape[1:3]
    ix = torch.clamp(to_int32(tgt["center"][..., 0]), 0, w - 1)
    iy = torch.clamp(to_int32(tgt["center"][..., 1]), 0, h - 1)
    cell = (iy * w + ix).long()[..., None]                     # [B,K,1]

    def gather(m):
      flat = m.reshape(m.shape[0], h * w, -1)
      return torch.gather(flat, 1, cell.expand(-1, -1, flat.shape[-1]))

    mask = tgt["mask"] & (sw[:, None] > 0)
    n_mask = torch.clamp(mesh_lib.global_sum(
        mesh, torch.sum(mask.to(torch.float32))), min=1.0)
    losses["wh"] = l1_masked(gather(bb["wh"]), tgt["wh"], mask, mesh)
    off_t = tgt["center"] - torch.floor(tgt["center"])
    losses["offset"] = l1_masked(gather(bb["offset"]), off_t, mask, mesh)
    losses["yaw_res"] = l1_masked(gather(bb["yaw_res"])[..., 0],
                                  tgt["yaw_res"], mask, mesh)
    losses["velocity"] = l1_masked(gather(bb["velocity"])[..., 0],
                                   tgt["velocity"], mask, mesh)
    yc_logits = gather(bb["yaw_class"])
    yc = torch.sum(torch.where(
        mask[..., None], -torch.log_softmax(yc_logits, -1) *
        one_hot(tgt["yaw_cls"], yc_logits.shape[-1]), 0.0))
    losses["yaw_class"] = yc / n_mask
    br_logits = gather(bb["brake"])
    br_lab = (tgt["brake"] > 0.5).to(torch.int32)
    br = torch.sum(torch.where(
        mask[..., None], -torch.log_softmax(br_logits, -1) *
        one_hot(br_lab, 2), 0.0))
    losses["brake"] = br / n_mask

  if log_vars is not None:
    # Kendall learned multi-task weighting (train.py:384-456)
    total = uncertainty_weighted_total(losses, log_vars, mesh)
  else:
    total = sum(LOSS_WEIGHTS[k] * v for k, v in losses.items())
  aux = {f"loss_{k}": v for k, v in losses.items()}
  aux["loss"] = total
  return total, aux


def transfuser_loss(cfg: GlobalConfig, tcfg: TransfuserConfig,
                    model: LidarCenterNet, params, batch, log_vars=None,
                    speed_weights=SPEED_WEIGHTS, mesh=None):
  """(total, aux) of one batch. params: None to run the module's own
  parameters, or {name: tensor} for ``torch.func.functional_call``;
  log_vars: {loss key: scalar} for Kendall weighting, else fixed
  LOSS_WEIGHTS. mesh: the batch is this rank's slice, and the losses its
  shares of the global losses."""
  return _losses(tcfg, _forward(model, params, batch), batch,
                 log_vars=log_vars, speed_weights=speed_weights, mesh=mesh)


def make_train_batch(cfg: GlobalConfig, tcfg: TransfuserConfig, maps,
                     scene: Scene, frames: Frames, f_idx: int, camera_grid,
                     lidar_grid, draws: dict,
                     generator: torch.Generator | None = None,
                     bf16: bool = False) -> dict:
  """One micro-batch: frame f_idx (a host int) of every episode, rendered,
  with its labels and CenterNet targets. draws: the keys of DRAW_KEYS
  (each drawn from `generator` when missing)."""
  unknown = set(draws) - set(DRAW_KEYS)
  if unknown:
    raise KeyError(f"unknown draws {sorted(unknown)}; known: {DRAW_KEYS}")
  r = render_frame_batch(cfg, maps, scene, frames, f_idx, camera_grid,
                         lidar_grid, uniform=draws.get("lidar"),
                         generator=generator)
  batch = dict(r)
  # speed-input dropout: the model must not learn "speed 0 => brake"
  drop = draws.get("speed_drop")
  if drop is None:
    drop = torch.rand(r["speed"].shape, generator=generator,
                      device=r["speed"].device) < SPEED_DROPOUT
  batch["speed"] = torch.where(drop, 0.0, r["speed"])
  batch["depth_norm"] = r["depth"] / 85.0
  batch["command_onehot"] = command_onehot(r["command"])
  batch["wp_label"] = waypoint_labels(frames)[0][f_idx]
  batch["ckpt_label"] = checkpoint_labels(
      frames, scene, tcfg.checkpoint_len)[f_idx]
  # brake_lookahead=2 frames (0.5 s at the 4 Hz save rate)
  batch["speed_label"] = target_speed_labels(
      frames, cfg, brake_lookahead=2)[f_idx]
  # label stride: rendered BEV resolution -> the BEV-semantic head's size
  bev_ds = cfg.sensor.lidar_resolution_height // tcfg.lidar_h
  batch["bev_semantic_ds"] = r["bev_semantic"][
      :, ::bev_ds, ::bev_ds].to(torch.int32)
  # detection grid = BEV feature grid at stride 4 (the reference's
  # top_down output, bev_down_sample_factor=4)
  batch["centernet"] = centernet_targets(
      cfg, tcfg, batch, (tcfg.lidar_h // 4, tcfg.lidar_w // 4))
  batch["sample_w"] = frames.alive[f_idx].to(torch.float32)
  if bf16:
    for k in ("rgb", "lidar_bev"):
      batch[k] = batch[k].to(torch.bfloat16)
  return batch


def make_transfuser_train_step(cfg: GlobalConfig, tcfg: TransfuserConfig,
                               model: LidarCenterNet,
                               optimizer: torch.optim.Optimizer, maps, scene,
                               frames: Frames, camera_grid, lidar_grid,
                               log_vars: dict | None = None,
                               bf16: bool = False,
                               speed_weights=SPEED_WEIGHTS,
                               clip_norm: float | None = None,
                               scheduler=None, mesh=None):
  """Returns (train_step, eval_step, wp_valid).

  train_step(f_idx, draws=None, generator=None, data=None, wp_w=1.0)
  renders every frame index of f_idx (host ints) as one micro-batch of all
  episodes, accumulates the mean of their gradients, clips them to
  `clip_norm` (global norm) when given, steps the optimizer and the
  scheduler, and returns the micro-batches' mean aux losses as device
  tensors. draws: one dict per index with the keys of DRAW_KEYS, or None
  to draw from `generator`. data: the dataset (maps, scene, frames) to
  render from, or None for the one given here; one optimizer carries
  across datasets, as the training script's block scheduling and DAgger
  rounds need. wp_w scales the waypoint loss of a model with a waypoint
  head (0 on DAgger frames).

  eval_step(f_idx, draws=None, generator=None, data=None, wp_w=1.0)
  renders the indices as one batch and returns the validation losses, the
  semantic and BEV mIoU, the [4,4] speed-class confusion (label,
  prediction) and the checkpoint angle error in degrees
  (train.py:822-843).

  wp_valid is the waypoint-label mask of the dataset given here.
  log_vars: Kendall log-variances ({loss key: parameter}, in the
  optimizer) or None for fixed weights. bf16: the forward and backward
  run in bfloat16 on bfloat16 casts of the float32 parameters.

  mesh: data parallel over its ranks. The data (here and per call) and
  the draws are the global batch's; each rank renders its slice of the
  episodes, the step sums the gradients over the ranks before the clip,
  and the aux losses it returns are the global ones. Without draws, every
  rank draws the global batch's from `generator` (seed it alike on every
  rank) in the order one process draws them, and keeps its slice.
  eval_step likewise returns the global batch's losses, mIoU, confusion
  and checkpoint angle error on every rank: its counts are summed over
  the ranks before any division."""
  _, wp_valid = waypoint_labels(frames)
  dev = next(model.parameters()).device
  cam_grid = torch.as_tensor(camera_grid, device=dev)
  lid_grid = torch.as_tensor(lidar_grid, device=dev).reshape(-1, 3)
  opt_params = [p for g in optimizer.param_groups for p in g["params"]]

  def shard(data):
    """(maps, the rank's episodes of scene and frames, global batch)."""
    maps_, scene_, frames_ = data
    n = scene_.route.num_valid.shape[0]
    if mesh is None:
      return data, n
    return (maps_, mesh_lib.shard_leading(mesh, scene_, n),
            mesh_lib.shard_leading(mesh, frames_, n, dim=1)), n

  default_data = shard((maps, scene, frames))

  def cast_params():
    if not bf16:
      return None
    return {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}

  def step_draws(k, draws, generator, n):
    """Micro-batch k's draws: the given ones, or (under a mesh) the global
    batch's drawn as one process draws them; then the rank's slice."""
    d = {} if draws is None else draws[k]
    if mesh is None:
      return d
    if draws is None:
      d = {"lidar": torch.rand((n, lid_grid.shape[0]), generator=generator,
                               device=dev)}
      d["speed_drop"] = torch.rand((n,), generator=generator,
                                   device=dev) < SPEED_DROPOUT
    return mesh_lib.shard_leading(mesh, d, n)

  def batch(f_idx, k, draws, generator, data):
    (maps_, scene_, frames_), n = default_data if data is None else \
        shard(data)
    return make_train_batch(cfg, tcfg, maps_, scene_, frames_,
                            int(f_idx[k]), cam_grid, lid_grid,
                            step_draws(k, draws, generator, n),
                            generator=generator, bf16=bf16)

  def train_step(f_idx, draws=None, generator=None, data=None, wp_w=1.0):
    K = len(f_idx)
    optimizer.zero_grad(set_to_none=True)
    acc = {}
    for k in range(K):
      b = batch(f_idx, k, draws, generator, data)
      b["wp_w"] = wp_w
      loss, aux = transfuser_loss(cfg, tcfg, model, cast_params(), b,
                                  log_vars=log_vars,
                                  speed_weights=speed_weights, mesh=mesh)
      (loss / K).backward()
      for name, v in aux.items():
        acc[name] = acc.get(name, 0.0) + v.detach() / K
    if mesh is not None:
      mesh_lib.all_reduce_grads(mesh, opt_params)
      acc = mesh_lib.all_reduce_aux(mesh, acc)
    if clip_norm is not None:
      torch.nn.utils.clip_grad_norm_(opt_params, clip_norm)
    optimizer.step()
    if scheduler is not None:
      scheduler.step()
    return acc

  @torch.no_grad()
  def eval_step(f_idx, draws=None, generator=None, data=None, wp_w=1.0):
    b = tree_map(lambda *xs: torch.cat(xs),
                 *[batch(f_idx, k, draws, generator, data)
                   for k in range(len(f_idx))])
    b["wp_w"] = wp_w
    out = _forward(model, cast_params(), b)
    _, aux = _losses(tcfg, out, b, speed_weights=speed_weights, mesh=mesh)
    aux = mesh_lib.all_reduce_aux(mesh, aux)
    if "pred_semantic" in out:
      aux["miou_semantic"] = mean_iou(
          torch.argmax(out["pred_semantic"], -1), b["semantic"],
          cfg.sensor.num_semantic_classes, mesh)
    if "pred_bev_semantic" in out:
      aux["miou_bev_semantic"] = mean_iou(
          torch.argmax(out["pred_bev_semantic"], -1),
          b["bev_semantic_ds"], cfg.sensor.num_bev_semantic_classes, mesh)
    # open-loop diagnosis: the speed-class confusion (brake recall is the
    # missed-hazard knob) and the direct controller's steering input, the
    # angle of checkpoint 2, as an error against the label
    sw = b["sample_w"] > 0
    pred_cls = torch.argmax(out["pred_target_speed"], -1)
    lab = b["speed_label"].long()
    aux["confusion"] = mesh_lib.global_sum(mesh, torch.zeros(
        (4, 4), dtype=torch.int32, device=dev).index_put_(
            (lab, pred_cls), sw.to(torch.int32), accumulate=True))
    ang = lambda a: torch.rad2deg(torch.atan2(a[..., 1], a[..., 0]))
    d_ang = torch.abs(geo.normalize_angle(torch.deg2rad(
        ang(out["pred_checkpoint"][:, 2]) - ang(b["ckpt_label"][:, 2]))))
    err_sum = mesh_lib.global_sum(mesh, torch.sum(torch.where(sw, d_ang,
                                                              0.0)))
    n_sw = mesh_lib.global_sum(mesh, torch.sum(sw))
    aux["ckpt_angle_mae_deg"] = torch.rad2deg(err_sum /
                                              torch.clamp(n_sw, min=1))
    return aux

  return train_step, eval_step, wp_valid


def trainable_params(model: LidarCenterNet,
                     freeze_backbone: bool = False) -> list:
  """The parameters an optimizer updates. freeze_backbone leaves the image
  branch (parameters whose name holds ``image_``) out of the list and out
  of autograd, as optax's ``set_to_zero`` leaves them unchanged."""
  params = []
  for name, p in model.named_parameters():
    frozen = freeze_backbone and "image_" in name
    p.requires_grad_(not frozen)
    if not frozen:
      params.append(p)
  return params


def make_optimizer(model: LidarCenterNet, lr: float, steps: int,
                   schedule: str | None = "multistep",
                   freeze_backbone: bool = False,
                   log_vars: dict | None = None, mesh=None):
  """optax ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, weight decay 0.01 on
  every trainable parameter, the Kendall log-variances included) as
  ``torch.optim.AdamW`` with a LambdaLR schedule (train/schedules.py).
  mesh: the AdamW state is sharded over its ranks (ZeRO-1,
  ``ZeroRedundancyOptimizer``). Returns (optimizer, scheduler)."""
  params = trainable_params(model, freeze_backbone) + \
      list((log_vars or {}).values())
  adamw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
  opt = torch.optim.AdamW(params, **adamw) if mesh is None else \
      mesh_lib.zero1_optimizer(mesh, params, **adamw)
  sched = torch.optim.lr_scheduler.LambdaLR(opt,
                                            make_schedule(schedule, steps))
  return opt, sched


def train_transfuser(cfg: GlobalConfig, tcfg: TransfuserConfig, maps, scene,
                     frames: Frames, camera_grid, lidar_grid,
                     steps: int = 100, lr: float = 3e-4, seed: int = 0,
                     model: LidarCenterNet | None = None,
                     log_every: int = 50, freeze_backbone: bool = False,
                     schedule: str | None = "multistep",
                     learn_loss_weights: bool = False,
                     val_fraction: float = 0.1, bf16: bool = False,
                     frames_per_step: int = 2):
  """Training loop over collected frames on the device of `maps`.

  model: a LidarCenterNet to train in place, or None for one initialized
  from `seed`. Frame indices are drawn with numpy from `seed` among the
  frames with valid waypoint labels, minus a held-out validation share;
  the draws come from a generator on that device seeded from `seed`.
  freeze_backbone freezes the image branch (two-stage training);
  learn_loss_weights enables Kendall weighting. Returns (model, history):
  history holds the aux losses of every log_every-th step and the last,
  the last one with the validation losses and mIoU (``val_*``)."""
  dev = maps.layers.device
  if model is None:
    with torch.random.fork_rng(devices=[]):
      torch.manual_seed(seed)
      model = LidarCenterNet(tcfg)
  model = model.to(dev)
  generator = torch.Generator(device=dev).manual_seed(seed)
  log_vars = init_log_vars(tuple(LOSS_WEIGHTS), dev) \
      if learn_loss_weights else None
  opt, sched = make_optimizer(model, lr, steps, schedule, freeze_backbone,
                              log_vars)
  step_fn, eval_fn, wp_valid = make_transfuser_train_step(
      cfg, tcfg, model, opt, maps, scene, frames, camera_grid, lidar_grid,
      log_vars=log_vars, bf16=bf16, scheduler=sched)
  np_rng = np.random.default_rng(seed)
  usable = np.nonzero(wp_valid.cpu().numpy().any(-1))[0]
  n_val = int(len(usable) * val_fraction)
  val_idx = usable[len(usable) - n_val:] if n_val else None
  usable = usable[:len(usable) - n_val] if n_val else usable
  history = []
  for i in range(steps):
    f_idx = np_rng.choice(usable, size=frames_per_step).tolist()
    aux = step_fn(f_idx, generator=generator)
    if i % log_every == 0 or i == steps - 1:
      history.append({k: float(v) for k, v in aux.items()})
  if val_idx is not None and len(val_idx) and history:
    sums, n = {}, 0
    for j in range(0, min(len(val_idx), 8), 2):
      aux = eval_fn(val_idx[j:j + 2].tolist(), generator=generator)
      for k, v in aux.items():
        if v.ndim == 0:           # the confusion matrix is left out
          sums[k] = sums.get(k, 0.0) + float(v)
      n += 1
    history[-1].update({f"val_{k}": v / max(n, 1) for k, v in sums.items()})
  return model, history
