"""PlanT imitation learning on the device (port of
carla_garage_tpu/train/plant_train.py).

Samples come from recorded expert (or DAgger) frames (``sim/datagen.py``)
and stay on the device as tensors: object boxes are the nearest
vehicles, walkers, red or yellow lights and stop signs in the ego frame,
zero-padded (type VEHICLE) to max_objects; route tokens are
num_route_points points of the dense route at 2 m spacing; the hazard
flags are the expert's; forecast labels are the attributes 0.5 s ahead,
quantized (data.py:1017-1051).

Losses follow plant.py:311-342: L1 waypoints (weighted per sample), the
class-weighted, label-smoothed cross entropy of the target speed, L1
checkpoints and the mean cross entropy of the 7 forecast heads, ignoring
unlabelled objects. The speed-class weights are an explicit argument
(the JAX package rebinds a module global).

The batch order and the velocity dropout come from a host
``np.random.default_rng(seed)`` drawn in the JAX loop's order, so one
seed gives the JAX package's batches exactly. Each epoch's order and
dropout mask go to the device once, through pinned memory, so a train
step makes no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

from carla_garage_tpu_torch.agents.plant_agent import OBJECT_RANGE_M
from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.models.plant import ObjType, PlanT, PlanTConfig
from carla_garage_tpu_torch.ops.losses import cross_entropy
from carla_garage_tpu_torch.parallel import mesh as mesh_lib
from carla_garage_tpu_torch.sim import geometry as geo
from carla_garage_tpu_torch.sim.datagen import (Frames, checkpoint_labels,
                                                target_speed_labels,
                                                waypoint_labels)
from carla_garage_tpu_torch.structs import LightState, Scene
from carla_garage_tpu_torch.train.schedules import (SPEED_WEIGHTS,
                                                    init_log_vars,
                                                    uncertainty_weighted_total)
from carla_garage_tpu_torch.train.transfuser_train import make_optimizer
from carla_garage_tpu_torch.utils.profiling import span

IGNORE_INDEX = -999
FORECAST_FRAMES = 2       # 0.5 s at 4 Hz (config.py:544 forcast_time)
VELOCITY_DROPOUT = 0.15   # share of training samples whose speed is zeroed
LOSS_KEYS = ("wp", "speed", "ckpt", "forecast")


@dataclasses.dataclass
class PlantDataset:
  """Flattened [N,...] training tensors on one device."""
  boxes: torch.Tensor           # [N,O,7]
  box_types: torch.Tensor       # [N,O] int32
  route: torch.Tensor           # [N,R,2]
  light: torch.Tensor           # [N]
  stop: torch.Tensor            # [N]
  junction: torch.Tensor        # [N]
  velocity: torch.Tensor        # [N]
  target_point: torch.Tensor    # [N,2] (PID-side, not a net input)
  wp_label: torch.Tensor        # [N,pred_len,2]
  speed_label: torch.Tensor     # [N] int32
  ckpt_label: torch.Tensor      # [N,R,2]
  forecast_label: torch.Tensor  # [N,O,7] int32 (IGNORE_INDEX = no label)
  # per-sample waypoint-loss weight (None = all ones). DAgger frames carry
  # 0: their recorded trajectory is the policy's own, so the future-ego
  # waypoint label is wrong at the states DAgger exists to correct; the
  # route-relative labels (speed class, checkpoints, forecast) stay valid.
  wp_weight: torch.Tensor | None = None

  def __len__(self):
    return self.boxes.shape[0]


BATCH_KEYS = ("boxes", "box_types", "route", "light", "stop", "junction",
              "velocity", "target_point", "wp_label", "speed_label",
              "ckpt_label", "forecast_label", "wp_weight")


def quantize_attrs(cfg: GlobalConfig, pcfg: PlanTConfig,
                   attrs: torch.Tensor) -> torch.Tensor:
  """data.py:1017-1051 quantize_box over [...,7] attributes -> int32 bins
  (round half to even, as ``jnp.round``)."""
  sc = cfg.sensor
  x = (attrs[..., 0] + sc.max_x) / (sc.max_x - sc.min_x)
  y = (attrs[..., 1] + sc.max_y) / (sc.max_y - sc.min_y)
  ex = attrs[..., 2] / 30.0
  ey = attrs[..., 3] / 30.0
  yaw = (attrs[..., 4] + torch.pi) / (2 * torch.pi)
  speed = attrs[..., 5] / (60.0 / 3.6)     # plant_max_speed_pred km/h->m/s
  brake = attrs[..., 6]
  norm = torch.clamp(torch.stack([x, y, ex, ey, yaw, speed, brake], -1),
                     0.0, 1.0)
  sizes = torch.tensor(pcfg.vocab_sizes, dtype=torch.float32,
                       device=attrs.device)
  return torch.round(norm * (sizes - 1)).to(torch.int32)


def _object_candidates(cfg: GlobalConfig, frames: Frames, scene: Scene):
  """All candidate object tokens per frame (vehicles, walkers, red or
  yellow lights, stop signs): ego-frame attributes [F,B,C,7], their
  attributes 0.5 s ahead (vehicles and walkers), types, validity within
  32 m, forecast validity and distance."""
  F, B = frames.ego_yaw.shape
  ego_pos, ego_yaw = frames.ego_pos, frames.ego_yaw

  def rel_attrs(pos, yaw, extent, speed, brake):
    rel = geo.world_to_ego(pos, ego_pos[:, :, None], ego_yaw[:, :, None])
    ryaw = geo.normalize_angle(yaw - ego_yaw[:, :, None])
    return torch.stack([rel[..., 0], rel[..., 1], extent[..., 0],
                        extent[..., 1], ryaw, speed, brake], -1)

  def shift2(x):
    return torch.roll(x, -FORECAST_FRAMES, 0)

  v_attr = rel_attrs(frames.veh_pos, frames.veh_yaw, frames.veh_extent,
                     frames.veh_speed, frames.veh_brake)
  v_fut = rel_attrs(shift2(frames.veh_pos), shift2(frames.veh_yaw),
                    frames.veh_extent, shift2(frames.veh_speed),
                    shift2(frames.veh_brake))
  v_fc_ok = frames.veh_valid & shift2(frames.veh_valid)
  zw = torch.zeros_like(frames.wlk_speed)
  w_attr = rel_attrs(frames.wlk_pos, frames.wlk_yaw, frames.wlk_extent,
                     frames.wlk_speed, zw)
  w_fut = rel_attrs(shift2(frames.wlk_pos), shift2(frames.wlk_yaw),
                    frames.wlk_extent, shift2(frames.wlk_speed), zw)
  w_fc_ok = frames.wlk_valid & shift2(frames.wlk_valid)

  lights, stops = scene.lights, scene.stops
  lstate = lights.state_at(frames.time_s)                  # [F,B,L]
  l_red = (lstate == LightState.RED) | (lstate == LightState.YELLOW)
  ex = lambda x: x[None].expand((F,) + x.shape)
  zl = torch.zeros(l_red.shape, device=l_red.device)
  l_attr = rel_attrs(ex(lights.pos), ex(lights.yaw), ex(lights.extent), zl,
                     zl)
  l_ok = ex(lights.valid) & l_red
  zs = torch.zeros((F,) + stops.yaw.shape, device=l_red.device)
  s_attr = rel_attrs(ex(stops.pos), ex(stops.yaw), ex(stops.extent), zs, zs)
  s_ok = ex(stops.valid)

  attrs = torch.cat([v_attr, w_attr, l_attr, s_attr], 2)
  fut = torch.cat([v_fut, w_fut, torch.zeros_like(l_attr),
                   torch.zeros_like(s_attr)], 2)
  full = lambda n, t: torch.full((F, B, n), t, dtype=torch.int32,
                                 device=attrs.device)
  types = torch.cat([full(frames.veh_yaw.shape[-1], ObjType.VEHICLE),
                     full(frames.wlk_yaw.shape[-1], ObjType.WALKER),
                     full(lights.yaw.shape[-1], ObjType.LIGHT),
                     full(stops.yaw.shape[-1], ObjType.STOP)], 2)
  valid = torch.cat([frames.veh_valid, frames.wlk_valid, l_ok, s_ok], 2)
  fc_ok = torch.cat([v_fc_ok, w_fc_ok, torch.zeros_like(l_ok),
                     torch.zeros_like(s_ok)], 2)
  d = torch.linalg.vector_norm(attrs[..., :2], dim=-1)
  valid = valid & (d < OBJECT_RANGE_M)
  return attrs, fut, types, valid, fc_ok, d


def build_plant_samples(cfg: GlobalConfig, pcfg: PlanTConfig,
                        frames: Frames, scene: Scene) -> dict:
  """Frames [F,B,...] -> per-frame model inputs and forecast labels
  [F,B,...]. Objects go nearest first into max_objects slots; equal
  distances keep slot order (a stable sort, as ``jnp.argsort``)."""
  F, B = frames.ego_yaw.shape
  attrs, fut, types, valid, fc_ok, d = _object_candidates(cfg, frames,
                                                          scene)
  order = torch.argsort(torch.where(valid, d, torch.inf), dim=-1,
                        stable=True)[..., :pcfg.max_objects]

  def g(x):
    if x.ndim == 4:                       # [F,B,C,k]
      return torch.gather(x, 2, order[..., None].expand(-1, -1, -1,
                                                        x.shape[-1]))
    return torch.gather(x, 2, order)

  sel_valid = g(valid)
  sel_fc = g(fc_ok) & sel_valid
  boxes = torch.where(sel_valid[..., None], g(attrs), 0.0)
  box_types = torch.where(sel_valid, g(types), ObjType.VEHICLE)
  forecast = torch.where(sel_fc[..., None],
                         quantize_attrs(cfg, pcfg, g(fut)), IGNORE_INDEX)

  R = scene.route.points.shape[1]
  offs = torch.arange(pcfg.num_route_points, device=d.device) * 2
  q = (frames.dense_idx.long()[..., None] + offs).clamp(0, R - 1)
  pts = torch.gather(scene.route.points[None].expand(F, B, R, 2), 2,
                     q[..., None].expand(-1, -1, -1, 2))
  route = geo.world_to_ego(pts, frames.ego_pos[:, :, None],
                           frames.ego_yaw[:, :, None])
  return dict(boxes=boxes, box_types=box_types.to(torch.int32),
              route=route, light=frames.light_hazard,
              stop=frames.stop_hazard,
              junction=frames.junction.to(torch.float32),
              velocity=frames.ego_speed,
              forecast_label=forecast.to(torch.int32))


def build_plant_dataset(cfg: GlobalConfig, pcfg: PlanTConfig,
                        frames: Frames, scene: Scene) -> PlantDataset:
  """Frames [F,B,...] -> the flattened samples with valid waypoint labels,
  on the frames' device (the mask's count is read once, on the host)."""
  s = build_plant_samples(cfg, pcfg, frames, scene)
  wp, wp_valid = waypoint_labels(frames)
  keep = wp_valid.reshape(-1)

  def flat(x):
    return x.reshape((-1,) + x.shape[2:])[keep]

  return PlantDataset(
      boxes=flat(s["boxes"]), box_types=flat(s["box_types"]),
      route=flat(s["route"]), light=flat(s["light"]), stop=flat(s["stop"]),
      junction=flat(s["junction"]), velocity=flat(s["velocity"]),
      target_point=flat(frames.target_point), wp_label=flat(wp),
      speed_label=flat(target_speed_labels(frames, cfg,
                                           brake_lookahead=2)),
      ckpt_label=flat(checkpoint_labels(frames, scene,
                                        pcfg.num_route_points)),
      forecast_label=flat(s["forecast_label"]))


def _apply(model: PlanT, batch):
  return model(batch["boxes"], batch["box_types"], batch["route"],
               batch["light"], batch["stop"], batch["junction"],
               batch["velocity"])


def plant_loss(model: PlanT, batch, log_vars=None,
               speed_weights=SPEED_WEIGHTS, mesh=None):
  """(total, aux) of one batch with the model's own parameters. log_vars:
  {loss key: scalar} switches the unit weights to Kendall's learned
  weighting (train.py:384-456). mesh: the batch is this rank's slice of
  the rows, and the losses its shares of the global losses (the
  denominators summed over the ranks)."""
  out = _apply(model, batch)
  wp_err = torch.mean(torch.abs(out["pred_wp"] - batch["wp_label"]), (1, 2))
  ww = batch.get("wp_weight")
  wp_loss = mesh_lib.share_mean(mesh, wp_err) if ww is None else \
      torch.sum(wp_err * ww) / torch.clamp(
          mesh_lib.global_sum(mesh, torch.sum(ww)), min=1.0)
  losses = {
      "wp": wp_loss,
      "speed": cross_entropy(out["pred_target_speed"], batch["speed_label"],
                             weights=speed_weights, label_smoothing=0.1,
                             mesh=mesh),
      "ckpt": mesh_lib.share_mean(mesh, torch.abs(out["pred_checkpoint"] -
                                                  batch["ckpt_label"])),
  }
  fc_total = 0.0
  for i, logits in enumerate(out["pred_forecast"]):
    lab = batch["forecast_label"][..., i]
    ok = lab != IGNORE_INDEX
    lab_safe = torch.clamp(lab, 0, logits.shape[-1] - 1).long()
    ce = -torch.gather(torch.log_softmax(logits, -1), -1,
                       lab_safe[..., None])[..., 0]
    fc_total = fc_total + torch.sum(torch.where(ok, ce, 0.0)) / \
        torch.clamp(mesh_lib.global_sum(mesh, torch.sum(ok)),
                    min=1).to(ce.dtype)
  losses["forecast"] = fc_total / len(out["pred_forecast"])
  if log_vars is not None:
    loss = uncertainty_weighted_total(losses, log_vars, mesh)
  else:
    loss = sum(losses.values())
  aux = {f"loss_{k}": v for k, v in losses.items()}
  aux["loss"] = loss
  return loss, aux


def make_train_step(model: PlanT, optimizer: torch.optim.Optimizer,
                    scheduler=None, log_vars: dict | None = None,
                    speed_weights=SPEED_WEIGHTS, mesh=None):
  """train_step(batch) -> aux losses as device tensors: one gradient step
  on the batch, then the scheduler's step. log_vars: Kendall
  log-variances (in the optimizer) or None for unit weights. No host sync
  without a mesh.

  mesh: data parallel over its ranks. The batch is the global one, as on
  one process; each rank takes its slice of the rows, the gradients are
  summed over the ranks before the step, and the aux losses returned are
  the global ones.

  The step is the span ``train.step`` (``utils/profiling.py``) around
  ``train.forward`` (the loss), ``train.backward`` and ``train.optimizer``
  (the optimizer's and the scheduler's steps)."""
  params = [p for g in optimizer.param_groups for p in g["params"]]

  def train_step(batch):
    with span("train.step"):
      optimizer.zero_grad(set_to_none=True)
      if mesh is not None:
        batch = mesh_lib.shard_leading(mesh, batch, batch["boxes"].shape[0])
      with span("train.forward"):
        loss, aux = plant_loss(model, batch, log_vars=log_vars,
                               speed_weights=speed_weights, mesh=mesh)
      with span("train.backward"):
        loss.backward()
      if mesh is not None:
        mesh_lib.all_reduce_grads(mesh, params)
        aux = mesh_lib.all_reduce_aux(mesh, aux)
      with span("train.optimizer"):
        optimizer.step()
        if scheduler is not None:
          scheduler.step()
      return {k: v.detach() for k, v in aux.items()}

  return train_step


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
  """A host array on `dev` without waiting for the device: through pinned
  memory and a non-blocking copy on a card."""
  t = torch.from_numpy(a)
  if dev.type == "cuda":
    return t.pin_memory().to(dev, non_blocking=True)
  return t.to(dev)


def iterate_minibatches(ds: PlantDataset, batch_size: int,
                        rng: np.random.Generator, epochs: int = 1,
                        velocity_dropout: float = 0.0) -> Iterator[dict]:
  """Shuffled batches of the dataset, on its device, in the JAX loop's
  order: per epoch one ``rng.permutation(n)``, then per batch (when
  velocity_dropout > 0) ``rng.random(batch_size)`` to pick the samples
  whose speed is zeroed. Without the dropout the model learns the
  shortcut 'speed 0 => brake' and never launches from standstill.

  Raises ValueError when the dataset holds fewer samples than a batch
  (the JAX loop would spin through empty epochs)."""
  n = len(ds)
  if n < batch_size:
    raise ValueError(f"the dataset holds {n} samples, fewer than one batch "
                     f"of {batch_size}")
  dev = ds.boxes.device
  nb = n // batch_size
  for _ in range(epochs):
    order = rng.permutation(n)
    # the epoch's draws in the order the JAX loop takes them
    drop = rng.random((nb, batch_size)) < velocity_dropout \
        if velocity_dropout > 0 else None
    order_d = _to_device(order[:nb * batch_size], dev)
    drop_d = _to_device(drop, dev) if drop is not None else None
    for i in range(nb):
      sel = order_d[i * batch_size:(i + 1) * batch_size]
      batch = {k: getattr(ds, k)[sel] for k in BATCH_KEYS
               if getattr(ds, k) is not None}
      if drop_d is not None:
        batch["velocity"] = torch.where(drop_d[i], 0.0, batch["velocity"])
      yield batch


@torch.no_grad()
def relabel_with_plant(model: PlanT, ds: PlantDataset,
                       batch_size: int = 256) -> PlantDataset:
  """Replace the expert's waypoint and speed labels with the predictions of
  PlanT's own weights (the offline relabelling of
  team_code/relabel_dataset.py, use_plant_labels). Samples past the last
  whole batch keep their labels."""
  n = (len(ds) // batch_size) * batch_size
  wp = ds.wp_label.clone()
  sp = ds.speed_label.clone()
  for i in range(0, n, batch_size):
    sl = slice(i, i + batch_size)
    out = _apply(model, {k: getattr(ds, k)[sl] for k in BATCH_KEYS
                         if getattr(ds, k) is not None})
    wp[sl] = out["pred_wp"][:, :wp.shape[1]]
    sp[sl] = torch.argmax(out["pred_target_speed"], -1).to(sp.dtype)
  return dataclasses.replace(ds, wp_label=wp, speed_label=sp)


def estimate_speed_weights(ds: PlantDataset):
  """Inverse-frequency target-speed class weights of the dataset
  (estimate_class_distributions, config.py:154) as a tuple of floats."""
  counts = torch.bincount(ds.speed_label.long(), minlength=4).cpu().double()
  counts = torch.clamp(counts, min=1.0)
  return tuple((len(ds) / (4.0 * counts)).tolist())


def _split_dataset(ds: PlantDataset, val_fraction: float):
  n_val = int(len(ds) * val_fraction)
  if n_val == 0:
    return ds, None

  def take(sl):
    return PlantDataset(**{
        f.name: (getattr(ds, f.name)[sl]
                 if getattr(ds, f.name) is not None else None)
        for f in dataclasses.fields(PlantDataset)})
  return take(slice(0, len(ds) - n_val)), take(slice(len(ds) - n_val,
                                                    len(ds)))


class PlantTrainer(NamedTuple):
  """What ``train_plant`` drives: the model; ``step()``, one step on the
  next batch, returning its aux losses as device tensors without a host
  sync; ``validate()``, the validation losses of the held-out split ({}
  without one)."""
  model: PlanT
  step: Callable[[], dict]
  validate: Callable[[], dict]


def plant_trainer(cfg: GlobalConfig, pcfg: PlanTConfig, ds: PlantDataset,
                  steps: int = 500, batch_size: int = 64, lr: float = 3e-4,
                  seed: int = 0, params=None,
                  estimate_weights: bool = False,
                  schedule: str | None = "multistep",
                  learn_loss_weights: bool = False,
                  val_fraction: float = 0.1,
                  speed_weights=SPEED_WEIGHTS) -> PlantTrainer:
  """The set-up of the training loop (train.py:643-996) on the dataset's
  device: the LR schedule over `steps`, optional Kendall weighting,
  AdamW (``transfuser_train.make_optimizer``, as optax's adamw with
  weight decay 0.01), the velocity dropout of VELOCITY_DROPOUT and the
  held-out validation split (train.py:822-843). params: None for a model
  initialized from `seed`, or a state dict to start from.
  estimate_weights: the speed-class weights from the dataset's class
  counts instead of `speed_weights` (config.py's by default; the training
  scripts carry a first segment's estimate into the later ones, as the
  JAX package's rebound module global does)."""
  dev = ds.boxes.device
  if estimate_weights:
    speed_weights = estimate_speed_weights(ds)
  rng = np.random.default_rng(seed)
  train_ds, val_ds = _split_dataset(ds, val_fraction)
  with torch.random.fork_rng(devices=[]):
    torch.manual_seed(seed)
    model = PlanT(pcfg)
  model = model.to(dev)
  if params is None:
    # the JAX loop draws an example batch to initialize from: one
    # permutation, taken here too so that the batches stay in step
    rng.permutation(len(train_ds))
  else:
    model.load_state_dict(params)
  log_vars = init_log_vars(LOSS_KEYS, dev) if learn_loss_weights else None
  opt, sched = make_optimizer(model, lr, steps, schedule,
                              log_vars=log_vars)
  step_fn = make_train_step(model, opt, sched, log_vars, speed_weights)
  it = iterate_minibatches(train_ds, batch_size, rng, epochs=10_000,
                           velocity_dropout=VELOCITY_DROPOUT)

  def validate():
    if val_ds is None or not len(val_ds):
      return {}
    return validate_plant(model, val_ds, batch_size, speed_weights)

  return PlantTrainer(model, lambda: step_fn(next(it)), validate)


def train_plant(cfg: GlobalConfig, pcfg: PlanTConfig, ds: PlantDataset,
                steps: int = 500, log_every: int = 100, **trainer_kw):
  """`steps` steps of ``plant_trainer(cfg, pcfg, ds, steps, **trainer_kw)``,
  then its validation.

  Returns (model, history): history holds the aux losses of every
  log_every-th step and the last, the last with the validation losses
  (``val_*``)."""
  trainer = plant_trainer(cfg, pcfg, ds, steps, **trainer_kw)
  history = []
  for i in range(steps):
    aux = trainer.step()
    if i % log_every == 0 or i == steps - 1:
      history.append({k: float(v) for k, v in aux.items()})
  if history:
    history[-1].update(trainer.validate())
  return trainer.model, history


@torch.no_grad()
def validate_plant(model: PlanT, val_ds: PlantDataset, batch_size: int = 64,
                   speed_weights=SPEED_WEIGHTS) -> dict:
  """Validation losses over the held-out split (train.py:822-843), in
  batches of min(batch_size, len(val_ds)) shuffled from seed 0."""
  rng = np.random.default_rng(0)
  sums, n = {}, 0
  for batch in iterate_minibatches(val_ds, min(batch_size, len(val_ds)),
                                   rng):
    _, aux = plant_loss(model, batch, speed_weights=speed_weights)
    for k, v in aux.items():
      sums[k] = sums.get(k, 0.0) + float(v)
    n += 1
  return {f"val_{k}": v / max(n, 1) for k, v in sums.items()}
