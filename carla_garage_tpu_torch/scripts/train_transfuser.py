"""End-to-end sensor-fusion product loop on the port (port of
scripts/train_transfuser.py): multi-seed expert datagen -> TransFuser++
imitation training with sensors and labels rendered on the card (bf16
forward and backward) -> closed-loop sensor-agent evaluation, with
checkpoints at every eval boundary, DAgger rounds, the best checkpoint,
a final multi-seed eval and a regression floor.

  python -m carla_garage_tpu_torch.scripts.train_transfuser \\
      --towns synth synth2 --eval-towns synth3 --steps 20000 --datasets 4 \\
      --episodes 16 --frames 240 --eval-every 4000

The flags and defaults are the JAX script's; the default model is the
reference sensor spec (``TransfuserConfig()``), --micro the fast one.
Imported town names (Town01-06) load from --assets-root; 'synth' and
'synth<N>' name the procedural grid town. Outputs go under
checkpoints/torch/ and results/torch/ by default: ``{out}_step{N}``,
``{out}_dagger{r}`` and ``{out}`` (the best)
checkpoints, ``{out}_shards/<key>/`` (datagen shards, keyed by every
argument that defines datagen) and ``{out}_trainstate.pt`` (written at
each eval boundary: weights, optimizer, schedule, both samplers' states,
history and the best so far, with the arguments that define the run; a
later run with the same --out resumes from it, and refuses to when any
of those arguments differ).

Seeds are the JAX script's (datasets ``1000*d+17``, DAgger ``5000+97r``,
boundary evals ``[321, 654]``, final eval ``4321+11k``, the frame sampler
``np.random.default_rng(0)``); the simulator's and the train step's draws
come from ``torch.Generator``s seeded with them, not from JAX keys.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from carla_garage_tpu_torch.agents.sensor_agent import make_sensor_policy
from carla_garage_tpu_torch.bench import reduced_config
from carla_garage_tpu_torch.config import DEFAULT_CONFIG
from carla_garage_tpu_torch.device import resolve_device
from carla_garage_tpu_torch.maps import importer
from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                      TransfuserConfig)
from carla_garage_tpu_torch.scripts.train_plant import (CHUNK, batch_mean,
                                                        collect_chunked,
                                                        quality_gate,
                                                        route_lengths,
                                                        suite_summary)
from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
from carla_garage_tpu_torch.sensors.lidar import (full_lidar_grid,
                                                  lidar_ray_grid)
from carla_garage_tpu_torch.sim.datagen import (collect_dagger_frames,
                                                collect_expert_frames,
                                                target_speed_labels,
                                                waypoint_labels)
from carla_garage_tpu_torch.sim.episode import rollout_chunked
from carla_garage_tpu_torch.sim.scene_builder import make_town_batch
from carla_garage_tpu_torch.sim.scoring import compute_scores
from carla_garage_tpu_torch.structs import tree_map
from carla_garage_tpu_torch.train.transfuser_train import (
    make_optimizer, make_transfuser_train_step)
from carla_garage_tpu_torch.utils.checkpoint import (cpu_state,
                                                     load_checkpoint,
                                                     save_checkpoint)

DEVICE_KEYS = ("maps", "scene", "frames")
SYNTH_HW = (1680, 1680)          # the procedural grid town's raster
BOUNDARY_EVAL_SEEDS = [321, 654]
# arguments that name outputs or gate the result: they do not define the
# run, so a resume may change them
NOT_RUN_KEYS = ("out", "results", "floor", "cmdline")


def town_hw(name: str, assets_root: str | None = None) -> tuple:
  """A town's raster (height, width): one padded shape over every train
  and eval town lets one set of tensor shapes serve them all. An imported
  town's is its road layer's, read from the town as ``load_town`` gives
  it (its disk cache needs no h5py)."""
  if name.startswith("synth"):
    return SYNTH_HW
  town = importer.load_town(name, assets_root)
  return tuple(town.raster.shape[1:])


def model_config(args) -> TransfuserConfig:
  if args.micro:
    return reduced_config()
  # the full reference spec (ref config.py:100-106, :326-484)
  return TransfuserConfig()


def frame_pools(cfg, frames) -> dict:
  """The sampler's pools of a gated dataset (frame indices, host numpy):
  ``usable`` (frames where some episode has a waypoint label) less the
  last tenth, ``holdout`` (that tenth, for the offline diagnosis),
  ``usable_brake`` (usable frames where some labelled episode brakes
  within 2 frames) and ``speed_counts`` (labelled samples per speed
  class, float64)."""
  _, wp_valid = waypoint_labels(frames)
  wp_valid = wp_valid.cpu().numpy()
  usable = np.nonzero(wp_valid.any(-1))[0]
  sl = target_speed_labels(frames, cfg, brake_lookahead=2).cpu().numpy()
  alive = frames.alive.cpu().numpy() & wp_valid
  brake_rows = ((sl == 0) & alive).any(-1)
  n_hold = max(len(usable) // 10, 1)
  holdout = usable[len(usable) - n_hold:]
  usable = usable[:len(usable) - n_hold]
  usable_brake = np.asarray([i for i in usable if brake_rows[i]], np.int64)
  counts = np.bincount(sl[alive].ravel(), minlength=4).astype(np.float64)
  return dict(usable=usable, usable_brake=usable_brake, holdout=holdout,
              speed_counts=counts)


def _n_vehicles(args, seed: int) -> int:
  rng = np.random.default_rng(seed)
  return int(rng.integers(args.min_vehicles, args.max_vehicles + 1))


def build_dataset(cfg, args, seed: int, town_name: str = "synth",
                  pad_hw=None, crop_hw=None, device="cuda") -> dict:
  """One expert-datagen shard: the scene batch and its frames, with the
  quality gate (imperfect episodes -> alive False everywhere -> loss
  weight 0) and the sampler's pools (``frame_pools``)."""
  dev = resolve_device(device)
  print(f"  building {town_name} scene (seed {seed})...", flush=True)
  _, maps, lanes, scene, state = make_town_batch(
      cfg, town_name, batch=args.episodes, seed=seed,
      n_vehicles=_n_vehicles(args, seed), n_walkers=2, pad_hw=pad_hw,
      crop_hw=crop_hw, crop_margin_m=args.crop_margin_m,
      min_route_m=args.min_route_m, max_route_m=args.max_route_m,
      use_scenarios=not args.no_scenarios, assets_root=args.assets_root,
      device=dev)
  if args.frames % CHUNK:
    raise ValueError(f"--frames {args.frames} is not a multiple of {CHUNK}")
  gen = torch.Generator(device=dev).manual_seed(seed)
  final, frames = collect_chunked(
      lambda s: collect_expert_frames(cfg, maps, lanes, scene, s, CHUNK,
                                      generator=gen),
      state, args.frames // CHUNK)
  clean = quality_gate(final.criteria)
  frames = frames.replace(alive=frames.alive & clean[None, :])
  return dict(maps=maps, scene=scene, frames=frames,
              n_clean=int(clean.sum()), town=town_name,
              **frame_pools(cfg, frames))


def build_dagger_dataset(cfg, args, tcfg, model, cam_grid, lid_f, lid_r,
                         seed: int, town_name: str = "synth", pad_hw=None,
                         crop_hw=None, device="cuda") -> dict:
  """On-policy corrective data: `model` drives fresh scenes while the
  expert's state rides along and labels every visited state. No quality
  gate (mistake states are the point); post-done frames drop through the
  alive mask."""
  dev = resolve_device(device)
  _, maps, lanes, scene, state = make_town_batch(
      cfg, town_name, batch=args.episodes, seed=seed,
      n_vehicles=_n_vehicles(args, seed), n_walkers=2, pad_hw=pad_hw,
      crop_hw=crop_hw, crop_margin_m=args.crop_margin_m,
      min_route_m=args.min_route_m, max_route_m=args.max_route_m,
      use_scenarios=not args.no_scenarios, assets_root=args.assets_root,
      device=dev)
  policy, reset = make_sensor_policy(model, None, tcfg,
                                     (cam_grid, lid_f, lid_r), direct=True,
                                     bf16=True, brake_threshold=0.33)
  st = state.replace(agent=reset(cfg, args.episodes, device=dev))
  gen = torch.Generator(device=dev).manual_seed(seed)
  _, frames = collect_chunked(
      lambda s: collect_dagger_frames(cfg, maps, lanes, scene, s, policy,
                                      CHUNK, generator=gen),
      st, max(args.dagger_frames // CHUNK, 1))
  usable = np.nonzero(frames.alive.cpu().numpy().any(-1))[0]
  return dict(maps=maps, scene=scene, frames=frames, usable=usable)


def dataset_to_host(ds: dict) -> dict:
  """The dataset with its tensors (DEVICE_KEYS) on the CPU: shards wait
  there, and the loop keeps one on the card at a time (block
  scheduling), which decides the frames a step sees."""
  return {k: tree_map(lambda x: x.cpu(), v) if k in DEVICE_KEYS else v
          for k, v in ds.items()}


def dataset_to_device(ds: dict, device) -> dict:
  return {k: tree_map(lambda x: x.to(device), v) if k in DEVICE_KEYS
          else v for k, v in ds.items()}


def data_of(ds: dict) -> tuple:
  """(maps, scene, frames): what a train or eval step renders from."""
  return tuple(ds[k] for k in DEVICE_KEYS)


def closed_loop_eval(cfg, args, tcfg, model, params, cam_grid, lid_f, lid_r,
                     n_routes: int, seed: int, max_ticks: int = 6000,
                     brake_threshold: float = 0.33,
                     town_name: str = "synth", pad_hw=None, crop_hw=None,
                     chunk: int = 512, device="cuda") -> dict:
  """One batch of n_routes routes at the honest benchmark density
  (args.eval_n_vehicles, scenarios on unless --no-scenarios) driven by
  the bf16 sensor agent (direct, brake_threshold 0.33: the reference's
  Longest6 point) through ``rollout_chunked`` in chunks of `chunk`.
  params: None for `model`'s own weights, or a state dict. The sensor
  and scenario noise comes from a generator seeded with `seed`."""
  dev = resolve_device(device)
  _, maps, lanes, scene, state = make_town_batch(
      cfg, town_name, batch=n_routes, seed=seed,
      n_vehicles=args.eval_n_vehicles, n_walkers=2,
      use_scenarios=not args.no_scenarios,
      pad_hw=pad_hw, crop_hw=crop_hw, crop_margin_m=args.crop_margin_m,
      assets_root=args.assets_root, device=dev)
  policy, reset = make_sensor_policy(model, params, tcfg,
                                     (cam_grid, lid_f, lid_r), direct=True,
                                     bf16=True,
                                     brake_threshold=brake_threshold)
  st = state.replace(agent=reset(cfg, n_routes, device=dev))
  final = rollout_chunked(cfg, maps, lanes, scene, st, max_ticks,
                          chunk=chunk, policy=policy,
                          generator=torch.Generator(
                              device=dev).manual_seed(seed))
  sc = compute_scores(cfg, final.criteria, route_lengths(scene))
  cr = final.criteria
  return dict(DS=float(torch.mean(sc.score_composed)),
              RC=float(torch.mean(sc.score_route)),
              IS=float(torch.mean(sc.score_penalty)),
              # per-route mean infraction counts: which failure dominates
              coll_veh=batch_mean(cr.n_collision_vehicle),
              coll_wlk=batch_mean(cr.n_collision_walker),
              coll_stat=batch_mean(cr.n_collision_static),
              red_light=batch_mean(cr.n_red_light),
              stop_sign=batch_mean(cr.n_stop_sign),
              outside_lane_m=batch_mean(cr.outside_lane_m),
              blocked=batch_mean(cr.blocked))


def eval_suite(cfg, args, tcfg, model, params, cam_grid, lid_f, lid_r,
               towns, seeds, n_routes, pad_hw=None, crop_hw=None,
               brake_threshold: float = 0.33, chunk: int = 512,
               max_ticks: int = 6000, device="cuda") -> dict:
  """Mean and spread of DS over (town x seed) closed-loop batches:
  checkpoint selection and the floor key off the mean of several
  batches, not one noisy 8-route score."""
  rows = []
  for t in towns:
    for s in seeds:
      ev = closed_loop_eval(cfg, args, tcfg, model, params, cam_grid, lid_f,
                            lid_r, n_routes, seed=s, max_ticks=max_ticks,
                            brake_threshold=brake_threshold, town_name=t,
                            pad_hw=pad_hw, crop_hw=crop_hw, chunk=chunk,
                            device=device)
      ev["town"], ev["seed"] = t, s
      rows.append(ev)
  return suite_summary(rows)


def offline_diagnosis(eval_fn, datasets, np_rng, device,
                      n_batches: int = 8) -> dict:
  """Open-loop metrics on held-out frames the sampler never draws: the
  train step's eval losses and mIoU, the checkpoint-angle error, and the
  speed-class confusion with each class's recall. Batch b takes one
  holdout frame of dataset b % len(datasets) (drawn with np_rng) and its
  draws from a generator seeded 10_000 + b."""
  sums, n = {}, 0
  conf = np.zeros((4, 4), np.int64)
  for b in range(n_batches):
    ds = datasets[b % len(datasets)]
    pool = ds.get("holdout")
    if pool is None or not len(pool):
      continue
    f_idx = [int(i) for i in np_rng.choice(pool, size=1)]
    gen = torch.Generator(device=device).manual_seed(10_000 + b)
    aux = eval_fn(f_idx, generator=gen,
                  data=data_of(dataset_to_device(ds, device)))
    for k, v in aux.items():
      if v.ndim == 0:
        sums[k] = sums.get(k, 0.0) + float(v)
    conf += aux["confusion"].cpu().numpy().astype(np.int64)
    n += 1
  out = {k: v / max(n, 1) for k, v in sums.items()}
  recall = conf.diagonal() / np.maximum(conf.sum(1), 1)
  out["speed_class_recall"] = [round(float(r), 3) for r in recall]
  out["speed_class_confusion"] = conf.tolist()
  return out


def speed_class_weights(datasets) -> tuple:
  """Inverse-frequency speed-class weights over the datasets' counts,
  clipped to [0.05, 20] so that a near-empty class cannot blow up the
  cross entropy's scale."""
  counts = np.maximum(sum(ds["speed_counts"] for ds in datasets), 1.0)
  return tuple(np.clip(counts.sum() / (4.0 * counts), 0.05, 20.0).tolist())


def sample_frames(ds: dict, k: int, np_rng, brake_oversample: float):
  """k frame indices, each drawn from the brake-bearing pool with
  probability brake_oversample (rare-hazard oversampling), else from the
  usable pool; the numpy draws in the JAX script's order."""
  pools = [ds["usable_brake"] if (len(ds["usable_brake"]) and
                                  np_rng.random() < brake_oversample)
           else ds["usable"] for _ in range(k)]
  return [int(np_rng.choice(p)) for p in pools]


def cache_key(args, cfg, pad_hw) -> str:
  """The shard cache's directory name: every value that defines datagen
  (sizes, NPC range and slot capacity, route lengths, raster crop or
  padding, scenarios), hashed, after a readable prefix."""
  spec = dict(episodes=args.episodes, frames=args.frames,
              min_vehicles=args.min_vehicles, max_vehicles=args.max_vehicles,
              capacity=cfg.sim.max_vehicles, min_route_m=args.min_route_m,
              max_route_m=args.max_route_m, crop_px=args.crop_px,
              crop_margin_m=args.crop_margin_m, pad_hw=pad_hw,
              no_scenarios=args.no_scenarios, assets_root=args.assets_root)
  digest = hashlib.sha1(json.dumps(spec, sort_keys=True).encode())
  return f"{args.episodes}x{args.frames}_{digest.hexdigest()[:12]}"


def run_key(args, **extra) -> dict:
  """The arguments that define a training run (every flag but the
  outputs and the floor), with the run's own settings: a train state is
  resumed only under an equal key."""
  key = {k: v for k, v in vars(args).items() if k not in NOT_RUN_KEYS}
  key.update(extra)
  return json.loads(json.dumps(key))


def load_trainstate(path: str, key: dict) -> dict | None:
  """The train state at `path` (a file this program wrote), None when
  there is none; exits with a message when it belongs to a run with
  other defining arguments."""
  if not os.path.exists(path):
    return None
  ts = torch.load(path, map_location="cpu", weights_only=False)
  if ts["run_key"] != key:
    diff = sorted(k for k in set(key) | set(ts["run_key"])
                  if key.get(k) != ts["run_key"].get(k))
    raise SystemExit(f"{path} belongs to another run (arguments {diff} "
                     f"differ); remove it or use another --out")
  return ts


def parse_args(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--steps", type=int, default=20000)
  ap.add_argument("--datasets", type=int, default=4)
  ap.add_argument("--episodes", type=int, default=16)
  ap.add_argument("--frames", type=int, default=240)
  ap.add_argument("--frames-per-step", type=int, default=4,
                  help="gradient-accumulated micro-batches per step; "
                       "effective batch = episodes * this (the reference "
                       "trains at 64, config.py:171-173)")
  ap.add_argument("--towns", nargs="+",
                  default=["Town01", "Town02", "Town03", "Town04",
                           "Town05", "Town06"],
                  help="datagen worlds, cycled across --datasets shards: "
                       "imported CARLA towns (--assets-root) or "
                       "procedural 'synth'/'synthN' grids")
  ap.add_argument("--eval-towns", nargs="+", default=["Town03", "Town05"],
                  help="closed-loop eval worlds (held-out seeds)")
  ap.add_argument("--assets-root", default=None,
                  help="the CARLA asset root that imported town names "
                       "(Town01-06) load from (default: "
                       "$CGT_ASSETS_ROOT)")
  ap.add_argument("--final-eval-seeds", type=int, default=3,
                  help="eval batches per town for the final multi-seed "
                       "eval")
  ap.add_argument("--log-every", type=int, default=250,
                  help="step-log interval (each log reads the losses "
                       "back to the host)")
  ap.add_argument("--block-steps", type=int, default=150,
                  help="consecutive steps per dataset shard (one shard's "
                       "tensors on the card at a time)")
  ap.add_argument("--crop-margin-m", type=float, default=130.0,
                  help="clearance kept around the route union bbox in a "
                       "corridor crop (sensor range is 85 m)")
  ap.add_argument("--crop-px", type=int, default=3456,
                  help="crop each dataset's town raster to this square "
                       "window around its routes (0 = full padded towns)")
  ap.add_argument("--min-route-m", type=float, default=250.0,
                  help="datagen route length bounds; match to --frames "
                       "(a 500-frame episode covers ~125 s of driving)")
  ap.add_argument("--max-route-m", type=float, default=500.0)
  ap.add_argument("--min-vehicles", type=int, default=80,
                  help="datagen NPC range (honest density: the honest "
                       "benchmark runs 100)")
  ap.add_argument("--max-vehicles", type=int, default=120)
  ap.add_argument("--eval-n-vehicles", type=int, default=100,
                  help="closed-loop eval NPC count (honest benchmark "
                       "density)")
  ap.add_argument("--no-scenarios", action="store_true",
                  help="disable the 7 scenario types in datagen and eval "
                       "worlds (on by default, as in the honest benchmark)")
  ap.add_argument("--lr", type=float, default=3e-4)
  ap.add_argument("--micro", action="store_true")
  ap.add_argument("--no-bf16", action="store_true")
  ap.add_argument("--eval-every", type=int, default=4000)
  ap.add_argument("--eval-routes", type=int, default=8)
  ap.add_argument("--dagger-rounds", type=int, default=0,
                  help="on-policy fine-tune rounds after BC")
  ap.add_argument("--brake-oversample", type=float, default=0.5,
                  help="probability a sampled frame comes from the "
                       "brake-labeled pool (0 disables)")
  ap.add_argument("--eval-brake-threshold", type=float, default=0.33,
                  help="closed-loop brake-probability override (reference "
                       "Longest6 op point UNCERTAINTY_THRESHOLD=0.33)")
  ap.add_argument("--dagger-steps", type=int, default=2000)
  ap.add_argument("--dagger-frames", type=int, default=160)
  ap.add_argument("--out", default="checkpoints/torch/transfuser_full")
  ap.add_argument("--resume", default=None,
                  help="a checkpoint directory to initialize the weights "
                       "from")
  ap.add_argument("--floor", type=float, default=None,
                  help="assert final closed-loop DS >= this (regression "
                       "gate; exits non-zero below it)")
  ap.add_argument("--results",
                  default="results/torch/transfuser_synth_eval.json")
  args = ap.parse_args(argv)
  args.cmdline = " ".join(sys.argv if argv is None else
                          ["train_transfuser"] + list(argv))
  return args


def load_datasets(cfg, args, pad_hw, crop_hw, dev) -> list:
  """The --datasets expert shards on the host, each built once and then
  read from the shard cache (``{out}_shards/<cache_key>/``); shards
  without a usable frame are skipped."""
  cache_dir = os.path.join(f"{args.out}_shards",
                           cache_key(args, cfg, pad_hw))
  os.makedirs(cache_dir, exist_ok=True)
  datasets = []
  for d in range(args.datasets):
    town_name = args.towns[d % len(args.towns)]
    shard_path = os.path.join(cache_dir, f"shard_{d:03d}_{town_name}.pt")
    if os.path.exists(shard_path):
      # a shard this program wrote: structs of tensors and numpy pools
      ds = torch.load(shard_path, map_location="cpu", weights_only=False)
      datasets.append(ds)
      print(f"dataset {d} [{town_name}]: loaded from cache "
            f"({len(ds['usable'])} usable frames)", flush=True)
      continue
    ds = build_dataset(cfg, args, seed=1000 * d + 17, town_name=town_name,
                       pad_hw=pad_hw, crop_hw=crop_hw, device=dev)
    if len(ds["usable"]) == 0:
      print(f"dataset {d} [{town_name}]: EMPTY (no usable frames) — "
            f"skipped", flush=True)
      continue
    host = dataset_to_host(ds)
    torch.save(host, shard_path + ".tmp")
    os.replace(shard_path + ".tmp", shard_path)   # no torn shards
    datasets.append(host)
    print(f"dataset {d} [{town_name}]: {args.episodes}x{args.frames} "
          f"frames, {host['n_clean']}/{args.episodes} clean episodes, "
          f"{len(host['usable'])} usable frames "
          f"({len(host['usable_brake'])} brake-bearing, "
          f"{len(host['holdout'])} held out)", flush=True)
  if not datasets:
    raise RuntimeError("no dataset holds a usable frame")
  return datasets


def run(args, eval_chunk: int = 512, eval_max_ticks: int = 6000,
        device="cuda") -> dict:
  """The loop of ``main`` on parsed arguments; returns the results dict
  (also written to --results). eval_chunk and eval_max_ticks: the
  closed-loop evals' ticks a chunk and tick budget (the JAX script's 512
  and 6,000)."""
  dev = resolve_device(device)
  key = run_key(args, eval_chunk=eval_chunk, eval_max_ticks=eval_max_ticks)
  trainstate_path = f"{args.out}_trainstate.pt"
  ts = load_trainstate(trainstate_path, key)
  # one vehicle-slot capacity fits datagen's and the evals' densities
  cap = max(args.max_vehicles, args.eval_n_vehicles,
            DEFAULT_CONFIG.sim.max_vehicles)
  cfg = DEFAULT_CONFIG.replace(sim=dataclasses.replace(
      DEFAULT_CONFIG.sim, max_vehicles=cap))
  tcfg = model_config(args)
  cam_scale = lid_dec = 4 if args.micro else 1
  cam_grid = camera_ray_grid(cfg, scale=cam_scale)
  # training renders the full 360° sweep (the sensor agent's merged
  # half sweeps); the policy keeps per-half grids
  lid_grid = full_lidar_grid(cfg, decimate=lid_dec)
  lid_front = lidar_ray_grid(cfg, half=0, decimate=lid_dec)
  lid_rear = lidar_ray_grid(cfg, half=1, decimate=lid_dec)
  all_towns = sorted(set(args.towns) | set(args.eval_towns))
  if args.crop_px:
    crop_hw, pad_hw = (args.crop_px, args.crop_px), None
    print(f"route-corridor crops {crop_hw} over {all_towns}", flush=True)
  else:
    crop_hw = None
    hws = [town_hw(t, args.assets_root) for t in all_towns]
    pad_hw = (max(h for h, _ in hws), max(w for _, w in hws))
    print(f"common raster shape {pad_hw} over {all_towns}", flush=True)
  evals_kw = dict(pad_hw=pad_hw, crop_hw=crop_hw,
                  brake_threshold=args.eval_brake_threshold,
                  chunk=eval_chunk, max_ticks=eval_max_ticks, device=dev)

  t0 = time.time()
  datasets = load_datasets(cfg, args, pad_hw, crop_hw, dev)
  print(f"datagen: {time.time()-t0:.0f}s total", flush=True)
  speed_weights = speed_class_weights(datasets)
  print(f"speed-class weights {[round(w, 3) for w in speed_weights]}",
        flush=True)

  # ---- model / optimizer ----
  with torch.random.fork_rng(devices=[]):
    torch.manual_seed(0)
    model = LidarCenterNet(tcfg)
  model = model.to(dev)
  if args.resume:
    load_checkpoint(args.resume, model)
    print(f"resumed weights from {args.resume}", flush=True)
  n_params = sum(p.numel() for p in model.parameters())
  print(f"params: {n_params/1e6:.1f}M", flush=True)
  # the schedule spans BC + DAgger: multistep's milestones are fractions
  # of all optimizer steps, so DAgger rounds do not run at the floor LR
  total_steps = args.steps + args.dagger_rounds * args.dagger_steps
  opt, sched = make_optimizer(model, args.lr, total_steps, "multistep")
  step_fn, eval_fn, _ = make_transfuser_train_step(
      cfg, tcfg, model, opt, *data_of(datasets[0]), cam_grid, lid_grid,
      bf16=not args.no_bf16, speed_weights=speed_weights, clip_norm=1.0,
      scheduler=sched)
  K = args.frames_per_step

  def evaluate(params=None, seeds=BOUNDARY_EVAL_SEEDS):
    return eval_suite(cfg, args, tcfg, model, params, cam_grid, lid_front,
                      lid_rear, args.eval_towns, seeds, args.eval_routes,
                      **evals_kw)

  # ---- training state, resumable at eval boundaries ----
  np_rng = np.random.default_rng(0)
  gen = torch.Generator(device=dev).manual_seed(0)
  history, evals = [], []
  best, best_params = {"DS": -1.0}, None
  start_step = 0

  def save_trainstate(step: int):
    state = {"run_key": key, "step": step,
             "model": cpu_state(model), "optimizer": opt.state_dict(),
             "scheduler": sched.state_dict(),
             "np_rng": np_rng.bit_generator.state,
             "generator": gen.get_state(), "history": history,
             "evals": evals, "best": best, "best_params": best_params}
    torch.save(state, trainstate_path + ".tmp")
    os.replace(trainstate_path + ".tmp", trainstate_path)

  if ts is not None:
    model.load_state_dict(ts["model"])
    opt.load_state_dict(ts["optimizer"])
    sched.load_state_dict(ts["scheduler"])
    np_rng.bit_generator.state = ts["np_rng"]
    gen.set_state(ts["generator"])
    history, evals, best = ts["history"], ts["evals"], ts["best"]
    best_params, start_step = ts["best_params"], ts["step"]
    print(f"resumed train state at step {start_step} "
          f"(best DS {best.get('DS', -1):.1f})", flush=True)

  def boundary(step: int):
    """The eval at an eval boundary, then the step's checkpoint and the
    train state."""
    nonlocal best, best_params
    ev = evaluate()
    ev["diagnosis"] = offline_diagnosis(eval_fn, datasets, np_rng, dev)
    ev["step"] = step
    evals.append(ev)
    print(f"eval @{step}: DS {ev['DS']:.2f}±{ev['DS_std']:.2f} "
          f"RC {ev['RC']:.2f}", flush=True)
    params_host = cpu_state(model)
    save_checkpoint(f"{args.out}_step{step}", params_host,
                    meta={"model": "transfuser", "step": step,
                          "config": dataclasses.asdict(tcfg), "eval": ev})
    if ev["DS"] >= best["DS"]:
      best, best_params = ev, params_host
    save_trainstate(step)

  # ---- BC: block-scheduled datasets, one on the card at a time ----
  t0 = time.time()
  cur_d, dev_ds = -1, None
  for i in range(start_step, args.steps):
    di = (i // args.block_steps) % len(datasets)
    if di != cur_d:
      dev_ds, cur_d = None, di             # free the last block's first
      dev_ds = dataset_to_device(datasets[di], dev)
    f_idx = sample_frames(datasets[di], K, np_rng, args.brake_oversample)
    aux = step_fn(f_idx, generator=gen, data=data_of(dev_ds))
    if i % args.log_every == 0 or i == args.steps - 1:
      h = {k: float(v) for k, v in aux.items()}
      h["step"] = i
      h["wall_s"] = round(time.time() - t0, 1)
      history.append(h)
      print(f"step {i}: loss {h['loss']:.3f} ({h['wall_s']:.0f}s)",
            flush=True)
    if args.eval_every and (i + 1) % args.eval_every == 0:
      boundary(i + 1)
  dev_ds = None

  # ---- DAgger rounds: on-policy mistakes (waypoint loss off: the
  # recorded trajectory is the policy's own), interleaved 1:1 with expert
  # replay so that BC supervision does not erode ----
  for r in range(args.dagger_rounds):
    dag_town = args.towns[(r * 3 + 1) % len(args.towns)]
    dset = build_dagger_dataset(cfg, args, tcfg, model, cam_grid, lid_front,
                                lid_rear, seed=5000 + 97 * r,
                                town_name=dag_town, pad_hw=pad_hw,
                                crop_hw=crop_hw, device=dev)
    print(f"dagger round {r} [{dag_town}]: {len(dset['usable'])} usable "
          f"frame rows", flush=True)
    cur_e, dev_e = -1, None
    for i in range(args.dagger_steps):
      on_policy = (i % 2 == 0)
      if on_policy:
        f_idx = [int(x) for x in np_rng.choice(dset["usable"], size=K)]
        data = data_of(dset)
      else:
        ei = ((i // 2) // args.block_steps) % len(datasets)
        if ei != cur_e:
          dev_e, cur_e = None, ei
          dev_e = dataset_to_device(datasets[ei], dev)
        f_idx = sample_frames(datasets[ei], K, np_rng, args.brake_oversample)
        data = data_of(dev_e)
      aux = step_fn(f_idx, generator=gen, data=data,
                    wp_w=0.0 if on_policy else 1.0)
      if i % max(args.dagger_steps // 8, 1) == 0:
        print(f"dagger {r} step {i}: loss {float(aux['loss']):.3f}",
              flush=True)
    dset = dev_e = None
    ev = evaluate()
    ev["diagnosis"] = offline_diagnosis(eval_fn, datasets, np_rng, dev)
    ev["step"] = args.steps + (r + 1) * args.dagger_steps
    ev["dagger_round"] = r
    evals.append(ev)
    print(f"eval dagger@{r}: DS {ev['DS']:.2f}±{ev['DS_std']:.2f}",
          flush=True)
    params_host = cpu_state(model)
    save_checkpoint(f"{args.out}_dagger{r}", params_host,
                    meta={"model": "transfuser", "dagger_round": r,
                          "config": dataclasses.asdict(tcfg), "eval": ev})
    if ev["DS"] >= best["DS"]:
      best, best_params = ev, params_host

  if best_params is None:
    best_params = cpu_state(model)
  save_checkpoint(args.out, best_params,
                  meta={"model": "transfuser",
                        "config": dataclasses.asdict(tcfg),
                        "best_eval": best})

  # ---- final closed-loop eval: multi-seed, held-out seeds and towns ----
  final_ev = evaluate(best_params,
                      [4321 + 11 * k for k in range(args.final_eval_seeds)])
  out = {
      "transfuser_DS": final_ev["DS"],
      "transfuser_DS_std": final_ev["DS_std"],
      "transfuser_RC": final_ev["RC"],
      "transfuser_IS": final_ev["IS"],
      "final_eval": final_ev,
      "best_train_eval": best,
      "evals": evals,
      "steps": args.steps,
      "frames": args.datasets * args.episodes * args.frames,
      "meta": {
          "config": dataclasses.asdict(tcfg),
          "cam_scale": cam_scale, "lidar_decimate": lid_dec,
          "bf16": not args.no_bf16, "lr": args.lr,
          "datasets": args.datasets, "episodes": args.episodes,
          "towns": args.towns, "eval_towns": args.eval_towns,
          "effective_batch": args.episodes * args.frames_per_step,
          "cmdline": args.cmdline,
      },
  }
  print(json.dumps({k: v for k, v in out.items() if k != "evals"},
                   indent=1), flush=True)
  os.makedirs(os.path.dirname(args.results) or ".", exist_ok=True)
  with open(args.results, "w") as f:
    json.dump(out, f, indent=1)
  return out


def main(argv=None):
  args = parse_args(argv)
  out = run(args)
  if args.floor is not None and out["transfuser_DS"] < args.floor:
    print(f"FLOOR VIOLATION: DS {out['transfuser_DS']:.2f} < {args.floor}",
          flush=True)
    sys.exit(1)


if __name__ == "__main__":
  main()
