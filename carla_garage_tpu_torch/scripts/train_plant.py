"""End-to-end PlanT product loop on the port (port of scripts/train_plant.py):
object-level expert datagen at honest density (100 NPCs, all scenario
types) -> imitation training in segments -> the closed-loop eval suite
after each segment, keeping the segment with the best mean driving score.

  python -m carla_garage_tpu_torch.scripts.train_plant \\
      --towns synth synth2 --eval-towns synth3 --shards 24 --episodes 16 \\
      --frames 400 --steps 12000

The flags and defaults are the JAX script's. The default towns are
imported CARLA towns (Town01-06), loaded from --assets-root with their
recovered lane graphs (``maps/importer.py``); 'synth' and 'synth<N>'
name the procedural grid town. Outputs go under checkpoints/torch/ and
results/torch/ by default. Seeds are the JAX script's (shards
``1000*town_index+37k+5``, eval ``4321+11s``); the simulator's draws come
from ``torch.Generator``s seeded with them, not from JAX keys, so the
episodes are the JAX script's scenes driven with other noise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from carla_garage_tpu_torch.agents.plant_agent import (make_plant_policy,
                                                       plant_agent_reset)
from carla_garage_tpu_torch.config import DEFAULT_CONFIG
from carla_garage_tpu_torch.device import resolve_device
from carla_garage_tpu_torch.models.plant import PlanTConfig
from carla_garage_tpu_torch.sim.datagen import collect_expert_frames
from carla_garage_tpu_torch.sim.episode import rollout_chunked
from carla_garage_tpu_torch.sim.scene_builder import (_PAD_CACHE,
                                                      make_town_batch)
from carla_garage_tpu_torch.sim.scoring import compute_scores
from carla_garage_tpu_torch.structs import tree_map
from carla_garage_tpu_torch.train.plant_train import (PlantDataset,
                                                      build_plant_dataset,
                                                      estimate_speed_weights,
                                                      train_plant)
from carla_garage_tpu_torch.utils.checkpoint import cpu_state, save_checkpoint

CHUNK = 20                  # frames a datagen chunk


def plant_config() -> PlanTConfig:
  return PlanTConfig(hidden=256, n_layers=4, n_heads=8, intermediate=1024,
                     max_objects=24, num_route_points=20)


def honest_cfg(capacity: int):
  cfg = DEFAULT_CONFIG
  return cfg.replace(sim=dataclasses.replace(cfg.sim,
                                             max_vehicles=capacity))


def quality_gate(criteria) -> torch.Tensor:
  """[B] bool: episodes without a collision, a red light or a block
  (data.py:91-95: imperfect expert episodes are dropped)."""
  cr = criteria
  return (cr.n_collision_vehicle == 0) & (cr.n_collision_walker == 0) & \
      (cr.n_collision_static == 0) & (cr.n_red_light == 0) & ~cr.blocked


def collect_chunked(collect, state, n_chunks: int):
  """Run `collect(state) -> (state, frames)` n_chunks times; returns
  (final state, the frames concatenated along the frame axis)."""
  parts = []
  for _ in range(n_chunks):
    state, fr = collect(state)
    parts.append(fr)
  return state, tree_map(lambda *xs: torch.cat(xs), *parts)


def datagen_shard(cfg, pcfg, args, town_name: str, seed: int,
                  device="cuda"):
  """One expert shard at honest density with scenarios attached and the
  quality gate applied through the alive mask. Returns (dataset on the
  device, clean episodes)."""
  dev = resolve_device(device)
  _, maps, lanes, scene, state = make_town_batch(
      cfg, town_name, batch=args.episodes, seed=seed,
      n_vehicles=args.n_vehicles, n_walkers=args.n_walkers,
      use_scenarios=True, min_route_m=args.min_route_m,
      max_route_m=args.max_route_m, assets_root=args.assets_root,
      device=dev)
  if args.frames % CHUNK:
    raise ValueError(f"--frames {args.frames} is not a multiple of {CHUNK}")
  gen = torch.Generator(device=dev).manual_seed(seed)
  st, frames = collect_chunked(
      lambda s: collect_expert_frames(cfg, maps, lanes, scene, s, CHUNK,
                                      generator=gen),
      state, args.frames // CHUNK)
  clean = quality_gate(st.criteria)
  frames = frames.replace(alive=frames.alive & clean[None, :])
  ds = build_plant_dataset(cfg, pcfg, frames, scene)
  return ds, int(clean.sum())


def concat_datasets(parts) -> PlantDataset:
  """The datasets' samples in order, as one new dataset (the parts are
  left as they are). A field that is None in every part stays None; where
  only some parts have it (the DAgger waypoint weights), the others count
  as ones."""
  fields = {}
  for f in dataclasses.fields(PlantDataset):
    vals = [getattr(p, f.name) for p in parts]
    if all(v is None for v in vals):
      fields[f.name] = None
      continue
    fields[f.name] = torch.cat([
        v if v is not None else torch.ones(
            (len(p),), dtype=torch.float32, device=p.boxes.device)
        for v, p in zip(vals, parts)])
  return PlantDataset(**fields)


def batch_mean(x) -> float:
  """Mean over the batch, as the JAX script takes it (numpy float32)."""
  return float(np.asarray(x.cpu(), np.float32).mean())


def route_lengths(scene) -> torch.Tensor:
  """[B] each route's length in metres, summed on the host in float32."""
  seg = scene.route.seg_len.cpu().numpy()
  nv = scene.route.num_valid.cpu().numpy()
  return torch.tensor([float(seg[i][:int(nv[i])].sum())
                       for i in range(len(nv))], dtype=torch.float32,
                      device=scene.route.seg_len.device)


def suite_summary(rows: list) -> dict:
  """Means over the (town x seed) rows of every float metric, the DS's
  spread, and the rows."""
  ds = np.array([r["DS"] for r in rows])
  agg = {k: float(np.mean([r[k] for r in rows]))
         for k in rows[0] if isinstance(rows[0][k], float)}
  agg.update(DS=float(ds.mean()), DS_std=float(ds.std()), rows=rows)
  return agg


def plant_eval_suite(cfg, model, params, pcfg, towns, seeds, n_routes,
                     args, max_ticks: int = 10000, chunk: int = 512,
                     device="cuda"):
  """The honest-density closed-loop eval: one batch of n_routes routes per
  (town, seed) at the benchmark's point (100 NPCs, scenarios on, creep,
  direct at brake threshold 0.33), through ``rollout_chunked`` in chunks
  of `chunk`; checkpoint selection keys off the rows' mean DS. params:
  None to drive with `model`'s own weights, or a state dict. The control
  loss noise comes from a generator seeded with each row's seed."""
  dev = resolve_device(device)
  policy = make_plant_policy(model, params, pcfg, direct=True,
                             brake_threshold=0.33)
  rows = []
  for t in towns:
    for s in seeds:
      _, maps, lanes, scene, state = make_town_batch(
          cfg, t, batch=n_routes, seed=s, n_vehicles=args.n_vehicles,
          n_walkers=args.n_walkers, use_scenarios=True,
          min_route_m=300.0, max_route_m=600.0,
          assets_root=args.assets_root, device=dev)
      st = state.replace(agent=plant_agent_reset(cfg, n_routes, device=dev))
      final = rollout_chunked(cfg, maps, lanes, scene, st, max_ticks,
                              chunk=chunk, policy=policy,
                              generator=torch.Generator(
                                  device=dev).manual_seed(s))
      sc = compute_scores(cfg, final.criteria, route_lengths(scene))
      cr = final.criteria
      rows.append(dict(
          town=t, seed=s,
          DS=float(torch.mean(sc.score_composed)),
          RC=float(torch.mean(sc.score_route)),
          IS=float(torch.mean(sc.score_penalty)),
          coll_veh=batch_mean(cr.n_collision_vehicle),
          coll_wlk=batch_mean(cr.n_collision_walker),
          red_light=batch_mean(cr.n_red_light),
          blocked=batch_mean(cr.blocked)))
  return suite_summary(rows)


def parse_args(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--steps", type=int, default=12000,
                  help="total optimizer steps, split over --segments")
  ap.add_argument("--segments", type=int, default=3,
                  help="train/eval alternations; checkpoint selection "
                       "takes the best eval-suite mean")
  ap.add_argument("--shards", type=int, default=24)
  ap.add_argument("--episodes", type=int, default=16)
  ap.add_argument("--frames", type=int, default=400)
  ap.add_argument("--batch", type=int, default=512)
  ap.add_argument("--n-vehicles", type=int, default=100,
                  help="honest benchmark density (run_benchmarks --honest)")
  ap.add_argument("--n-walkers", type=int, default=2)
  ap.add_argument("--towns", nargs="+",
                  default=["Town01", "Town02", "Town03", "Town04",
                           "Town05", "Town06"])
  ap.add_argument("--eval-towns", nargs="+", default=["Town02", "Town05"])
  ap.add_argument("--assets-root", default=None,
                  help="the CARLA asset root that imported town names "
                       "(Town01-06) load from (default: "
                       "$CGT_ASSETS_ROOT)")
  ap.add_argument("--eval-seeds", type=int, default=2)
  ap.add_argument("--eval-routes", type=int, default=8)
  ap.add_argument("--eval-max-ticks", type=int, default=10000)
  ap.add_argument("--min-route-m", type=float, default=300.0)
  ap.add_argument("--max-route-m", type=float, default=500.0)
  ap.add_argument("--lr", type=float, default=3e-4)
  ap.add_argument("--out", default="checkpoints/torch/plant_r5")
  ap.add_argument("--results", default="results/torch/plant_r5_train.json")
  args = ap.parse_args(argv)
  args.cmdline = " ".join(sys.argv if argv is None else
                          ["train_plant"] + list(argv))
  return args


def run(args, eval_chunk: int = 512, device="cuda") -> dict:
  """The loop of ``main`` on parsed arguments; returns the results dict
  (also written to --results). eval_chunk: the eval suite's ticks a
  chunk (the JAX script's 512)."""
  dev = resolve_device(device)
  pcfg = plant_config()
  cfg = honest_cfg(args.n_vehicles)

  # ---- datagen, grouped by town: one town's rasters on the card at a time
  t0 = time.time()
  parts, clean_total = [], 0
  per_town = max(args.shards // len(args.towns), 1)
  for town_name in args.towns:
    for k in range(per_town):
      seed = 1000 * args.towns.index(town_name) + 37 * k + 5
      ds, n_clean = datagen_shard(cfg, pcfg, args, town_name, seed, dev)
      clean_total += n_clean
      parts.append(ds)
      print(f"shard {town_name}/{k}: {len(ds)} samples "
            f"({n_clean}/{args.episodes} clean episodes, "
            f"{time.time()-t0:.0f}s)", flush=True)
    for key in [k for k in _PAD_CACHE
                if isinstance(k, tuple) and town_name in k]:
      del _PAD_CACHE[key]
  ds = concat_datasets(parts)
  print(f"datagen: {len(ds)} samples, "
        f"{clean_total}/{args.shards * args.episodes} clean episodes, "
        f"{time.time()-t0:.0f}s", flush=True)

  # ---- training segments with eval-suite checkpoint selection ----
  seg_steps = args.steps // args.segments
  params, speed_weights = None, None
  best, best_params, evals = {"DS": -1.0}, None, []
  for seg in range(args.segments):
    t1 = time.time()
    if seg == 0:
      speed_weights = estimate_speed_weights(ds)
    model, hist = train_plant(
        cfg, pcfg, ds, steps=seg_steps, batch_size=args.batch, lr=args.lr,
        params=params, log_every=max(seg_steps // 8, 1),
        speed_weights=speed_weights)
    params = model.state_dict()
    print(f"segment {seg}: {seg_steps} steps in {time.time()-t1:.0f}s, "
          f"loss {hist[-1]['loss']:.3f}", flush=True)
    ev = plant_eval_suite(cfg, model, None, pcfg, args.eval_towns,
                          [4321 + 11 * s for s in range(args.eval_seeds)],
                          args.eval_routes, args,
                          max_ticks=args.eval_max_ticks, chunk=eval_chunk,
                          device=dev)
    ev["segment"], ev["step"] = seg, (seg + 1) * seg_steps
    evals.append(ev)
    print(f"eval @seg{seg}: DS {ev['DS']:.1f}±{ev['DS_std']:.1f} "
          f"RC {ev['RC']:.1f} coll_veh {ev['coll_veh']:.2f}", flush=True)
    if ev["DS"] >= best["DS"]:
      best = ev
      best_params = cpu_state(model)

  save_checkpoint(args.out, best_params,
                  meta={"model": "plant", "config": dataclasses.asdict(pcfg),
                        "best_eval": best, "samples": len(ds),
                        "recipe": args.cmdline})
  out = {"samples": len(ds), "steps": args.steps, "best_eval": best,
         "evals": evals,
         "meta": {"cmdline": args.cmdline,
                  "n_vehicles": args.n_vehicles,
                  "towns": args.towns, "eval_towns": args.eval_towns,
                  "config": dataclasses.asdict(pcfg)}}
  print(json.dumps({k: v for k, v in out.items() if k != "evals"},
                   indent=1), flush=True)
  os.makedirs(os.path.dirname(args.results) or ".", exist_ok=True)
  with open(args.results, "w") as f:
    json.dump(out, f, indent=1)
  return out


def main(argv=None):
  run(parse_args(argv))


if __name__ == "__main__":
  main()
