"""DAgger A/B at matched total optimizer steps on the port (port of
scripts/dagger_ab.py).

Both arms train PlanT on the same BC dataset with the same segment sizes
and are scored by the same honest-density eval suite:

  arm "bc":     segments x seg_steps, all on expert BC data;
  arm "dagger": segment 0 on BC data; before each later segment the
                current model drives fresh scenes while the expert labels
                the visited states, and the next segment trains on the
                BC + DAgger mix (DAgger samples carry waypoint weight 0:
                the recorded trajectory is the policy's own).

  python -m carla_garage_tpu_torch.scripts.dagger_ab \\
      --towns synth synth2 --eval-towns synth3 --segments 3 --seg-steps 2000

The flags and defaults are the JAX script's; town names are checked
before any datagen (only 'synth' / 'synth<N>' are ported). The table goes
to results/torch/dagger_ab_plant_r5.json by default.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from carla_garage_tpu_torch.agents.plant_agent import (make_plant_policy,
                                                       plant_agent_reset)
from carla_garage_tpu_torch.device import resolve_device
from carla_garage_tpu_torch.scripts.train_plant import (CHUNK,
                                                        collect_chunked,
                                                        concat_datasets,
                                                        datagen_shard,
                                                        honest_cfg,
                                                        plant_config,
                                                        plant_eval_suite)
from carla_garage_tpu_torch.sim.datagen import collect_dagger_frames
from carla_garage_tpu_torch.sim.scene_builder import (make_town_batch,
                                                      require_ported_towns)
from carla_garage_tpu_torch.train.plant_train import (build_plant_dataset,
                                                      estimate_speed_weights,
                                                      train_plant)


def collect_dagger_ds(cfg, pcfg, args, model, params, town_name: str,
                      seed: int, device="cuda"):
  """On-policy frames driven by `model` (with `params`, a state dict, or
  None for its own weights), expert labels along the visited trajectory,
  waypoint supervision off (wp_weight 0)."""
  dev = resolve_device(device)
  _, maps, lanes, scene, state = make_town_batch(
      cfg, town_name, batch=args.episodes, seed=seed,
      n_vehicles=args.n_vehicles, n_walkers=2, use_scenarios=True,
      min_route_m=args.min_route_m, max_route_m=args.max_route_m,
      device=dev)
  policy = make_plant_policy(model, params, pcfg, direct=True,
                             brake_threshold=0.33)
  st = state.replace(agent=plant_agent_reset(cfg, args.episodes, device=dev))
  gen = torch.Generator(device=dev).manual_seed(seed)
  _, frames = collect_chunked(
      lambda s: collect_dagger_frames(cfg, maps, lanes, scene, s, policy,
                                      CHUNK, generator=gen),
      st, args.dagger_frames // CHUNK)
  ds = build_plant_dataset(cfg, pcfg, frames, scene)
  ds.wp_weight = torch.zeros((len(ds),), dtype=torch.float32, device=dev)
  return ds


def run_arm(name: str, cfg, pcfg, args, bc_ds, eval_seeds,
            eval_chunk: int = 512, device="cuda"):
  """One arm's segments, then the eval suite; returns the suite's summary
  with the arm's name and its total steps."""
  dev = resolve_device(device)
  model, params, speed_weights = None, None, None
  t0 = time.time()
  train_ds = bc_ds
  for seg in range(args.segments):
    if name == "dagger" and seg > 0:
      dag_town = args.towns[(seg * 2 + 1) % len(args.towns)]
      dag = collect_dagger_ds(cfg, pcfg, args, model, None, dag_town,
                              seed=9000 + 31 * seg, device=dev)
      print(f"[{name}] dagger collect seg{seg} [{dag_town}]: "
            f"{len(dag)} frames", flush=True)
      train_ds = concat_datasets([bc_ds, dag] if seg == 1 else
                                 [train_ds, dag])
    if seg == 0:
      speed_weights = estimate_speed_weights(train_ds)
    model, hist = train_plant(
        cfg, pcfg, train_ds, steps=args.seg_steps, batch_size=args.batch,
        lr=args.lr, params=params, log_every=args.seg_steps,
        speed_weights=speed_weights)
    params = model.state_dict()
    print(f"[{name}] segment {seg}: loss {hist[-1]['loss']:.3f} "
          f"({time.time()-t0:.0f}s)", flush=True)
  ev = plant_eval_suite(cfg, model, None, pcfg, args.eval_towns,
                        eval_seeds, args.eval_routes, args,
                        max_ticks=args.eval_max_ticks, chunk=eval_chunk,
                        device=dev)
  ev["arm"] = name
  ev["total_steps"] = args.segments * args.seg_steps
  return ev


def verdict(rows) -> tuple:
  """(delta DS of dagger over bc, noise, verdict): the difference counts
  only beyond the larger of the two arms' DS spreads."""
  delta = rows[1]["DS"] - rows[0]["DS"]
  noise = max(rows[0]["DS_std"], rows[1]["DS_std"])
  word = ("dagger helps" if delta > noise else
          "dagger hurts" if delta < -noise else "within noise")
  return delta, noise, word


def parse_args(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--segments", type=int, default=3)
  ap.add_argument("--seg-steps", type=int, default=2000)
  ap.add_argument("--batch", type=int, default=512)
  ap.add_argument("--lr", type=float, default=3e-4)
  ap.add_argument("--shards", type=int, default=6)
  ap.add_argument("--episodes", type=int, default=16)
  ap.add_argument("--frames", type=int, default=400)
  ap.add_argument("--dagger-frames", type=int, default=100)
  ap.add_argument("--n-vehicles", type=int, default=100)
  ap.add_argument("--n-walkers", type=int, default=2)
  ap.add_argument("--towns", nargs="+",
                  default=["Town01", "Town02", "Town03", "Town04",
                           "Town05", "Town06"])
  ap.add_argument("--eval-towns", nargs="+", default=["Town02", "Town05"])
  ap.add_argument("--eval-seeds", type=int, default=2)
  ap.add_argument("--eval-routes", type=int, default=8)
  ap.add_argument("--eval-max-ticks", type=int, default=10000)
  ap.add_argument("--min-route-m", type=float, default=300.0)
  ap.add_argument("--max-route-m", type=float, default=500.0)
  ap.add_argument("--results",
                  default="results/torch/dagger_ab_plant_r5.json")
  args = ap.parse_args(argv)
  args.cmdline = " ".join(sys.argv if argv is None else
                          ["dagger_ab"] + list(argv))
  return args


def run(args, eval_chunk: int = 512, device="cuda") -> dict:
  """The A/B of ``main`` on parsed arguments; returns the results dict
  (also written to --results)."""
  require_ported_towns(list(args.towns) + list(args.eval_towns))
  dev = resolve_device(device)
  pcfg = plant_config()
  cfg = honest_cfg(args.n_vehicles)

  parts = []
  for i in range(args.shards):
    town_name = args.towns[i % len(args.towns)]
    ds, n_clean = datagen_shard(cfg, pcfg, args, town_name,
                                seed=2000 + 61 * i, device=dev)
    parts.append(ds)
    print(f"bc shard {i} [{town_name}]: {len(ds)} samples "
          f"({n_clean}/{args.episodes} clean)", flush=True)
  bc_ds = concat_datasets(parts)
  print(f"bc dataset: {len(bc_ds)} samples", flush=True)

  eval_seeds = [4321 + 11 * s for s in range(args.eval_seeds)]
  rows = [run_arm(name, cfg, pcfg, args, bc_ds, eval_seeds, eval_chunk,
                  dev) for name in ("bc", "dagger")]
  for r in rows:
    print(f"{r['arm']:>7}: DS {r['DS']:.1f}±{r['DS_std']:.1f} "
          f"RC {r['RC']:.1f} IS {r['IS']:.2f} "
          f"coll_veh {r['coll_veh']:.2f} blocked {r['blocked']:.2f}",
          flush=True)
  delta, noise, word = verdict(rows)
  out = {"arms": rows, "delta_DS": delta, "noise_std": noise,
         "verdict": word,
         "meta": {"cmdline": args.cmdline,
                  "matched_total_steps": args.segments * args.seg_steps,
                  "n_vehicles": args.n_vehicles,
                  "eval_seeds": eval_seeds}}
  print(json.dumps({k: v for k, v in out.items() if k != "arms"},
                   indent=1), flush=True)
  os.makedirs(os.path.dirname(args.results) or ".", exist_ok=True)
  with open(args.results, "w") as f:
    json.dump(out, f, indent=1)
  return out


def main(argv=None):
  run(parse_args(argv))


if __name__ == "__main__":
  main()
