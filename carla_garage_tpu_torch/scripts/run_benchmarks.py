"""Run the benchmark suite (Longest6 + LAV) on the imported CARLA towns and
write leaderboard-format results (port of scripts/run_benchmarks.py).

The honest configuration (100 town-wide NPCs an episode, all 7 scenario
types, synthesized signals):

  python -m carla_garage_tpu_torch.scripts.run_benchmarks --honest --reps 3

and the reference's density (500 vehicles a route):

  python -m carla_garage_tpu_torch.scripts.run_benchmarks --honest \\
      --n-vehicles 500 --capacity 500

The routes, towns and scenario annotations are read from --assets-root (a
checkout of the reference with ``leaderboard/data`` and
``team_code/birds_eye_view/maps``); each town's lane-graph recovery is
cached under $CGT_TOWN_CACHE. --agent transfuser and --agent plant drive
a checkpoint that this package's training scripts saved
(``utils/checkpoint.py``: ``state.pt`` + ``meta.json``); the JAX
package's orbax checkpoints are not read. Every results JSON carries the
invocation under `meta`, and goes with a CSV to --results-dir
(results/torch/ by default) as ``{benchmark}_{agent}{suffix}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from carla_garage_tpu_torch.config import GlobalConfig, longest6_config
from carla_garage_tpu_torch.device import resolve_device
from carla_garage_tpu_torch.eval.benchmark import (print_table,
                                                   run_carla_benchmark,
                                                   write_csv, write_endpoint)
from carla_garage_tpu_torch.utils.checkpoint import (config_from_meta,
                                                     load_checkpoint)


def parse_args(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--reps", type=int, default=1)
  ap.add_argument("--benchmarks", nargs="+",
                  default=["longest6", "lav"])
  ap.add_argument("--single-batch", action="store_true")
  ap.add_argument("--no-scenarios", action="store_true")
  ap.add_argument("--n-vehicles", type=int, default=None,
                  help="NPC vehicles per episode (default: 8; --honest: 100;"
                       " reference Longest6 density: 500)")
  ap.add_argument("--n-walkers", type=int, default=2)
  ap.add_argument("--capacity", type=int, default=None,
                  help="vehicle slot capacity (config.sim.max_vehicles); "
                       "raised automatically to fit --n-vehicles")
  ap.add_argument("--honest", action="store_true",
                  help="the headline configuration: 100 NPCs, scenarios on")
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--suffix", default=None)
  ap.add_argument("--analysis-dir", default=None,
                  help="write per-town infraction maps and replay clips "
                       "here (needs matplotlib)")
  ap.add_argument("--agent", default="expert",
                  choices=["expert", "transfuser", "plant", "simlingo"],
                  help="expert = privileged autopilot; transfuser = a "
                       "trained sensor-fusion checkpoint (--checkpoint); "
                       "plant = a trained object-level PlanT checkpoint; "
                       "simlingo = a camera-only SimLingo checkpoint")
  ap.add_argument("--checkpoint", default=None,
                  help="a checkpoint directory saved by this package's "
                       "train_transfuser / train_plant (state.pt + "
                       "meta.json). The JAX package's orbax checkpoints "
                       "need JAX and orbax to read and are not supported")
  ap.add_argument("--uncertainty-threshold", type=float, default=0.33,
                  help="brake-probability override (the reference "
                       "Longest6 op point)")
  ap.add_argument("--jpeg-quality", type=int, default=None)
  ap.add_argument("--max-ticks", type=int, default=60000)
  ap.add_argument("--towns", nargs="+", default=None,
                  help="restrict to these towns (per-town invocations are "
                       "the fault-isolation protocol for the 500-NPC "
                       "reference-density rows)")
  ap.add_argument("--assets-root", default=None,
                  help="the CARLA asset root (default: "
                       "$CGT_ASSETS_ROOT)")
  ap.add_argument("--results-dir", default="results/torch")
  args = ap.parse_args(argv)
  if args.honest and args.no_scenarios:
    ap.error("--honest requires scenarios on")
  if args.agent != "expert" and not args.checkpoint:
    ap.error(f"--agent {args.agent} requires --checkpoint")
  args.cmdline = " ".join(sys.argv if argv is None else
                          ["run_benchmarks"] + list(argv))
  return args


def build_agent(args, device):
  """(policy, agent_reset) for --agent: (None, None) for the expert, else
  the learned agent's policy closure over the checkpoint's weights on
  `device` and its agent-state reset."""
  if args.agent == "expert":
    return None, None
  _, meta = load_checkpoint(args.checkpoint, meta_only=True)
  if meta and meta.get("model") not in (None, args.agent):
    raise ValueError(f"{args.checkpoint} holds a {meta['model']!r} "
                     f"checkpoint, not {args.agent!r}")
  has_cfg = bool(meta and meta.get("config"))
  if args.agent == "plant":
    from carla_garage_tpu_torch.agents.plant_agent import (
        make_plant_policy, plant_agent_reset)
    from carla_garage_tpu_torch.models.plant import PlanT, PlanTConfig
    pcfg = config_from_meta(dict(meta, model="plant")) if has_cfg \
        else PlanTConfig()
    model = PlanT(pcfg)
    load_checkpoint(args.checkpoint, model)
    policy = make_plant_policy(
        model.to(device), None, pcfg, direct=True,
        brake_threshold=args.uncertainty_threshold)
    return policy, plant_agent_reset
  from carla_garage_tpu_torch.agents.sensor_agent import (
      make_sensor_policy, sensor_grids)
  base = GlobalConfig()
  if args.agent == "simlingo":
    from carla_garage_tpu_torch.models.vla import SimLingo, SimLingoConfig
    tcfg = config_from_meta(dict(meta, model="simlingo")) if has_cfg \
        else SimLingoConfig()
    model, scale = SimLingo(tcfg), 1
  else:
    from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                          TransfuserConfig)
    tcfg = config_from_meta(dict(meta, model="transfuser")) if has_cfg \
        else TransfuserConfig()
    model = LidarCenterNet(tcfg)
    scale = max(base.sensor.camera_height // tcfg.img_h, 1)
  load_checkpoint(args.checkpoint, model)
  return make_sensor_policy(
      model.to(device), None, tcfg, sensor_grids(base, tcfg, scale, scale),
      direct=True, bf16=True, brake_threshold=args.uncertainty_threshold,
      jpeg_quality=args.jpeg_quality)


def run(args, device="cuda", assets_root: str | None = None) -> dict:
  """The suite of ``main`` on parsed arguments: one endpoint JSON and CSV
  per benchmark. assets_root overrides --assets-root. Returns
  {benchmark: {"records", "global", "json", "csv"}}."""
  dev = resolve_device(device)
  root = assets_root or args.assets_root
  n_vehicles = args.n_vehicles if args.n_vehicles is not None else \
      (100 if args.honest else 8)
  capacity = args.capacity or max(32, n_vehicles)
  os.makedirs(args.results_dir, exist_ok=True)
  policy, agent_reset = build_agent(args, dev)

  out = {}
  for bench in args.benchmarks:
    cfg = longest6_config() if bench == "longest6" else GlobalConfig()
    cfg = cfg.replace(sim=dataclasses.replace(cfg.sim,
                                              max_vehicles=capacity))
    t0 = time.time()
    kw = {} if policy is None else dict(policy=policy,
                                        agent_reset=agent_reset)
    records, g = run_carla_benchmark(
        cfg=cfg, benchmark=bench, reps=args.reps, towns=args.towns,
        n_vehicles=n_vehicles, n_walkers=args.n_walkers,
        use_scenarios=not args.no_scenarios,
        single_batch=args.single_batch, seed=args.seed,
        analysis_dir=args.analysis_dir, max_ticks=args.max_ticks,
        assets_root=root, device=dev, **kw)
    wall = time.time() - t0
    print_table(records)
    print(f"{bench}: {json.dumps(g)} ({wall:.0f}s)", flush=True)
    suffix = args.suffix if args.suffix is not None else (
        f"_r{args.reps}" + ("_honest" if args.honest else "") +
        (f"_v{n_vehicles}" if args.n_vehicles is not None else "") +
        ("_sb" if args.single_batch else ""))
    meta = {
        "benchmark": bench, "reps": args.reps,
        "n_vehicles": n_vehicles, "n_walkers": args.n_walkers,
        "capacity": capacity, "seed": args.seed,
        "scenarios": not args.no_scenarios,
        "single_batch": args.single_batch,
        "towns": args.towns,
        "wall_s": round(wall, 1),
        "cmdline": args.cmdline,
    }
    if args.agent != "expert":
      meta["checkpoint"] = args.checkpoint
      meta["uncertainty_threshold"] = args.uncertainty_threshold
      meta["jpeg_quality"] = args.jpeg_quality
    stem = os.path.join(args.results_dir, f"{bench}_{args.agent}{suffix}")
    write_endpoint(records, g, stem + ".json", meta=meta)
    write_csv(records, stem + ".csv")
    out[bench] = {"records": records, "global": g, "json": stem + ".json",
                  "csv": stem + ".csv"}
  return out


def main(argv=None):
  run(parse_args(argv))


if __name__ == "__main__":
  main()
