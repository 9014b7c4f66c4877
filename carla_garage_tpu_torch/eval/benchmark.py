"""Batched benchmark evaluation (port of the synthetic-town runner and the
record helpers of carla_garage_tpu/eval/benchmark.py).

Every route x repetition is one batch element, and a batch runs as one
chunked rollout. Records follow the leaderboard's StatisticsManager JSON
layout and the CSV summary mirrors its result parser. The runs on imported
CARLA benchmark towns (``run_carla_benchmark``) need the town importer and
its assets, and the episode sharding over several cards needs the
multi-GPU layer: neither is ported yet.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np
import torch

from carla_garage_tpu_torch.config import GlobalConfig, longest6_config
from carla_garage_tpu_torch.eval.analysis import events_from_criteria
from carla_garage_tpu_torch.sim.episode import (rollout_chunked,
                                                rollout_recorded)
from carla_garage_tpu_torch.sim.expert import expert_step
from carla_garage_tpu_torch.sim.scene_builder import make_synthetic_batch
from carla_garage_tpu_torch.sim.scoring import compute_scores

INFRACTION_KEYS = ("collisions_pedestrian", "collisions_vehicle",
                   "collisions_layout", "red_light", "stop_infraction")
CHUNK = 512                      # run_synthetic_benchmark's ticks a chunk


def _route_lens(scene) -> np.ndarray:
  """Each route's length in metres, summed on the host in float32."""
  seg = scene.route.seg_len.cpu().numpy()
  nv = scene.route.num_valid.cpu().numpy()
  return np.array([seg[i, :nv[i]].sum() for i in range(len(nv))])


def _records(cfg, scene, state, route_ids, town):
  """One leaderboard record per episode (None route ids are skipped). The
  scores are computed on the state's device; criteria, scores and ticks
  then move to the host once."""
  lens = _route_lens(scene)
  cr_dev = state.criteria
  scores = compute_scores(cfg, cr_dev, torch.as_tensor(
      lens, device=cr_dev.penalty.device))
  cr, scores = cr_dev.to("cpu"), scores.to("cpu")
  tick = state.tick.cpu().numpy()
  completed = scores.completed.numpy()
  score = {k: getattr(scores, k).numpy()
           for k in ("score_route", "score_penalty", "score_composed")}
  flags = {k: getattr(cr, k).numpy()
           for k in ("blocked", "timed_out", "deviated")}
  counts = {
      "collisions_pedestrian": cr.n_collision_walker.numpy(),
      "collisions_vehicle": cr.n_collision_vehicle.numpy(),
      "collisions_layout": cr.n_collision_static.numpy(),
      "red_light": cr.n_red_light.numpy(),
      "stop_infraction": cr.n_stop_sign.numpy(),
  }
  recs = []
  for i, rid in enumerate(route_ids):
    if rid is None:                      # padding episode
      continue
    status = "Completed" if bool(completed[i]) else "Failed"
    if bool(flags["blocked"][i]):
      status += " - Agent got blocked"
    elif bool(flags["timed_out"][i]):
      status += " - Agent timed out"
    elif bool(flags["deviated"][i]):
      status += " - Agent deviated from the route"
    recs.append({
        "route_id": rid,
        "town": town,
        "index": i,
        "status": status,
        "infractions": {k: int(counts[k][i]) for k in INFRACTION_KEYS},
        "events": events_from_criteria(cr, i),
        "scores": {k: float(v[i]) for k, v in score.items()},
        "meta": {"route_length": float(lens[i]),
                 "duration_game": float(tick[i]) / 20.0},
    })
  return recs


def aggregate(records):
  """compute_global_statistics analog: means over the records and the
  infractions per km driven."""
  n = max(len(records), 1)
  out = {
      "driving_score": sum(r["scores"]["score_composed"]
                           for r in records) / n,
      "route_completion": sum(r["scores"]["score_route"]
                              for r in records) / n,
      "infraction_score": sum(r["scores"]["score_penalty"]
                              for r in records) / n,
      "num_routes": len(records),
  }
  for k in INFRACTION_KEYS:
    km = sum(max(r["scores"]["score_route"] / 100.0 *
                 r["meta"]["route_length"] / 1000.0, 1e-3)
             for r in records)
    out[f"{k}_per_km"] = sum(r["infractions"][k] for r in records) / km
  return out


def run_synthetic_benchmark(cfg: GlobalConfig = None, n_routes: int = 8,
                            reps: int = 1, seed: int = 0,
                            n_vehicles: int = 8, n_walkers: int = 2,
                            max_ticks: int = 6000, policy=expert_step,
                            device="cuda",
                            generator: torch.Generator | None = None):
  """Self-contained benchmark on the procedural town: `reps` batches of
  `n_routes` routes, each rolled in chunks of CHUNK ticks until done or
  max_ticks. Returns (records, global record)."""
  cfg = cfg or longest6_config()
  records = []
  for rep in range(reps):
    _, maps, lanes, scene, state = make_synthetic_batch(
        cfg, batch=n_routes, seed=seed + 1000 * rep,
        n_vehicles=n_vehicles, n_walkers=n_walkers, device=device)
    final = rollout_chunked(cfg, maps, lanes, scene, state, max_ticks,
                            chunk=CHUNK, policy=policy, generator=generator)
    records += _records(cfg, scene, final,
                        [f"synth_{i}_rep{rep}" for i in range(n_routes)],
                        "SynthTown")
  return records, aggregate(records)


def _rollout_chunked_recorded(cfg, maps, lanes, scene, state, max_ticks,
                              chunk: int = 1000, every: int = 10,
                              policy=expert_step,
                              generator: torch.Generator | None = None):
  """Chunked rollout that also concatenates the decimated trajectory logs
  on the host, with rollout_chunked's early exit. Returns (final state,
  {name: numpy [T,B,...]})."""
  chunks = []
  ticks = 0
  while ticks < max_ticks:
    state, traj = rollout_recorded(cfg, maps, lanes, scene, state, chunk,
                                   every=every, policy=policy,
                                   generator=generator)
    chunks.append({k: v.cpu().numpy() for k, v in traj.items()})
    ticks += chunk
    if bool(state.done.all()):
      break
  return state, {k: np.concatenate([c[k] for c in chunks], 0)
                 for k in chunks[0]}


def write_endpoint(records, global_stats, path: str, meta: dict = None):
  """Leaderboard-style results JSON (the checkpoint endpoint layout);
  `meta` records the invocation (NPC counts, seeds, capacity) so the run
  can be reproduced from the file alone."""
  data = {"_checkpoint": {"records": records,
                          "global_record": global_stats},
          "values": [global_stats["driving_score"],
                     global_stats["route_completion"],
                     global_stats["infraction_score"]],
          "labels": ["Avg. driving score", "Avg. route completion",
                     "Avg. infraction penalty"]}
  if meta is not None:
    data["meta"] = meta
  with open(path, "w") as f:
    json.dump(data, f, indent=2)


def print_table(records):
  """Per-route results table."""
  hdr = f"{'route':>10} {'town':>8} {'DS':>7} {'RC':>7} {'IS':>6}  status"
  lines = [hdr, "-" * len(hdr)]
  for r in records:
    s = r["scores"]
    lines.append(f"{r['route_id']:>10} {r['town']:>8} "
                 f"{s['score_composed']:>7.2f} {s['score_route']:>7.2f} "
                 f"{s['score_penalty']:>6.3f}  {r['status']}")
  print("\n".join(lines), flush=True)


def load_completed(endpoint_path: str) -> set:
  """Route ids already completed in a results endpoint (for resuming)."""
  if not os.path.exists(endpoint_path):
    return set()
  with open(endpoint_path) as f:
    data = json.load(f)
  return {r["route_id"] for r in data.get("_checkpoint", {}).get(
      "records", []) if r["status"].startswith("Completed")}


def write_csv(records, path: str):
  """Per-route CSV summary."""
  with open(path, "w", newline="") as f:
    w = csv.writer(f)
    w.writerow(["route_id", "town", "status", "DS", "RC", "IS"] +
               list(INFRACTION_KEYS))
    for r in records:
      w.writerow([r["route_id"], r["town"], r["status"],
                  f"{r['scores']['score_composed']:.2f}",
                  f"{r['scores']['score_route']:.2f}",
                  f"{r['scores']['score_penalty']:.3f}"] +
                 [r["infractions"][k] for k in INFRACTION_KEYS])
