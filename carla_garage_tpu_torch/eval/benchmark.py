"""Batched benchmark evaluation (port of carla_garage_tpu/eval/benchmark.py):
the leaderboard evaluator and its job farm replaced by batches on the card.

The reference evaluates Longest6 as 36 routes x 3 seeds, one job and one
CARLA server each. Here every route x repetition is one batch element:
``run_carla_benchmark`` runs a town's routes (or, with single_batch, every
town's) as one chunked rollout on the imported towns of an asset root, and
``run_synthetic_benchmark`` does the same on the procedural town. Records
follow the leaderboard's StatisticsManager JSON layout and the CSV summary
mirrors its result parser.

With a data-parallel ``mesh`` (``parallel/mesh.py``), the job farm's
axis: every rank builds the whole batch, padded to a multiple of the rank
count, keeps its contiguous slice of the episodes (with the slice of the
agent state and of every tick's draws) and rolls it out with no
collective inside the rollout, so ranks may stop after different chunk
counts. The records are then gathered in global episode order, padding
dropped, and every rank returns them all; rank 0 alone writes the
analysis files, and a caller writes the endpoint JSON and CSV on rank 0.
"""

from __future__ import annotations

import csv
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

from carla_garage_tpu_torch.config import GlobalConfig, longest6_config
from carla_garage_tpu_torch.device import resolve_device
from carla_garage_tpu_torch.eval.analysis import (events_from_criteria,
                                                  write_analysis)
from carla_garage_tpu_torch.maps import importer
from carla_garage_tpu_torch.parallel import mesh as mesh_lib
from carla_garage_tpu_torch.sim.episode import (rollout_chunked,
                                                rollout_recorded)
from carla_garage_tpu_torch.sim.expert import expert_step
from carla_garage_tpu_torch.sim.scenario_wiring import \
    build_benchmark_scenarios
from carla_garage_tpu_torch.sim.scene_builder import (build_batch,
                                                      compile_route,
                                                      make_synthetic_batch)
from carla_garage_tpu_torch.sim.scoring import compute_scores
from carla_garage_tpu_torch.structs import (ScenarioSpecs, ScenarioState,
                                            tree_map)

INFRACTION_KEYS = ("collisions_pedestrian", "collisions_vehicle",
                   "collisions_layout", "red_light", "stop_infraction")
CHUNK = 512                      # run_synthetic_benchmark's ticks a chunk
CARLA_CHUNK = 1024               # run_carla_benchmark's ticks a chunk
RECORD_CHUNK = 1000              # and with analysis_dir (recorded)


def _route_lens(scene) -> np.ndarray:
  """Each route's length in metres, summed on the host in float32."""
  seg = scene.route.seg_len.cpu().numpy()
  nv = scene.route.num_valid.cpu().numpy()
  return np.array([seg[i, :nv[i]].sum() for i in range(len(nv))])


def _records(cfg, scene, state, route_ids, town, first_index: int = 0):
  """One leaderboard record per episode (None route ids are skipped). The
  scores are computed on the state's device; criteria, scores and ticks
  then move to the host once. first_index: the global index of the
  batch's first episode (a data-parallel rank's offset)."""
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
        "index": first_index + i,
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
                              chunk: int | None = None, every: int = 10,
                              policy=expert_step,
                              generator: torch.Generator | None = None,
                              draw_fn=None):
  """Chunked rollout that also concatenates the decimated trajectory logs
  on the host, with rollout_chunked's early exit (chunk: RECORD_CHUNK
  when None). Returns (final state, {name: numpy [T,B,...]})."""
  chunk = chunk or RECORD_CHUNK
  chunks = []
  ticks = 0
  while ticks < max_ticks:
    state, traj = rollout_recorded(cfg, maps, lanes, scene, state, chunk,
                                   every=every, policy=policy,
                                   generator=generator, draw_fn=draw_fn)
    chunks.append({k: v.cpu().numpy() for k, v in traj.items()})
    ticks += chunk
    if bool(state.done.all()):
      break
  return state, {k: np.concatenate([c[k] for c in chunks], 0)
                 for k in chunks[0]}


def _pad_for_mesh(mesh, eps, ids, extras=()):
  """Pad the episode list to a multiple of the mesh size by repeating the
  last episode; padded ids become None so their records are dropped.
  Returns (eps, ids, extras) with every list padded in lockstep."""
  n = mesh.size
  pad = (-len(eps)) % n
  if pad:
    eps = list(eps) + [eps[-1]] * pad
    ids = list(ids) + [None] * pad
    extras = tuple(list(e) + [e[-1]] * pad for e in extras)
  return eps, ids, extras


def _shard_episode_batch(mesh, maps, lanes, scene, state):
  """The rank's slice of the episode batch; the town rasters and lanes
  whole on every rank (each rank built them, bit-equal) -- the job-farm
  axis of evaluate_routes_slurm.py:124-312 as a mesh axis."""
  B = int(scene.route.num_valid.shape[0])
  return (maps, lanes, mesh_lib.shard_leading(mesh, scene, B),
          mesh_lib.shard_leading(mesh, state, B))


def _sharded_draw_fn(mesh, policy, scene, state, generator):
  """A ``rollout`` draw_fn that draws each tick's draws for the whole
  (global) batch from `generator`, in the order one process draws them
  (the policy's ``draw_specs``, then the scenario engine's control-loss
  noise), and returns the rank's slice: n ranks then see the draws one
  process sees. None where the policy declares no ``draw_specs`` (the
  rank then draws its own from the generator)."""
  specs = getattr(policy, "draw_specs", None)
  if specs is None:
    return None
  specs = list(specs)
  if isinstance(scene.scenarios, ScenarioSpecs) and \
      isinstance(state.scenario, ScenarioState):
    specs.append(("control_loss", (scene.scenarios.kind.shape[1],),
                  "normal"))
  B = int(state.tick.shape[0])
  dev = state.tick.device

  def draw():
    d = {key: (torch.randn if kind == "normal" else torch.rand)(
        (B,) + tuple(shape), generator=generator, device=dev)
         for key, shape, kind in specs}
    return mesh_lib.shard_leading(mesh, d, B)

  return draw


def _gather_traj(mesh, traj: dict) -> dict:
  """Every rank's decimated log concatenated over the episodes. A rank
  that stopped earlier logged fewer snapshots: its last snapshot repeats
  (its episodes were done, and a done episode's state stays frozen)."""
  parts = mesh_lib.gather_objects(mesh, traj)
  T = max(next(iter(p.values())).shape[0] for p in parts)

  def pad(a):
    return np.concatenate([a, np.repeat(a[-1:], T - a.shape[0], 0)], 0)

  return {k: np.concatenate([pad(p[k]) for p in parts], 1) for k in traj}


def _scenario_setup(cfg, scen_ann, episodes, town, seed: int,
                    device="cuda"):
  """All 7 scenario types per episode: annotation-driven (1/3/4) and
  geometry-synthesized (2/5/6/7-10), ``sim/scenario_wiring.py``."""
  return build_benchmark_scenarios(cfg, town, episodes, scen_ann, seed,
                                   device=device)


def run_carla_benchmark(cfg: GlobalConfig = None, benchmark: str = "longest6",
                        reps: int = 1, towns: list | None = None,
                        n_vehicles: int = 8, n_walkers: int = 2,
                        max_ticks: int = 60000, seed: int = 0,
                        policy=expert_step, assets_root=None,
                        use_scenarios: bool = True,
                        single_batch: bool = False,
                        verbose: bool = True,
                        analysis_dir: str | None = None,
                        agent_reset=None, device="cuda", mesh=None):
  """Run a benchmark's routes (``leaderboard/data/{benchmark}.xml`` under
  `assets_root`, else $CGT_ASSETS_ROOT) on their imported towns.
  Returns (records, global record).

  Per town (the default), each town's routes x `reps` are one batch,
  rolled in chunks of CARLA_CHUNK ticks until every episode is done or
  `max_ticks` have run. single_batch=True runs every town's routes as one
  mixed-town batch and one rollout: the fastest mode for object-level
  policies; it holds every town's raster on the card at once.

  use_scenarios attaches all 7 scenario types (annotations and
  geometry-synthesized triggers). analysis_dir (per-town mode) records
  decimated trajectories and writes the result parser's artifacts there:
  per-town infraction maps and replay clips (``eval/analysis.py``, which
  needs matplotlib).

  policy: a ``sim_step`` policy closure (the expert by default, or a
  learned agent's, which carries its weights); agent_reset(cfg, B,
  device=...) gives the agent state installed as ``state.agent`` before
  the rollout. Each rollout draws from a ``torch.Generator`` seeded with
  `seed`.

  mesh: a data-parallel mesh (``parallel/mesh.py``) whose ranks each call
  this with the same arguments. The episode batch is padded to a multiple
  of the rank count and sharded over the ranks, each rolling out its own
  slice; every rank returns all records, in episode order."""
  cfg = cfg or (longest6_config() if benchmark == "longest6"
                else GlobalConfig())
  dev = resolve_device(device)
  root = importer.resolve_assets_root(assets_root)
  routes = importer.load_benchmark_routes(benchmark, root)
  by_town = defaultdict(list)
  for r in routes:
    if towns is None or r.town in towns:
      by_town[r.town].append(r)
  gen = lambda: torch.Generator(device=dev).manual_seed(seed)

  if single_batch:
    return _run_single_batch(cfg, by_town, root, reps, n_vehicles,
                             n_walkers, max_ticks, seed, policy,
                             use_scenarios, verbose, agent_reset, dev,
                             gen(), mesh=mesh)

  records = []
  for town_name, town_routes in sorted(by_town.items()):
    t0 = time.time()
    imported = importer.load_town(town_name, root, rng_seed=seed)
    eps, ids, polys = [], [], []
    # compile once, reuse across reps
    compiled = []
    town_adapter = importer.as_synthetic_town(imported, [
        r.keypoints_xy for r in town_routes])
    for r in town_routes:
      ep = compile_route(town_adapter, r.keypoints_xy, r.keypoints_yaw)
      compiled.append(ep)
      polys.append(ep.dense)
    town_adapter = importer.as_synthetic_town(imported, polys)
    for rep in range(reps):
      for r, ep in zip(town_routes, compiled):
        eps.append(ep)
        ids.append(f"{r.route_id}_rep{rep}")
    if mesh is not None:
      eps, ids, _ = _pad_for_mesh(mesh, eps, ids)
    walker_sites = None
    scenario_npcs = None
    if use_scenarios:
      scen_ann = importer.load_scenarios(town_name, root)
      walker_sites, specs, scen_state, scenario_npcs = _scenario_setup(
          cfg, scen_ann, eps, town_adapter, seed, device=dev)
    maps, lanes, scene, state = build_batch(
        cfg, town_adapter, eps, seed=seed, n_vehicles=n_vehicles,
        n_walkers=n_walkers, walker_sites=walker_sites,
        scenario_npcs=scenario_npcs, device=dev)
    if use_scenarios:
      scene = scene.replace(scenarios=specs)
      state = state.replace(scenario=scen_state)
    if agent_reset is not None:
      state = state.replace(agent=agent_reset(cfg, len(eps), device=dev))
    generator, sharded, first = gen(), {}, 0
    if mesh is not None:
      sharded["draw_fn"] = _sharded_draw_fn(mesh, policy, scene, state,
                                            generator)
      maps, lanes, scene, state = _shard_episode_batch(
          mesh, maps, lanes, scene, state)
      part = mesh_lib.shard_slice(mesh, len(eps))
      ids, first = ids[part], part.start
    if analysis_dir:
      final, traj = _rollout_chunked_recorded(
          cfg, maps, lanes, scene, state, max_ticks, policy=policy,
          generator=generator, **sharded)
    else:
      final = rollout_chunked(cfg, maps, lanes, scene, state, max_ticks,
                              chunk=CARLA_CHUNK, policy=policy,
                              generator=generator, **sharded)
    recs = _records(cfg, scene, final, ids, town_name, first_index=first)
    if mesh is not None:
      recs = mesh_lib.gather_records(mesh, recs)
      if analysis_dir:
        traj = _gather_traj(mesh, traj)
    records += recs
    if analysis_dir and (mesh is None or mesh.rank == 0):
      tw = town_adapter
      write_analysis(
          analysis_dir,
          {town_name: (np.asarray(tw.raster), np.asarray(tw.world_offset),
                       float(tw.ppm))},
          {town_name: [(r["index"], r["events"]) for r in recs]},
          {town_name: [ep.dense for ep in compiled]},
          {town_name: traj})
    if verbose:
      ds = np.mean([x["scores"]["score_composed"] for x in recs])
      print(f"{town_name}: {len(recs)} episodes, DS {ds:.1f}, "
            f"{time.time() - t0:.0f}s", flush=True)
  return records, aggregate(records)


def _run_single_batch(cfg, by_town, root, reps, n_vehicles, n_walkers,
                      max_ticks, seed, policy, use_scenarios, verbose,
                      agent_reset, device, generator, mesh=None):
  """All routes of all towns in one mixed-town batch and one rollout
  (under a mesh, the rank's slice of it)."""
  t0 = time.time()
  towns, eps, ids, town_idx, town_names, anns = [], [], [], [], [], []
  for ti, (town_name, town_routes) in enumerate(sorted(by_town.items())):
    imported = importer.load_town(town_name, root, rng_seed=seed)
    adapter = importer.as_synthetic_town(imported, [])
    towns.append(adapter)
    ann = importer.load_scenarios(town_name, root) if use_scenarios else {}
    for r in town_routes:
      ep = compile_route(adapter, r.keypoints_xy, r.keypoints_yaw)
      for rep in range(reps):
        eps.append(ep)
        ids.append(f"{r.route_id}_rep{rep}")
        town_idx.append(ti)
        town_names.append(town_name)
        anns.append(ann)
  if mesh is not None:
    eps, ids, (town_idx, town_names, anns) = _pad_for_mesh(
        mesh, eps, ids, (town_idx, town_names, anns))
  if verbose:
    print(f"compiled {len(eps)} episodes over {len(towns)} towns "
          f"in {time.time() - t0:.0f}s", flush=True)

  walker_sites = None
  scenario_npcs = None
  if use_scenarios:
    towns_of_eps = [towns[ti] for ti in town_idx]
    walker_sites, specs, scen_state, scenario_npcs = _scenario_setup(
        cfg, anns, eps, towns_of_eps, seed, device=device)
  maps, lanes, scene, state = build_batch(
      cfg, towns, eps, seed=seed, n_vehicles=n_vehicles,
      n_walkers=n_walkers, walker_sites=walker_sites,
      town_of_episode=town_idx, scenario_npcs=scenario_npcs, device=device)
  if use_scenarios:
    scene = scene.replace(scenarios=specs)
    state = state.replace(scenario=scen_state)
  if agent_reset is not None:
    state = state.replace(agent=agent_reset(cfg, len(eps), device=device))
  sharded = {}
  if mesh is not None:
    sharded["draw_fn"] = _sharded_draw_fn(mesh, policy, scene, state,
                                          generator)
    maps, lanes, scene, state = _shard_episode_batch(mesh, maps, lanes,
                                                     scene, state)
    part = mesh_lib.shard_slice(mesh, len(eps))
    ids, town_names = ids[part], town_names[part]
  t1 = time.time()
  final = rollout_chunked(cfg, maps, lanes, scene, state, max_ticks,
                          chunk=CARLA_CHUNK, policy=policy,
                          generator=generator, **sharded)
  records = []
  for i, (rid, tn) in enumerate(zip(ids, town_names)):
    records += _records(cfg, tree_slice(scene, i), tree_slice(final, i),
                        [rid], tn)
  records = mesh_lib.gather_records(mesh, records)
  if verbose:
    print(f"rollout: {len(eps)} episodes in {time.time() - t1:.0f}s",
          flush=True)
  return records, aggregate(records)


def tree_slice(tree, i: int):
  """Episode i of a batched struct, as a batch of one: every tensor leaf
  with a leading axis is cut to [i:i+1]."""
  return tree_map(lambda x: x[i:i + 1] if x.ndim >= 1 else x, tree)


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
