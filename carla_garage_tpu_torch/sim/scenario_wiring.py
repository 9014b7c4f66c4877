"""Benchmark scenario wiring: all 7 srunner scenario types for a batch of
routes (port of carla_garage_tpu/sim/scenario_wiring.py; numpy until the
specs are made).

Annotated types come from the town's annotation file where it has one;
the rest are synthesized from route and lane-graph geometry where the
reference would put them:

  Scenario1  CONTROL_LOSS          annotation transforms (steer disturbance)
  Scenario3/4 CROSSING_WALKER      annotation transforms (walker spawns)
  Scenario2  FOLLOW_LEADING        a held leader on the ego lane
  Scenario5  OTHER_LEADING         a slow leader ahead for a long stretch
  Scenario6  OPPOSITE_DIRECTION    a held vehicle on the opposing lane that
                                   starts toward the ego when triggered
  Scenario7-10 JUNCTION_CROSSING   a held vehicle on a crossing approach of
                                   a route junction, crossing when the ego
                                   nears

Each synthesized actor takes one of the LAST vehicle slots (the scene
builder's ``scenario_npcs``), so the specs address it deterministically.
"""

from __future__ import annotations

import numpy as np
import torch

from carla_garage_tpu_torch.maps import importer
from carla_garage_tpu_torch.sim.scenarios import (ScenarioType,
                                                  make_empty_specs,
                                                  scenarios_reset)
from carla_garage_tpu_torch.sim.triggers import TriggerKind

MAX_SLOTS = 8      # scenario spec rows per episode


def _lane_samples(town):
  """(pts [M,2], yaw [M], lane_id [M], arc_t [M]) over all town lanes,
  cached on the town."""
  key = "_scenario_lane_samples"
  cached = getattr(town, key, None) if not isinstance(town, dict) else None
  if cached is not None:
    return cached
  pts, yaws, lids, arcs = [], [], [], []
  for li, poly in enumerate(town.lane_polys):
    poly = np.asarray(poly, np.float32)
    if len(poly) < 2:
      continue
    seg = np.linalg.norm(np.diff(poly, axis=0), axis=-1)
    arc = np.concatenate([[0.0], np.cumsum(seg)])
    if arc[-1] < 4.0:
      continue
    t = np.arange(0.0, arc[-1], 2.0)
    xs = np.interp(t, arc, poly[:, 0])
    ys = np.interp(t, arc, poly[:, 1])
    pts.append(np.stack([xs, ys], -1))
    yaws.append(np.arctan2(np.gradient(ys), np.gradient(xs)))
    lids.append(np.full(len(t), li, np.int32))
    arcs.append(t)
  out = (np.concatenate(pts).astype(np.float32), np.concatenate(yaws),
         np.concatenate(lids), np.concatenate(arcs).astype(np.float32))
  try:
    object.__setattr__(town, key, out)
  except Exception:
    pass
  return out


def _nearest_lane(town, pos, want_yaw=None, max_dist=8.0,
                  yaw_tol=1.0):
  """Nearest lane sample to pos (optionally direction-matched).
  Returns (lane_id, arc_t, pt, yaw) or None."""
  pts, yaws, lids, arcs = _lane_samples(town)
  if not len(pts):
    return None
  d = np.linalg.norm(pts - pos[None], axis=-1)
  if want_yaw is not None:
    dy = np.abs(np.arctan2(np.sin(yaws - want_yaw), np.cos(yaws - want_yaw)))
    d = np.where(dy < yaw_tol, d, np.inf)
  i = int(np.argmin(d))
  if not np.isfinite(d[i]) or d[i] > max_dist:
    return None
  return int(lids[i]), float(arcs[i]), pts[i], float(yaws[i])


def _route_yaw(dense, i):
  i = min(i, len(dense) - 2)
  d = dense[i + 1] - dense[i]
  return float(np.arctan2(d[1], d[0]))


def _route_clear(dense, pos, lo, hi, clearance=3.0):
  """True if pos stays >= clearance metres from every dense route point
  OUTSIDE the index window [lo, hi): a route can pass the same junction
  twice, and an actor meant for a crossing approach must not park on a
  later leg of the same route."""
  d = np.linalg.norm(dense - np.asarray(pos, np.float32)[None], axis=1)
  d[max(lo, 0):min(hi, len(d))] = np.inf
  return float(d.min()) > clearance


def build_benchmark_scenarios(cfg, town, episodes, anns, seed: int = 0,
                              device="cuda"):
  """All 7 scenario types for a batch of episodes.

  town: a SyntheticTown or a list of them (one per episode); anns: one
  annotation dict per episode, or one shared dict. Returns (walker_sites,
  specs, scen_state, scenario_npcs) for ``scene_builder.build_batch`` and
  ``Scene.scenarios``, the specs and state on `device`."""
  rng = np.random.default_rng(seed)
  B = len(episodes)
  V = cfg.sim.max_vehicles
  W = cfg.sim.max_walkers
  K = MAX_SLOTS

  kind = np.zeros((B, K), np.int32)
  tpos = np.zeros((B, K, 2), np.float32)
  tdist = np.full((B, K), 15.0, np.float32)
  tkind = np.zeros((B, K), np.int32)
  tparam = np.zeros((B, K), np.float32)
  aslot = np.full((B, K), -1, np.int32)
  dur = np.full((B, K), 60, np.int32)
  mag = np.zeros((B, K), np.float32)
  valid = np.zeros((B, K), bool)
  walker_sites = []
  scenario_npcs = []

  for b, ep in enumerate(episodes):
    tw = town[b] if isinstance(town, (list, tuple)) else town
    ann = anns[b] if isinstance(anns, list) else anns
    near = importer.scenarios_near_route(ann or {}, ep.dense)
    dense = ep.dense
    npcs = []
    k = 0

    def add(kind_, trig, dist_, dur_, mag_, actor=None, tta=0.0):
      nonlocal k
      if k >= K:
        return
      kind[b, k] = kind_
      tpos[b, k] = trig
      tdist[b, k] = dist_
      if tta > 0:
        # time-to-arrival arming, the reference's crossing semantic
        tkind[b, k] = TriggerKind.TIME_TO_ARRIVAL
        tparam[b, k] = tta
      dur[b, k] = dur_
      mag[b, k] = mag_
      if actor is not None:
        # scripted actors fill the LAST vehicle slots in spawn order
        aslot[b, k] = V - 1 - len(npcs)
        npcs.append(actor)
      valid[b, k] = True
      k += 1

    # --- Scenario3/4: crossing walkers from annotations ---
    sites = []
    cross = [near[key][0] for key in ("Scenario3", "Scenario4")
             if key in near and len(near[key][0])]
    if cross:
      pts = np.concatenate(cross)
      sel = rng.permutation(len(pts))[:W]
      for x, y, yaw in pts[sel]:
        fwd = np.array([np.cos(yaw), np.sin(yaw)], np.float32)
        right = np.array([-np.sin(yaw), np.cos(yaw)], np.float32)
        # spawned 12 m past the trigger waypoint, as the reference's
        # _start_distance, so a braking ego stops short of the crossing
        sites.append((np.array([x, y], np.float32) + fwd * 12.0 +
                      right * 6.0, -right))
    walker_sites.append(sites)

    # --- Scenario1: control loss from annotations ---
    if "Scenario1" in near and len(near["Scenario1"][0]):
      pts = near["Scenario1"][0]
      for x, y, yaw in pts[rng.permutation(len(pts))[:2]]:
        add(ScenarioType.CONTROL_LOSS, (x, y), 15.0, 60, 0.1)

    # --- Scenario2/5: held / slow leader on the ego lane ---
    for frac, kind_, dur_, mag_ in (
        (0.30, ScenarioType.FOLLOW_LEADING, 80, 0.0),
        (0.55, ScenarioType.OTHER_LEADING, 240, 2.5)):
      i = int(len(dense) * frac)
      if i + 30 >= len(dense):
        continue
      ahead = dense[min(i + 25, len(dense) - 1)]
      hit = _nearest_lane(tw, ahead, _route_yaw(dense, min(i + 25,
                                                           len(dense) - 2)))
      if hit is None:
        continue
      li, at, pt, yw = hit
      add(kind_, dense[i], 20.0, dur_, mag_,
          actor=dict(pos=pt, yaw=yw, lane_id=li, lane_t=at))

    # --- Scenario6: held vehicle on the OPPOSING lane ---
    i = int(len(dense) * 0.70)
    if i + 40 < len(dense):
      ahead = dense[i + 35]
      ryaw = _route_yaw(dense, i + 35)
      hit = _nearest_lane(tw, ahead, ryaw + np.pi, max_dist=8.0)
      if hit is not None and _route_clear(dense, hit[2], i - 40, i + 80,
                                          clearance=2.5):
        li, at, pt, yw = hit
        add(ScenarioType.OPPOSITE_DIRECTION, dense[i], 30.0, 160, 0.0,
            actor=dict(pos=pt, yaw=yw, lane_id=li, lane_t=at))

    # --- Scenario7-10: junction crossings at route junctions ---
    junc_idx = np.nonzero(ep.is_junction)[0]
    used = 0
    for ji in junc_idx:
      if used >= 2 or ji < 20:
        continue
      if used and ji - used_prev < 150:
        continue
      jpt = dense[min(ji + 6, len(dense) - 1)]
      ryaw = _route_yaw(dense, ji)
      # a crossing approach: lane heading roughly perpendicular, ending
      # near the junction point
      for sgn in (1.0, -1.0):
        hit = _nearest_lane(tw, jpt, ryaw + sgn * np.pi / 2,
                            max_dist=12.0, yaw_tol=0.7)
        if hit is not None:
          li, at, pt, yw = hit
          # place the actor ~10 m back on its lane
          at2 = max(at - 10.0, 0.0)
          back = pt - 10.0 * np.array([np.cos(yw), np.sin(yw)],
                                      np.float32)
          if not _route_clear(dense, back, ji - 60, ji + 60):
            continue   # the actor would park on another leg of this route
          add(ScenarioType.JUNCTION_CROSSING, dense[max(ji - 5, 0)],
              25.0, 120, 0.0,
              actor=dict(pos=back, yaw=yw, lane_id=li, lane_t=at2),
              tta=4.0)
          used += 1
          used_prev = ji
          break

    scenario_npcs.append(npcs)

  empty = make_empty_specs(B, K, device=device)
  dev = empty.kind.device
  t = lambda a: torch.from_numpy(a).to(dev)
  specs = empty.replace(
      kind=t(kind), trigger_pos=t(tpos), trigger_dist=t(tdist),
      trigger_kind=t(tkind), trigger_param=t(tparam), actor_slot=t(aslot),
      duration=t(dur), magnitude=t(mag), valid=t(valid))
  return walker_sites, specs, scenarios_reset(B, K, device=dev), \
      scenario_npcs
