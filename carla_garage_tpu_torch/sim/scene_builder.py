"""Host-side episode assembly (port of carla_garage_tpu/sim/scene_builder.py).

Builds the batched Scene and initial SimState from host town data and
route keypoints, as the reference's RouteScenario does per episode (route
interpolation, ego and traffic spawn, scenario instantiation, timeout),
but as padded fixed-shape tensors for the whole batch at once. The host
work is numpy with the JAX package's calls in the same order, so the same
seed gives the same arrays bit for bit; the tensors are made on the
caller's device at the end.

Towns: the procedural grid town, ``"synth"`` or ``"synth<N>"``, and the
imported CARLA towns (``"Town01"`` ... ``"Town06"``), which
``maps/importer.py`` loads from an asset root with their recovered lane
graph and signalization.
"""

from __future__ import annotations

import dataclasses
import os
import weakref

import numpy as np
import torch

from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.device import resolve_device
from carla_garage_tpu_torch.maps import importer, routing
from carla_garage_tpu_torch.maps.synthetic import (SyntheticTown, make_town,
                                                   sample_route_keypoints)
from carla_garage_tpu_torch.maps.town_map import (LaneGraph, Layer,
                                                  stack_towns)
from carla_garage_tpu_torch.sim.criteria import criteria_reset
from carla_garage_tpu_torch.sim.scenario_wiring import \
    build_benchmark_scenarios
from carla_garage_tpu_torch.structs import (EgoState, ExpertState, PIDState,
                                            PlannerState, Route, Scene,
                                            SimState, StopSigns,
                                            TrafficLights, VehicleStates,
                                            WalkerSpec, WalkerStates)

MAX_SPARSE = 128
NPC_EXTENT = (2.45, 1.06)
WALKER_EXTENT = (0.187, 0.187)   # CARLA walker bounding box half extents
WALKER_SPEED = 1.4


@dataclasses.dataclass
class HostEpisode:
  """One episode's host-side spec before padding and batching."""
  dense: np.ndarray        # [R,2]
  cmd: np.ndarray          # [R]
  is_junction: np.ndarray  # [R]
  sparse: np.ndarray
  sparse_cmd: np.ndarray
  length_m: float


def curvature_junction_flags(dense: np.ndarray, window_m: float = 8.0,
                             thresh_deg: float = 14.0) -> np.ndarray:
  """Mark route points in significant turns as junction-like."""
  n = len(dense)
  w = int(window_m)
  yaws = np.arctan2(*np.diff(dense, axis=0).T[::-1])
  yaws = np.concatenate([yaws, yaws[-1:]])
  a0 = yaws[np.maximum(np.arange(n) - w, 0)]
  a1 = yaws[np.minimum(np.arange(n) + w, n - 1)]
  dyaw = np.degrees(np.abs(np.arctan2(np.sin(a1 - a0), np.cos(a1 - a0))))
  return dyaw > thresh_deg


# host caches keyed by id(town.raster), as the JAX package keys them. An
# id is unique only while its object lives: the entries of the first three
# are dropped when their raster is freed (``_drop_with``), and those of
# _PAD_CACHE keep their raster alive. (JAX's first three do neither, so a
# new town can be served a freed town's entry there.)
_SNAP_CACHE: dict = {}
_LANE_SNAP_CACHE: dict = {}
_ROUTER_CACHE: dict = {}
_PAD_CACHE: dict = {}


def _drop_with(raster: np.ndarray, cache: dict, key):
  """Remove cache[key] when `raster` is freed."""
  weakref.finalize(raster, cache.pop, key, None)


def snap_to_road(dense: np.ndarray, town: SyntheticTown) -> np.ndarray:
  """Project off-road route points onto the nearest drivable pixel at
  least 1.5 m from the road edge (Hermite arcs can overshoot sharp
  junction corners), through a cached nearest-road-pixel index map."""
  from scipy import ndimage
  key = id(town.raster)
  clearance_px = int(1.5 * town.ppm)
  if key not in _SNAP_CACHE:
    road = town.raster[Layer.ROAD] > 0
    inside = ndimage.distance_transform_edt(road)
    deep = inside >= clearance_px
    _, (iy, ix) = ndimage.distance_transform_edt(~deep,
                                                 return_indices=True)
    _SNAP_CACHE[key] = (inside, ix, iy)
    _drop_with(town.raster, _SNAP_CACHE, key)
  inside, ix, iy = _SNAP_CACHE[key]
  p = ((dense - town.world_offset) * town.ppm)
  px = np.clip(np.round(p[:, 0]).astype(int), 0, inside.shape[1] - 1)
  py = np.clip(np.round(p[:, 1]).astype(int), 0, inside.shape[0] - 1)
  off = inside[py, px] < clearance_px
  if off.any():
    sx = ix[py[off], px[off]]
    sy = iy[py[off], px[off]]
    dense = dense.copy()
    dense[off, 0] = (sx + 0.5) / town.ppm + town.world_offset[0]
    dense[off, 1] = (sy + 0.5) / town.ppm + town.world_offset[1]
    # light smoothing so the PID tracks the adjusted arc cleanly
    k = 5
    pad = np.concatenate([dense[:1].repeat(k // 2, 0), dense,
                          dense[-1:].repeat(k // 2, 0)])
    kernel = np.ones((k,)) / k
    dense = np.stack([np.convolve(pad[:, 0], kernel, mode="valid"),
                      np.convolve(pad[:, 1], kernel, mode="valid")], -1)
  return dense.astype(np.float32)


def _lane_snap_index(town: SyntheticTown):
  """KD-tree over direction-tagged lane sample points (cached per town)."""
  from scipy.spatial import cKDTree
  key = id(town.raster)
  if key not in _LANE_SNAP_CACHE:
    pts, yaws = [], []
    for poly in town.lane_polys:
      poly = np.asarray(poly, np.float32)
      if len(poly) < 2:
        continue
      seg = np.linalg.norm(np.diff(poly, axis=0), axis=-1)
      arc = np.concatenate([[0.0], np.cumsum(seg)])
      if arc[-1] < 2.0:
        continue
      t = np.arange(0.0, arc[-1], 2.0)
      xs = np.interp(t, arc, poly[:, 0])
      ys = np.interp(t, arc, poly[:, 1])
      pts.append(np.stack([xs, ys], -1))
      yaws.append(np.arctan2(np.gradient(ys), np.gradient(xs)))
    if pts:
      P = np.concatenate(pts).astype(np.float32)
      Y = np.concatenate(yaws).astype(np.float32)
      _LANE_SNAP_CACHE[key] = (cKDTree(P), P, Y)
    else:
      _LANE_SNAP_CACHE[key] = None
    _drop_with(town.raster, _LANE_SNAP_CACHE, key)
  return _LANE_SNAP_CACHE[key]


def snap_to_lane(dense: np.ndarray, town: SyntheticTown,
                 max_snap: float = 8.0) -> np.ndarray:
  """Project the dense route onto the nearest direction-matched lane
  (+-60 degrees of the local route direction), so the ego follows the
  right-hand lane wherever the lane graph covers; unmatched points keep
  their position. The output is resampled to ~1 m spacing."""
  idx = _lane_snap_index(town)
  if idx is None or len(dense) < 4:
    return dense
  tree, P, Y = idx
  d = np.diff(dense, axis=0)
  yaw_r = np.arctan2(d[:, 1], d[:, 0])
  yaw_r = np.concatenate([yaw_r, yaw_r[-1:]])
  dist, nn = tree.query(dense, k=8)
  cand_yaw = Y[nn]                                     # [N,8]
  ddiff = np.abs(np.arctan2(np.sin(cand_yaw - yaw_r[:, None]),
                            np.cos(cand_yaw - yaw_r[:, None])))
  ok = (ddiff < 1.05) & (dist < max_snap)
  has = ok.any(1)
  first = np.argmax(ok, axis=1)
  snapped = np.where(has[:, None],
                     P[nn[np.arange(len(dense)), first]], dense)
  # smooth, then resample back to ~1 m spacing
  k = 7
  pad = np.concatenate([snapped[:1].repeat(k // 2, 0), snapped,
                        snapped[-1:].repeat(k // 2, 0)])
  ker = np.ones(k) / k
  sm = np.stack([np.convolve(pad[:, 0], ker, "valid"),
                 np.convolve(pad[:, 1], ker, "valid")], -1)
  seg = np.linalg.norm(np.diff(sm, axis=0), axis=-1)
  arc = np.concatenate([[0.0], np.cumsum(seg)])
  if arc[-1] < 2.0:
    return dense
  t = np.arange(0.0, arc[-1], 1.0)
  return np.stack([np.interp(t, arc, sm[:, 0]),
                   np.interp(t, arc, sm[:, 1])], -1).astype(np.float32)


def _road_router(town: SyntheticTown):
  key = id(town.raster)
  if key not in _ROUTER_CACHE:
    _ROUTER_CACHE[key] = routing.RoadRouter(
        town.raster[Layer.ROAD] > 0, town.ppm, town.world_offset)
    _drop_with(town.raster, _ROUTER_CACHE, key)
  return _ROUTER_CACHE[key]


def compile_route(town: SyntheticTown, keypoints_xy: np.ndarray,
                  keypoints_yaw: np.ndarray,
                  use_router: bool = True) -> HostEpisode:
  router = _road_router(town) if use_router else None
  dense = routing.interpolate_keypoints_routed(keypoints_xy, keypoints_yaw,
                                               router)
  dense = snap_to_lane(dense, town)
  dense = snap_to_road(dense, town)
  junc = town.in_junction(dense) | curvature_junction_flags(dense)
  cmd = routing.classify_commands(dense, junc)
  sparse, sparse_cmd = routing.downsample_route(dense, cmd)
  length = float(np.linalg.norm(np.diff(dense, axis=0), axis=-1).sum())
  return HostEpisode(dense=dense, cmd=cmd, is_junction=junc, sparse=sparse,
                     sparse_cmd=sparse_cmd, length_m=length)


def build_batch(cfg: GlobalConfig, town, episodes: list, seed: int = 0,
                n_vehicles: int = 8, n_walkers: int = 2,
                walker_sites: list | None = None,
                town_of_episode: list | None = None,
                scenario_npcs: list | None = None,
                npc_spawn_radius: float = 120.0, device="cuda"):
  """(MapStack, LaneGraph, Scene, SimState) for a batch of episodes, on
  `device`.

  `town` is one SyntheticTown or a list of towns with
  `town_of_episode[b]` giving each episode's town index. NPCs spawn on the
  town-wide lane graph within `npc_spawn_radius` of the episode's route.
  walker_sites: optional per-episode (pos[2], dir[2]) crossing spawns
  overriding random placement. scenario_npcs: optional per-episode lists
  of dicts {pos [2], yaw, lane_id (town-local), lane_t}: scripted scenario
  actors placed in the LAST vehicle slots (slot V-1-i for the i-th)."""
  dev = resolve_device(device)
  rng = np.random.default_rng(seed)
  B = len(episodes)
  s = cfg.sim
  R, Rs = s.max_route_points, MAX_SPARSE
  V, W, L, S = s.max_vehicles, s.max_walkers, s.max_lights, s.max_stop_signs
  T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
  zeros = lambda *shape, dtype=torch.float32: torch.zeros(
      shape, dtype=dtype, device=dev)

  if isinstance(town, (list, tuple)):
    towns = list(town)
    assert town_of_episode is not None and len(town_of_episode) == B
    maps = stack_towns([t.raster for t in towns],
                       [t.world_offset for t in towns], towns[0].ppm, dev)
    town_ids = np.asarray(town_of_episode, np.int32)
  else:
    towns = [town]
    maps = stack_towns([town.raster], [town.world_offset], town.ppm, dev)
    town_ids = np.zeros((B,), np.int32)
  # concatenated lane graph over all towns; episode b's NPCs use lanes in
  # [lane_lo[t], lane_lo[t + 1]) of its town t
  all_polys: list = []
  all_succ: list = []
  lane_lo = []
  for t in towns:
    off_ = len(all_polys)
    lane_lo.append(off_)
    all_polys += list(t.lane_polys)
    all_succ += [[si + off_ for si in sl] for sl in t.lane_successors]
  lane_lo.append(len(all_polys))
  if not all_polys:                       # degenerate: no lane network
    all_polys = [np.zeros((2, 2), np.float32)]
    all_succ = [[]]
  lanes = LaneGraph.from_polylines(all_polys, all_succ, device=dev)

  # ---- routes ----
  pts = np.zeros((B, R, 2), np.float32)
  cmd = np.full((B, R), 4, np.int32)
  junc = np.zeros((B, R), bool)
  seg = np.zeros((B, R), np.float32)
  nv = np.zeros((B,), np.int32)
  spts = np.zeros((B, Rs, 2), np.float32)
  scmd = np.full((B, Rs), 4, np.int32)
  snv = np.zeros((B,), np.int32)
  timeout = np.zeros((B,), np.int32)
  for i, ep in enumerate(episodes):
    n = min(len(ep.dense), R)
    pts[i, :n] = ep.dense[:n]
    pts[i, n:] = ep.dense[n - 1]
    cmd[i, :n] = ep.cmd[:n]
    junc[i, :n] = ep.is_junction[:n]
    seg[i, 1:n] = np.linalg.norm(np.diff(ep.dense[:n], axis=0), axis=-1)
    nv[i] = n
    m = min(len(ep.sparse), Rs)
    spts[i, :m] = ep.sparse[:m]
    spts[i, m:] = ep.sparse[m - 1]
    scmd[i, :m] = ep.sparse_cmd[:m]
    snv[i] = m
    timeout[i] = int((cfg.criteria.route_timeout_s_per_m * ep.length_m +
                      cfg.criteria.route_timeout_base_s) * s.fps)
  route = Route(points=T(pts), cmd=T(cmd), is_junction=T(junc),
                seg_len=T(seg), num_valid=T(nv), sparse_points=T(spts),
                sparse_cmd=T(scmd), sparse_num_valid=T(snv))

  # ---- lights / stops: per episode, the slots nearest its route ----
  def town_of(b):
    return towns[int(town_ids[b])]

  def select_near(pos, route_sub, n_max, radius=60.0):
    if len(pos) == 0:
      return np.zeros((0,), np.int64)
    d = np.linalg.norm(pos[:, None] - route_sub[None], axis=-1).min(1)
    idx = np.nonzero(d < radius)[0]
    return idx[np.argsort(d[idx])][:n_max]

  def gather_pad(a, idx, n):
    out = np.zeros((n,) + a.shape[1:], np.float32)
    out[:len(idx)] = a[idx]
    return out

  def per_episode(field, sel, n):
    return np.stack([gather_pad(getattr(town_of(b), field), sel[b], n)
                     for b in range(B)])

  route_subs = [ep.dense[::8] for ep in episodes]
  lsel = [select_near(town_of(b).light_pos, route_subs[b], L)
          for b in range(B)]
  ssel = [select_near(town_of(b).stop_pos, route_subs[b], S)
          for b in range(B)]
  # per-episode light-phase jitter: repetitions of a route see different
  # light timing
  phase_jitter = rng.uniform(0.0, 30.0, size=(B, 1)).astype(np.float32)
  lights = TrafficLights(
      pos=T(per_episode("light_pos", lsel, L)),
      yaw=T(per_episode("light_yaw", lsel, L)),
      extent=T(per_episode("light_extent", lsel, L)),
      offset_s=T(per_episode("light_offset_s", lsel, L) + phase_jitter),
      green_s=T(per_episode("light_green_s", lsel, L)),
      yellow_s=T(per_episode("light_yellow_s", lsel, L)),
      red_s=T(per_episode("light_red_s", lsel, L)),
      valid=T(np.stack([np.arange(L) < len(lsel[b]) for b in range(B)])))
  stops = StopSigns(
      pos=T(per_episode("stop_pos", ssel, S)),
      yaw=T(per_episode("stop_yaw", ssel, S)),
      extent=T(per_episode("stop_extent", ssel, S)),
      valid=T(np.stack([np.arange(S) < len(ssel[b]) for b in range(B)])))

  # ---- NPC vehicles on town lanes near the route ----
  vpos = np.zeros((B, V, 2), np.float32)
  vyaw = np.zeros((B, V), np.float32)
  vvalid = np.zeros((B, V), bool)
  vlane = np.zeros((B, V), np.int32)
  vt = np.zeros((B, V), np.float32)
  # lane anchors (start / mid / end) for the near-route candidate test
  anchors = np.stack([np.stack([p[0], p[len(p) // 2], p[-1]])
                      for p in all_polys])                # [N,3,2]
  arcs = [np.concatenate([[0.0], np.cumsum(np.linalg.norm(
      np.diff(p, axis=0), axis=-1))]) for p in all_polys]
  n_scen = [len(scenario_npcs[b]) if scenario_npcs else 0 for b in range(B)]
  for b in range(B):
    ti = int(town_ids[b])
    lo, hi = lane_lo[ti], lane_lo[ti + 1]
    d_anchor = np.linalg.norm(
        anchors[lo:hi, :, None] - route_subs[b][None, None], axis=-1)
    cand = lo + np.nonzero(d_anchor.min((1, 2)) < npc_spawn_radius)[0]
    ego0 = episodes[b].dense[0]
    placed = 0
    budget = min(n_vehicles, V - n_scen[b])
    for _ in range(n_vehicles * 8):
      if placed >= budget or len(cand) == 0:
        break
      li = int(cand[rng.integers(0, len(cand))])
      arc = arcs[li]
      total = arc[-1]
      if total < 10.0:
        continue
      t = float(rng.uniform(0.05, 0.95)) * total
      poly = all_polys[li]
      x = np.interp(t, arc, poly[:, 0])
      y = np.interp(t, arc, poly[:, 1])
      if np.linalg.norm([x - ego0[0], y - ego0[1]]) < 15.0:
        continue
      if placed and np.min(np.linalg.norm(
          vpos[b, :placed] - np.array([x, y]), axis=-1)) < 9.0:
        continue
      k = min(max(np.searchsorted(arc, t), 1), len(poly) - 1)
      d = poly[k] - poly[k - 1]
      vpos[b, placed] = (x, y)
      vyaw[b, placed] = np.arctan2(d[1], d[0])
      vlane[b, placed] = li
      vt[b, placed] = t
      vvalid[b, placed] = True
      placed += 1
    # scripted scenario actors in the LAST slots: slot V-1-i
    if scenario_npcs:
      for i, spec in enumerate(scenario_npcs[b][:V // 4]):
        sl = V - 1 - i
        vpos[b, sl] = spec["pos"]
        vyaw[b, sl] = spec["yaw"]
        vlane[b, sl] = lo + int(spec["lane_id"])
        vt[b, sl] = spec["lane_t"]
        vvalid[b, sl] = True
  sb = cfg.expert.stuck_buffer_size
  vehicles = VehicleStates(
      pos=T(vpos), yaw=T(vyaw), speed=zeros(B, V),
      extent=T(np.broadcast_to(np.array(NPC_EXTENT, np.float32), (B, V, 2))),
      valid=T(vvalid), control=zeros(B, V, 3),
      buf_vel=torch.ones((B, V, sb), device=dev),   # start "moving"
      buf_throttle=zeros(B, V, sb), buf_brake=zeros(B, V, sb),
      lane_id=T(vlane), lane_t=T(vt),
      stand_ticks=zeros(B, V, dtype=torch.int32))

  # ---- crossing walkers at random route fractions ----
  wpos = np.zeros((B, W, 2), np.float32)
  wdir = np.zeros((B, W, 2), np.float32)
  wyaw = np.zeros((B, W), np.float32)
  wvalid = np.zeros((B, W), bool)
  wtrig = np.full((B, W), 18.0, np.float32)
  wcross = np.full((B, W), 9.0, np.float32)
  for b in range(B):
    if walker_sites is not None and b < len(walker_sites):
      for wi, (p, d) in enumerate(walker_sites[b][:W]):
        wpos[b, wi] = p
        wdir[b, wi] = d
        wyaw[b, wi] = np.arctan2(d[1], d[0])
        wvalid[b, wi] = True
      continue
    dense = episodes[b].dense
    for wi in range(min(n_walkers, W)):
      fi = int(len(dense) * rng.uniform(0.3, 0.9))
      fi = min(fi, len(dense) - 2)
      p = dense[fi]
      h = dense[fi + 1] - dense[fi]
      h = h / (np.linalg.norm(h) + 1e-6)
      right = np.array([-h[1], h[0]], np.float32)
      wpos[b, wi] = p + right * 6.0        # on the sidewalk
      wdir[b, wi] = -right                 # crossing the street
      wyaw[b, wi] = np.arctan2(-right[1], -right[0])
      wvalid[b, wi] = True
  walkers = WalkerStates(
      pos=T(wpos), yaw=T(wyaw), direction=T(wdir), speed=zeros(B, W),
      extent=T(np.broadcast_to(np.array(WALKER_EXTENT, np.float32),
                               (B, W, 2))),
      valid=T(wvalid), seen_frames=zeros(B, W, dtype=torch.int32),
      active=zeros(B, W, dtype=torch.bool), walked_m=zeros(B, W))
  # crossings arm on time-to-arrival; the distance trigger stays as a
  # floor for a slow-rolling ego
  wspec = WalkerSpec(trigger_dist=T(wtrig), cross_dist=T(wcross),
                     walk_speed=torch.full((B, W), WALKER_SPEED, device=dev),
                     trigger_tta=torch.full((B, W), 4.0, device=dev))

  scene = Scene(town_id=T(town_ids), route=route, lights=lights, stops=stops,
                walkers_spec=wspec, timeout_ticks=T(timeout))

  # ---- initial state ----
  ego_pos = np.stack([ep.dense[0] for ep in episodes]).astype(np.float32)
  ego_yaw = np.array([np.arctan2(*((ep.dense[1] - ep.dense[0])[::-1]))
                      for ep in episodes], np.float32)
  ego = EgoState(pos=T(ego_pos), yaw=T(ego_yaw), speed=zeros(B))

  def planner():
    return PlannerState(idx=zeros(B, dtype=torch.int32),
                        is_last=zeros(B, dtype=torch.bool))

  flag = lambda: zeros(B, dtype=torch.bool)
  expert = ExpertState(
      planner_dense=planner(), planner_sparse=planner(),
      pid_turn=PIDState.create((B,), cfg.expert.turn_n, device=dev),
      pid_speed=PIDState.create((B,), cfg.expert.speed_n, device=dev),
      steer=zeros(B),
      target_speed=torch.full((B,), cfg.expert.target_speed_fast,
                              device=dev),
      junction=flag(), cleared_stop_signs=zeros(B, S, dtype=torch.bool),
      vehicle_hazard=flag(), walker_hazard=flag(), light_hazard=flag(),
      stop_sign_hazard=flag(), walker_close=flag(), stop_sign_close=flag())
  state = SimState(tick=zeros(B, dtype=torch.int32), done=flag(), ego=ego,
                   vehicles=vehicles, walkers=walkers, expert=expert,
                   criteria=criteria_reset(B, V, W, L, S, device=dev))
  return maps, lanes, scene, state


def make_synthetic_batch(cfg: GlobalConfig, batch: int = 4, seed: int = 0,
                         n_vehicles: int = 8, n_walkers: int = 2,
                         min_route_m: float = 300.0,
                         town: SyntheticTown | None = None, device="cuda"):
  """Synthetic town + random routes + batch assembly ->
  (town, maps, lanes, scene, state), tensors on `device`."""
  rng = np.random.default_rng(seed)
  town = town or make_town(seed=seed)
  eps = []
  for _ in range(batch):
    for _retry in range(16):
      xy, yaw = sample_route_keypoints(town, rng, min_len_m=min_route_m)
      if len(xy) >= 4:
        break
    eps.append(compile_route(town, xy, yaw))
  maps, lanes, scene, state = build_batch(
      cfg, town, eps, seed=seed, n_vehicles=n_vehicles, n_walkers=n_walkers,
      device=device)
  return town, maps, lanes, scene, state


def _padded_town(town, pad_hw):
  """Copy of `town` with its raster zero-padded (bottom / right) to
  pad_hw. Geometry is unchanged; a common raster shape lets one set of
  tensors serve several towns. Cached so the route compiler's per-raster
  indices are built once per town."""
  key = (id(town.raster), pad_hw)
  if key in _PAD_CACHE:
    return _PAD_CACHE[key][1]
  C, H, W = town.raster.shape
  Ht, Wt = pad_hw
  assert Ht >= H and Wt >= W, f"pad_hw {pad_hw} smaller than raster {(H, W)}"
  if (H, W) == (Ht, Wt):
    padded = town
  else:
    r = np.zeros((C, Ht, Wt), town.raster.dtype)
    r[:, :H, :W] = town.raster
    padded = dataclasses.replace(town, raster=r)
  # the entry keeps the keying raster alive: id() keys are unique only
  # while the object lives
  _PAD_CACHE[key] = (town.raster, padded)
  return padded


def crop_town_to_routes(town, episodes: list, crop_hw: tuple,
                        margin_m: float = 130.0):
  """Crop a town raster to the union bounding box of the batch's routes
  plus a margin, keeping world coordinates (world_offset shifts by the
  crop origin); areas outside the crop read as void. Raises if the box
  cannot fit."""
  Ht, Wt = crop_hw
  pts = np.concatenate([ep.dense for ep in episodes])
  lo = pts.min(0) - margin_m
  hi = pts.max(0) + margin_m
  ppm = town.ppm
  need = (hi - lo) * ppm
  if need[0] > Wt or need[1] > Ht:
    raise ValueError(f"route bbox {need} px exceeds crop {crop_hw}")
  C, H, W = town.raster.shape
  cx = (lo[0] + hi[0]) / 2.0
  cy = (lo[1] + hi[1]) / 2.0
  ox = int(np.clip(round((cx - town.world_offset[0]) * ppm - Wt / 2),
                   0, max(W - Wt, 0)))
  oy = int(np.clip(round((cy - town.world_offset[1]) * ppm - Ht / 2),
                   0, max(H - Ht, 0)))
  r = np.zeros((C, Ht, Wt), town.raster.dtype)
  sy, sx = min(Ht, H - oy), min(Wt, W - ox)
  r[:, :sy, :sx] = town.raster[:, oy:oy + sy, ox:ox + sx]
  off = town.world_offset + np.array([ox, oy], np.float32) / ppm
  return dataclasses.replace(town, raster=r,
                             world_offset=off.astype(np.float32))


def make_town_batch(cfg: GlobalConfig, town_name: str, batch: int = 4,
                    seed: int = 0, n_vehicles: int = 8, n_walkers: int = 2,
                    min_route_m: float = 250.0, max_route_m: float = 500.0,
                    pad_hw: tuple | None = None, assets_root: str = None,
                    crop_hw: tuple | None = None,
                    crop_margin_m: float = 130.0,
                    use_scenarios: bool = False, device="cuda"):
  """Random routes on a named town -> (town, maps, lanes, scene, state),
  tensors on `device`. An imported CARLA town (Town01-06, from
  `assets_root`, else $CGT_ASSETS_ROOT) gets random walks over
  its recovered lane graph of `min_route_m` to `max_route_m`; 'synth' (or
  'synth<N>' for a seeded variant) is the procedural grid town with its
  lattice walker. use_scenarios attaches all 7 scenario types
  (``sim/scenario_wiring.py``), an imported town's annotations included."""
  dev = resolve_device(device)
  rng = np.random.default_rng(seed)
  if town_name.startswith("synth"):
    t_seed = int(town_name[5:]) if town_name[5:].isdigit() else seed
    town = make_town(seed=t_seed)
    origin = t_seed
    is_conn = None
  else:
    # imported towns are seed-independent: their asset root names them
    origin = os.path.abspath(importer.resolve_assets_root(assets_root))
    imported = importer.load_town(town_name, origin)
    town = importer.as_synthetic_town(imported)
    is_conn = imported.lane_is_connector
  if pad_hw is not None and crop_hw is None:
    town = _padded_town(town, pad_hw)
  # with a crop, every episode's route stays inside one crop window: the
  # batch shares the union bbox, held within the usable crop extent
  margin_m = crop_margin_m
  crop_eff = (min(crop_hw) / town.ppm - 2 * margin_m) \
      if crop_hw is not None else None
  union_lo = union_hi = None
  eps = []
  use_grid_sampler = town_name.startswith("synth")
  for _ in range(batch):
    ep = None
    for _retry in range(128):
      if use_grid_sampler:
        # the lattice walker of the grid town: lane-graph walks there loop
        # back to their start block
        res = sample_route_keypoints(town, rng, min_len_m=min_route_m)
        if len(res[0]) < 4:
          res = None
      else:
        res = routing.sample_lane_route(
            town.lane_polys, town.lane_successors, rng,
            min_len_m=min_route_m, max_len_m=max_route_m,
            is_connector=is_conn)
      if res is None:
        continue
      # reject loop routes: a goal within 40 m of the spawn completes at
      # tick 0
      if np.linalg.norm(res[0][-1] - res[0][0]) < 40.0:
        continue
      if crop_eff is not None:
        lo, hi = res[0].min(0), res[0].max(0)
        nlo = lo if union_lo is None else np.minimum(union_lo, lo)
        nhi = hi if union_hi is None else np.maximum(union_hi, hi)
        if float(np.max(nhi - nlo)) > crop_eff - 20.0:
          continue                    # would overflow the shared window
      ep = compile_route(town, res[0], res[1])
      if ep.length_m >= 0.8 * min_route_m:
        if crop_eff is not None:
          lo, hi = ep.dense.min(0), ep.dense.max(0)
          union_lo = lo if union_lo is None else np.minimum(union_lo, lo)
          union_hi = hi if union_hi is None else np.maximum(union_hi, hi)
        break
    if ep is None:
      raise RuntimeError(f"no routable lanes in {town_name}")
    eps.append(ep)
  if crop_hw is not None:
    town = crop_town_to_routes(town, eps, crop_hw, margin_m=margin_m)
  walker_sites = scenario_npcs = specs = scen_state = None
  if use_scenarios:
    # an imported town's annotations place Scenario1/3/4; the synthetic
    # town has none, so it gets the geometry-synthesized types only
    ann = {} if use_grid_sampler else importer.load_scenarios(
        town_name, origin)
    walker_sites, specs, scen_state, scenario_npcs = \
        build_benchmark_scenarios(cfg, town, eps, ann, seed, device=dev)
  maps, lanes, scene, state = build_batch(
      cfg, town, eps, seed=seed, n_vehicles=n_vehicles,
      n_walkers=n_walkers, walker_sites=walker_sites,
      scenario_npcs=scenario_npcs, device=dev)
  if use_scenarios:
    scene = scene.replace(scenarios=specs)
    state = state.replace(scenario=scen_state)
  # one device copy of a town's rasters and lanes for every batch built on
  # it (crops are per-batch windows, so only the town-wide lanes there);
  # keyed by the town's origin (a grid town's effective seed, an imported
  # town's asset root: one name from two roots is two towns) and the
  # device
  if crop_hw is None:
    key = ("devcache", town_name, origin, pad_hw, str(dev))
    maps, lanes = _PAD_CACHE.setdefault(key, (maps, lanes))
  else:
    lanes = _PAD_CACHE.setdefault(
        ("devcache_lanes", town_name, origin, str(dev)), lanes)
  return town, maps, lanes, scene, state
