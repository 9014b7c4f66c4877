"""CARLA town and benchmark importer (host side; port of
carla_garage_tpu/maps/importer.py, numpy).

Loads the reference's pre-rasterized town maps
(``team_code/birds_eye_view/maps/{name}.h5``), the benchmark route XMLs
(``leaderboard/data/longest6.xml`` and the others) and the scenario
annotation JSONs into the simulator's formats, so that the Longest6 and
LAV benchmarks run on the card.

The h5 files carry geometry only, so road topology is recovered from the
road raster by ``maps/lane_graph.py``: a town-wide directed lane graph for
NPC traffic, junctions, synthesized traffic lights with coordinated phases
on the approaches of signalized junctions, stop signs on unsignalized
minor entries, and a per-pixel lane-direction channel for the wrong-way
criterion. Lights are synthesized (the rasters hold no light actors), so
infraction counts are comparable in kind, not in exact position.

The asset root is the ``root`` argument (a script's --assets-root), else
``$CGT_ASSETS_ROOT``; with neither, the loaders raise FileNotFoundError.
``load_town`` = ``read_town_layers`` (the h5 read; imports h5py, and only
when the town is not cached) + ``town_from_layers`` (everything after it).
A town is memoized in the process and pickled to a disk cache under
``CGT_TOWN_CACHE`` (default ``~/.cache/cgt_town_cache``) in files of this
package's own name, so that it never unpickles a JAX-written town.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import xml.etree.ElementTree as ET

import numpy as np
from scipy import ndimage

from carla_garage_tpu_torch.maps import lane_graph as lg
from carla_garage_tpu_torch.maps.synthetic import (SyntheticTown,
                                                   ground_semantic_channel,
                                                   grid_layers)
from carla_garage_tpu_torch.maps.town_map import Layer

ASSETS_ENV = "CGT_ASSETS_ROOT"
MAPS_DIR = "team_code/birds_eye_view/maps"
ROUTES_DIR = "leaderboard/data"
BENCHMARKS = ("longest6", "lav", "1_3", "4_6", "debug")

LIGHT_GREEN_S = 10.0
LIGHT_YELLOW_S = 3.0
LIGHT_ALL_RED_S = 2.0


@dataclasses.dataclass
class ImportedTown:
  name: str
  raster: np.ndarray           # [C,H,W] uint8 (Layer.* channels)
  world_offset: np.ndarray     # [2]
  ppm: float
  light_pos: np.ndarray        # [L,2]
  light_yaw: np.ndarray
  light_extent: np.ndarray
  light_offset_s: np.ndarray
  light_green_s: np.ndarray
  light_yellow_s: np.ndarray
  light_red_s: np.ndarray
  stop_pos: np.ndarray         # [S,2]
  stop_yaw: np.ndarray
  stop_extent: np.ndarray
  lane_polys: list             # town-wide directed NPC lanes
  lane_successors: list
  lane_is_connector: np.ndarray


def resolve_assets_root(root: str | None = None) -> str:
  """The CARLA asset root: `root`, else $CGT_ASSETS_ROOT. Raises
  FileNotFoundError when neither is set."""
  root = root or os.environ.get(ASSETS_ENV)
  if not root:
    raise FileNotFoundError(
        "no CARLA asset root: pass --assets-root (assets_root=) or set "
        f"${ASSETS_ENV}")
  return root


def assets_available(root: str | None = None) -> bool:
  try:
    root = resolve_assets_root(root)
  except FileNotFoundError:
    return False
  return os.path.isdir(os.path.join(root, MAPS_DIR))


_TOWN_CACHE: dict = {}

# bump when lane-graph recovery or the ImportedTown layout changes: stale
# pickles must not survive algorithm changes
TOWN_CACHE_VERSION = 2


def town_cache_path(name: str, root: str | None = None,
                    rng_seed: int = 0) -> str:
  """The disk-cache file of one town. The name keys the asset root and a
  version stamp, so two roots cannot collide and an algorithm change
  invalidates stale entries; the ``torch`` tag keeps the JAX package's
  pickles (which hold its own ImportedTown class) out of this package's
  reads. The directory is user-owned, never a shared /tmp path: loading
  a pickle someone planted runs their code."""
  cache_dir = os.environ.get(
      "CGT_TOWN_CACHE", os.path.expanduser("~/.cache/cgt_town_cache"))
  os.makedirs(cache_dir, exist_ok=True)
  root_tag = hashlib.sha1(os.path.abspath(resolve_assets_root(
      root)).encode()).hexdigest()[:8]
  return os.path.join(cache_dir, f"{name}_{rng_seed}_{root_tag}_torch"
                      f"_v{TOWN_CACHE_VERSION}.pkl")


def write_town_cache(town: ImportedTown, root: str | None = None,
                     rng_seed: int = 0) -> str:
  """Memoize `town` and pickle it to its disk-cache file (atomically:
  parallel processes see whole files). Returns the file's path."""
  root = os.path.abspath(resolve_assets_root(root))
  _TOWN_CACHE[(town.name, root, rng_seed)] = town
  disk = town_cache_path(town.name, root, rng_seed)
  with open(disk + ".tmp", "wb") as f:
    pickle.dump(town, f)
  os.replace(disk + ".tmp", disk)
  return disk


def layers_from_arrays(arrays: dict) -> dict:
  """The h5 layers (name -> array, as a town file stores them) -> the bool
  rasters road, sidewalk (with parking and shoulder), lane_all, broken
  (white and yellow) and yellow that ``town_from_layers`` takes."""
  f = arrays
  road = np.asarray(f["road"]) > 0
  # benign non-road surfaces: sidewalk + parking + shoulder (hitting them
  # is an outside-lane event, not a layout collision)
  sidewalk = np.asarray(f["sidewalk"]) > 0
  if "parking" in f:
    sidewalk |= np.asarray(f["parking"]) > 0
  if "shoulder" in f:
    sidewalk |= np.asarray(f["shoulder"]) > 0
  lane_all = np.asarray(f["lane_marking_all"]) > 0
  broken = (np.asarray(f["lane_marking_white_broken"]) > 0)
  yellow = np.zeros_like(road)
  for k in ("lane_marking_yellow_broken", "lane_marking_yellow_solid"):
    if k in f:
      yellow |= np.asarray(f[k]) > 0
  broken |= np.asarray(f.get("lane_marking_yellow_broken",
                             np.zeros((1, 1)))) > 0
  return dict(road=road, sidewalk=sidewalk, lane_all=lane_all,
              broken=broken, yellow=yellow)


H5_LAYERS = ("road", "sidewalk", "parking", "shoulder", "lane_marking_all",
             "lane_marking_white_broken", "lane_marking_yellow_broken",
             "lane_marking_yellow_solid")


def read_town_layers(name: str, root: str | None = None):
  """One town's h5 file -> (layers as ``layers_from_arrays`` gives them,
  ppm, world_offset). Needs h5py."""
  import h5py
  path = os.path.join(resolve_assets_root(root), MAPS_DIR, f"{name}.h5")
  with h5py.File(path, "r") as f:
    arrays = {k: np.asarray(f[k]) for k in H5_LAYERS if k in f}
    ppm = float(f.attrs["pixels_per_meter"])
    world_offset = np.asarray(f.attrs["world_offset_in_meters"], np.float32)
  return layers_from_arrays(arrays), ppm, world_offset


def write_town_h5(root: str, name: str, arrays: dict, ppm: float,
                  world_offset) -> str:
  """Write a town file in the layout ``read_town_layers`` reads: one
  dataset per layer of `arrays` and the pixels_per_meter and
  world_offset_in_meters attributes. Needs h5py. Returns its path."""
  import h5py
  path = os.path.join(root, MAPS_DIR, f"{name}.h5")
  os.makedirs(os.path.dirname(path), exist_ok=True)
  with h5py.File(path, "w") as f:
    for k, a in arrays.items():
      f.create_dataset(k, data=np.asarray(a))
    f.attrs["pixels_per_meter"] = float(ppm)
    f.attrs["world_offset_in_meters"] = np.asarray(world_offset, np.float64)
  return path


def grid_town_arrays(n_x: int = 4, n_y: int = 4, block: float = 120.0,
                     ppm: float = 4.0, margin: float = 30.0,
                     yellow: bool = True) -> dict:
  """The h5 layers of ``maps/synthetic.make_town``'s grid, as
  ``write_town_h5`` writes them: its road, sidewalk and center-marking
  channels, the marking a yellow broken one (a two-way street) if
  `yellow`, else a white broken one."""
  g = grid_layers(n_x, n_y, block, ppm, margin)
  u8 = lambda m: m.astype(np.uint8) * 255
  center, zeros = u8(g["center"]), np.zeros(g["road"].shape, np.uint8)
  return {"road": u8(g["road"]), "sidewalk": u8(g["sidewalk"]),
          "lane_marking_all": center,
          "lane_marking_white_broken": zeros if yellow else center,
          "lane_marking_yellow_broken": center if yellow else zeros,
          "lane_marking_yellow_solid": zeros, "parking": zeros}


def town_from_layers(name: str, layers: dict, ppm: float,
                     world_offset: np.ndarray, root: str | None = None,
                     rng_seed: int = 0) -> ImportedTown:
  """Everything of ``load_town`` after the h5 read: the route XMLs'
  direction hints and the annotations' signal hints under `root`, lane
  graph and signalization recovery, the junction and stopline channels,
  the obstacle erosion, the ground-semantic channel and the seeded light
  stagger. `layers` as ``read_town_layers`` gives them."""
  root = resolve_assets_root(root)
  road, sidewalk = layers["road"], layers["sidewalk"]
  lane_all, broken = layers["lane_all"], layers["broken"]
  yellow = layers["yellow"]
  # ground-truth direction hints from every benchmark route XML touching
  # this town: the keypoint yaws come from the real OpenDRIVE map and
  # resolve one-way carriageway orientations the raster cannot
  hints = []
  for bench in BENCHMARKS:
    try:
      for r in load_benchmark_routes(bench, root):
        if r.town == name:
          hints.append(np.concatenate(
              [r.keypoints_xy, r.keypoints_yaw[:, None]], -1))
    except (OSError, FileNotFoundError):
      continue
  hints = np.concatenate(hints) if hints else None

  lanes = lg.build_town_lanes(road, ppm, world_offset, yellow=yellow,
                              rng_seed=rng_seed, direction_hints=hints,
                              signal_hints=signal_hints_for(name, root))

  # junction channel: disks at detected junction nodes
  H, W = road.shape
  junction = np.zeros((H, W), bool)
  for c, r in zip(lanes.junction_centers, lanes.junction_radius):
    px, py = (c - world_offset) * ppm
    rp = int(r * ppm)
    x0, x1 = max(int(px) - rp, 0), min(int(px) + rp + 1, W)
    y0, y1 = max(int(py) - rp, 0), min(int(py) + rp + 1, H)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    junction[y0:y1, x0:x1] |= (xx - px) ** 2 + (yy - py) ** 2 <= rp ** 2
  junction &= road

  # stopline channel: the synthesized light trigger boxes (the BEV
  # ground-truth renderer reads it as the reference's stopline layer)
  stopline = np.zeros((H, W), bool)
  for p, yaw, e in zip(lanes.light_pos, lanes.light_yaw, lanes.light_extent):
    n = np.array([-np.sin(yaw), np.cos(yaw)])
    for t in np.linspace(-e[1], e[1], max(int(2 * e[1] * ppm), 2)):
      q = ((p + n * t - world_offset) * ppm).astype(int)
      if 0 <= q[1] < H and 0 <= q[0] < W:
        stopline[q[1], q[0]] = True

  off = ~(road | sidewalk)
  obstacle = ndimage.binary_erosion(off, iterations=int(2.5 * ppm))
  ground_sem = ground_semantic_channel(road, sidewalk, lane_all)
  raster = np.stack([road, sidewalk, lane_all, broken, stopline,
                     junction, obstacle]).astype(np.uint8) * 255
  raster = np.concatenate([raster, ground_sem[None],
                           lanes.direction_raster[None]], 0)
  assert raster.shape[0] == Layer.NUM

  # the per-town phase assignment is in the offsets already; a seeded
  # stagger across junctions keeps the town from switching in lockstep
  rng = np.random.default_rng(rng_seed)
  cycle = 2 * (LIGHT_GREEN_S + LIGHT_YELLOW_S + LIGHT_ALL_RED_S)
  L = len(lanes.light_pos)
  stagger = np.zeros((L,), np.float32)
  if L and len(lanes.junction_centers):
    d = np.linalg.norm(lanes.light_pos[:, None] -
                       lanes.junction_centers[None], axis=-1)
    jid = d.argmin(1)
    per_junction = rng.uniform(0.0, cycle,
                               size=len(lanes.junction_centers))
    stagger = per_junction[jid].astype(np.float32)

  return ImportedTown(
      name=name, raster=raster, world_offset=world_offset, ppm=ppm,
      light_pos=lanes.light_pos, light_yaw=lanes.light_yaw,
      light_extent=lanes.light_extent,
      light_offset_s=lanes.light_offset_s + stagger,
      light_green_s=lanes.light_green_s,
      light_yellow_s=lanes.light_yellow_s,
      light_red_s=lanes.light_red_s,
      stop_pos=lanes.stop_pos, stop_yaw=lanes.stop_yaw,
      stop_extent=lanes.stop_extent,
      lane_polys=lanes.lane_polys, lane_successors=lanes.lane_successors,
      lane_is_connector=lanes.is_connector)


def load_town(name: str, root: str | None = None,
              rng_seed: int = 0) -> ImportedTown:
  """One town's h5 raster with its recovered lane graph and signalization.

  Memoized in the process and pickled to the disk cache: the recovery
  costs minutes a big town on one host core, and every process (training
  scripts, benchmark runs, tests) would pay it again. A town that is in
  neither needs h5py; without it this raises ImportError."""
  root = os.path.abspath(resolve_assets_root(root))
  key = (name, root, rng_seed)
  if key in _TOWN_CACHE:
    return _TOWN_CACHE[key]
  disk = town_cache_path(name, root, rng_seed)
  if os.path.exists(disk):
    try:
      with open(disk, "rb") as f:
        town = pickle.load(f)
      _TOWN_CACHE[key] = town
      return town
    except Exception:
      pass                       # stale or corrupt cache -> rebuild
  layers, ppm, world_offset = read_town_layers(name, root)
  town = town_from_layers(name, layers, ppm, world_offset, root, rng_seed)
  _TOWN_CACHE[key] = town
  try:
    write_town_cache(town, root, rng_seed)
  except Exception:
    pass
  return town


@dataclasses.dataclass
class RouteDef:
  route_id: str
  town: str
  keypoints_xy: np.ndarray   # [K,2]
  keypoints_yaw: np.ndarray  # [K] radians


def parse_routes_xml(path: str) -> list[RouteDef]:
  """Parse a leaderboard route XML (the route parser's format)."""
  tree = ET.parse(path)
  out = []
  for route in tree.getroot().findall("route"):
    wps = route.findall("waypoint")
    xy = np.array([[float(w.get("x")), float(w.get("y"))] for w in wps],
                  np.float32)
    yaw = np.radians(np.array([float(w.get("yaw")) for w in wps],
                              np.float32))
    out.append(RouteDef(route_id=route.get("id"), town=route.get("town"),
                        keypoints_xy=xy, keypoints_yaw=yaw))
  return out


def load_benchmark_routes(benchmark: str = "longest6",
                          root: str | None = None) -> list[RouteDef]:
  return parse_routes_xml(os.path.join(resolve_assets_root(root),
                                       ROUTES_DIR, f"{benchmark}.xml"))


def write_routes_xml(path: str, routes: list) -> None:
  """Write a leaderboard route XML that ``parse_routes_xml`` reads back:
  routes = [(route_id, town, keypoints_xy [K,2], keypoints_yaw [K] in
  radians), ...]; yaws are stored in degrees, as CARLA's are."""
  top = ET.Element("routes")
  for rid, town, xy, yaw in routes:
    r = ET.SubElement(top, "route", id=str(rid), town=town)
    for (x, y), a in zip(np.asarray(xy), np.asarray(yaw)):
      ET.SubElement(r, "waypoint", x=repr(float(x)), y=repr(float(y)),
                    z="0.0", pitch="0.0", roll="0.0",
                    yaw=repr(float(np.degrees(a))))
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  ET.ElementTree(top).write(path)


def write_scenarios_json(path: str, sites: dict) -> None:
  """Write a scenario annotation file that ``load_scenarios`` reads back:
  sites = {town: {scenario_type: [(x, y, yaw_deg), ...]}}."""
  data = {"available_scenarios": [{town: [
      {"scenario_type": k, "available_event_configurations": [
          {"transform": {"x": float(x), "y": float(y), "z": 0.0,
                         "yaw": float(a), "pitch": 0.0}} for x, y, a in v]}
      for k, v in by_type.items()]} for town, by_type in sites.items()]}
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  with open(path, "w") as f:
    json.dump(data, f)


def load_scenarios(town: str, root: str | None = None) -> dict:
  """Scenario trigger transforms for a town from the public annotations
  (``leaderboard/data/scenarios/all_towns_traffic_scenarios_public.json``
  and ``{town}_all_scenarios.json``, parsed as the route parser scans a
  route for scenarios): {scenario_type: [K,3] (x, y, yaw_rad)}."""
  root = resolve_assets_root(root)
  out = {}
  # the public all-towns file carries Scenario1/3/4; the per-town
  # "*_all_scenarios" files add the Scenario7-10 (junction) transforms
  files = ["all_towns_traffic_scenarios_public.json",
           f"{town.lower()}_all_scenarios.json"]
  for fname in files:
    path = os.path.join(root, ROUTES_DIR, "scenarios", fname)
    if not os.path.exists(path):
      continue
    with open(path) as f:
      data = json.load(f)
    for town_dict in data["available_scenarios"]:
      if town not in town_dict:
        continue
      for grp in town_dict[town]:
        rows = []
        for ev in grp["available_event_configurations"]:
          tr = ev["transform"]
          rows.append([float(tr["x"]), float(tr["y"]),
                       np.radians(float(tr["yaw"]))])
        arr = np.asarray(rows, np.float32)
        # the junction files repeat one transform per actor config:
        # dedupe to unique sites
        arr = np.unique(np.round(arr, 2), axis=0)
        k = grp["scenario_type"]
        out[k] = arr if k not in out else np.unique(
            np.concatenate([out[k], arr]), axis=0)
  return out


def signal_hints_for(town: str, root: str | None = None) -> dict | None:
  """Signalization ground truth where the annotations carry it: the
  Scenario7/8/9 trigger points sit on approaches of signalized junctions,
  Scenario10 on unsignalized ones. Returns {'signalized': [N,2],
  'unsignalized': [M,2]} or None."""
  root = resolve_assets_root(root)
  try:
    sc = load_scenarios(town, root)
  except (OSError, FileNotFoundError):
    return None
  dedup = lambda arrs: np.unique(np.round(np.concatenate(arrs), 1), axis=0) \
      if arrs else np.zeros((0, 2), np.float32)
  sig = dedup([sc[k][:, :2] for k in ("Scenario7", "Scenario8", "Scenario9")
               if k in sc and len(sc[k])])
  unsig = dedup([sc[k][:, :2] for k in ("Scenario10",)
                 if k in sc and len(sc[k])])
  if not len(sig) and not len(unsig):
    return None
  # degeneracy guard: a file that lists the same site set under every
  # scenario type (a blanket data-collection file, as Town02's is) says
  # nothing about signalization; if the signalized and unsignalized site
  # sets mostly overlap, the annotation is ignored
  if len(sig) and len(unsig):
    d = np.linalg.norm(sig[:, None] - unsig[None], axis=-1).min(1)
    if (d < 1.0).mean() > 0.5:
      return None
  return dict(signalized=sig, unsignalized=unsig)


def scenarios_near_route(scenarios: dict, dense: np.ndarray,
                         radius: float = 8.0,
                         yaw_tol: float = np.radians(20.0)) -> dict:
  """Trigger points near the route AND facing its travel direction, with
  their route progress index: {name: (points [M,3], route_idx [M])}.

  The reference's RouteParser matches a trigger to the route by position
  and heading; without the heading gate, annotations of the cross street
  at a junction attach to the route. The yaw test runs per dense point so
  a self-overlapping route matches the pass whose direction agrees."""
  seg = np.diff(dense[:, :2], axis=0)
  ryaw = np.arctan2(seg[:, 1], seg[:, 0])
  ryaw = np.append(ryaw, ryaw[-1])                       # [N]
  out = {}
  for k, pts in scenarios.items():
    if not len(pts):
      continue
    d = np.linalg.norm(dense[None, :, :2] - pts[:, None, :2], axis=-1)
    dyaw = np.abs(np.arctan2(np.sin(pts[:, 2:3] - ryaw[None]),
                             np.cos(pts[:, 2:3] - ryaw[None])))   # [K,N]
    ok = (d < radius) & (dyaw < yaw_tol)
    near = ok.any(1)
    route_idx = np.where(ok, d, np.inf).argmin(1)
    sel = np.nonzero(near)[0]
    out[k] = (pts[sel], route_idx[sel])
  return out


def as_synthetic_town(town: ImportedTown,
                      route_polys: list | None = None) -> SyntheticTown:
  """ImportedTown -> the scene builder's town interface.

  NPC lanes are the town-wide lane graph recovered from the road raster;
  lights and stops are the synthesized signalization; junctions come from
  the raster's JUNCTION channel. `route_polys` is accepted as the JAX
  package accepts it, and ignored."""
  return SyntheticTown(
      raster=town.raster, world_offset=town.world_offset, ppm=town.ppm,
      light_pos=town.light_pos, light_yaw=town.light_yaw,
      light_extent=town.light_extent, light_offset_s=town.light_offset_s,
      light_green_s=town.light_green_s, light_yellow_s=town.light_yellow_s,
      light_red_s=town.light_red_s,
      stop_pos=town.stop_pos,
      stop_yaw=town.stop_yaw,
      stop_extent=town.stop_extent,
      lane_polys=town.lane_polys,
      lane_successors=town.lane_successors,
      junction_centers=np.zeros((0, 2), np.float32),  # use raster channel
      junction_half=0.0,
      xs=np.zeros((0,)), ys=np.zeros((0,)))
