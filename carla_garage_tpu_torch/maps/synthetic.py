"""Procedural grid town (host side; port of
carla_garage_tpu/maps/synthetic.py).

A self-contained stand-in for CARLA's towns: a Manhattan grid of two-lane
streets with junctions, traffic lights, stop signs, sidewalks, a lane graph
for NPC traffic, and a route sampler. Numpy throughout, with the JAX
package's calls in the same order, so a town and a route sampled from one
seed are the same arrays in both packages.

Coordinate conventions follow CARLA (x east, y "south", yaw from +x toward
+y; right vector of heading t = (-sin t, cos t)); right-hand traffic.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from carla_garage_tpu_torch.maps.lane_graph import rasterize_direction
from carla_garage_tpu_torch.maps.town_map import Layer

LANE_W = 3.5            # lane width (m)
SIDEWALK_W = 2.0
JUNCTION_HALF = 8.0     # junction square half-extent (m)
LIGHT_GREEN_S = 10.0
LIGHT_YELLOW_S = 3.0
LIGHT_ALL_RED_S = 2.0


def ground_semantic_channel(road, sidewalk, lane_all):
  """Per-pixel camera semantic class (sensors.raycast.Sem values): road
  line 5 > road 2 > sidewalk 6 > unlabeled 0."""
  sem = np.zeros(road.shape, np.uint8)
  sem[sidewalk] = 6
  sem[road] = 2
  sem[lane_all] = 5
  return sem


@dataclasses.dataclass
class SyntheticTown:
  raster: np.ndarray            # [C,H,W] uint8
  world_offset: np.ndarray      # [2]
  ppm: float
  # traffic lights (unpadded)
  light_pos: np.ndarray         # [L,2]
  light_yaw: np.ndarray         # [L]
  light_extent: np.ndarray      # [L,2]
  light_offset_s: np.ndarray    # [L]
  light_green_s: np.ndarray
  light_yellow_s: np.ndarray
  light_red_s: np.ndarray
  # stop signs
  stop_pos: np.ndarray          # [S,2]
  stop_yaw: np.ndarray
  stop_extent: np.ndarray
  # lane graph
  lane_polys: list
  lane_successors: list
  # junction boxes (axis-aligned): centers [J,2], half size
  junction_centers: np.ndarray
  junction_half: float
  # street coordinates
  xs: np.ndarray
  ys: np.ndarray

  def in_junction(self, points: np.ndarray) -> np.ndarray:
    """points [N,2] -> bool [N]: junction squares if known, else the
    raster JUNCTION channel."""
    if len(self.junction_centers):
      d = np.abs(points[:, None, :] - self.junction_centers[None])
      return np.any(np.all(d <= self.junction_half, -1), -1)
    p = ((points - self.world_offset) * self.ppm).astype(np.int64)
    h, w = self.raster.shape[1:]
    px = np.clip(p[:, 0], 0, w - 1)
    py = np.clip(p[:, 1], 0, h - 1)
    return self.raster[Layer.JUNCTION, py, px] > 0


def grid_layers(n_x: int = 4, n_y: int = 4, block: float = 120.0,
                ppm: float = 4.0, margin: float = 30.0) -> dict:
  """The surface masks [H,W] of an n_x x n_y grid town: road (junctions
  included), sidewalk, the center marking and junction, with the street
  coordinates xs, ys and the junction centers. Each street's masks are
  the outer product of a row and a column test, so a 3,000 px town takes
  seconds, not a full-grid pass per street."""
  xs = margin + np.arange(n_x) * block       # vertical street x coords
  ys = margin + np.arange(n_y) * block       # horizontal street y coords
  width = 2 * margin + (n_x - 1) * block
  height = 2 * margin + (n_y - 1) * block
  wpx, hpx = int(width * ppm), int(height * ppm)
  gx, gy = np.arange(wpx) / ppm, np.arange(hpx) / ppm
  outer = lambda rows, cols: rows[:, None] & cols[None]
  road = np.zeros((hpx, wpx), bool)
  sidewalk = np.zeros_like(road)
  center = np.zeros_like(road)
  junction = np.zeros_like(road)

  x0, x1 = xs[0] - JUNCTION_HALF, xs[-1] + JUNCTION_HALF
  y0, y1 = ys[0] - JUNCTION_HALF, ys[-1] + JUNCTION_HALF
  span_x, span_y = (gx >= x0) & (gx <= x1), (gy >= y0) & (gy <= y1)
  walk = lambda g, c: np.abs(np.abs(g - c) - (LANE_W + SIDEWALK_W / 2)) \
      <= SIDEWALK_W / 2
  for y in ys:                                 # horizontal streets
    road |= outer(np.abs(gy - y) <= LANE_W, span_x)
    sidewalk |= outer(walk(gy, y), span_x)
    center |= outer(np.abs(gy - y) <= 0.15, span_x)
  for x in xs:                                 # vertical streets
    road |= outer(span_y, np.abs(gx - x) <= LANE_W)
    sidewalk |= outer(span_y, walk(gx, x))
    center |= outer(span_y, np.abs(gx - x) <= 0.15)
  sidewalk &= ~road

  centers = np.array([[x, y] for x in xs for y in ys], np.float32)
  for cx, cy in centers:
    junction |= outer(np.abs(gy - cy) <= JUNCTION_HALF,
                      np.abs(gx - cx) <= JUNCTION_HALF)
  road |= junction            # junction interiors are drivable
  sidewalk &= ~road
  for cx, cy in centers:      # sidewalk ring around each junction corner
    ring = outer(np.abs(gy - cy) <= JUNCTION_HALF + SIDEWALK_W,
                 np.abs(gx - cx) <= JUNCTION_HALF + SIDEWALK_W)
    sidewalk |= ring & ~road
  return dict(road=road, sidewalk=sidewalk, center=center,
              junction=junction, xs=xs, ys=ys, centers=centers)


def make_town(n_x: int = 4, n_y: int = 4, block: float = 120.0,
              ppm: float = 4.0, margin: float = 30.0,
              seed: int = 0) -> SyntheticTown:
  """Build an n_x x n_y grid town. Its geometry does not depend on
  `seed`; the seed only names the town."""
  g = grid_layers(n_x, n_y, block, ppm, margin)
  road, sidewalk, junction = g["road"], g["sidewalk"], g["junction"]
  xs, ys, centers = g["xs"], g["ys"], g["centers"]
  lane_broken = g["center"]
  lane_all = lane_broken.copy()
  stopline = np.zeros_like(road)
  world_offset = np.array([0.0, 0.0], np.float32)

  # traffic lights at even junctions, stop signs at some odd ones
  lights, stops = [], []
  cycle = 2 * (LIGHT_GREEN_S + LIGHT_YELLOW_S + LIGHT_ALL_RED_S)
  for j, (cx, cy) in enumerate(centers):
    # 4 approaches: heading east(0), west(pi), "south"(+y, pi/2), north
    approaches = [
        (np.array([cx - JUNCTION_HALF - 1.0, cy + LANE_W / 2]), 0.0, 'ew'),
        (np.array([cx + JUNCTION_HALF + 1.0, cy - LANE_W / 2]), np.pi, 'ew'),
        (np.array([cx - LANE_W / 2, cy - JUNCTION_HALF - 1.0]),
         np.pi / 2, 'ns'),
        (np.array([cx + LANE_W / 2, cy + JUNCTION_HALF + 1.0]),
         -np.pi / 2, 'ns'),
    ]
    if j % 2 == 0:
      for pos, yaw, grp in approaches:
        # stop-line trigger box across the incoming lane
        offset = 0.0 if grp == 'ns' else (LIGHT_GREEN_S + LIGHT_YELLOW_S +
                                          LIGHT_ALL_RED_S)
        lights.append((pos, yaw, np.array([1.5, LANE_W / 2 * 0.9]),
                       offset, LIGHT_GREEN_S, LIGHT_YELLOW_S,
                       cycle - LIGHT_GREEN_S - LIGHT_YELLOW_S))
        px0 = int((pos[0] - world_offset[0]) * ppm)
        py0 = int((pos[1] - world_offset[1]) * ppm)
        stopline[max(py0 - 3, 0):py0 + 3, max(px0 - 3, 0):px0 + 3] = True
    elif j % 4 == 1:
      for pos, yaw, _ in approaches[:2]:       # stop signs on EW approaches
        stops.append((pos, yaw, np.array([2.0, LANE_W / 2])))

  # lane graph: one polyline per street direction segment between
  # junctions, offset to the right of travel; successors go straight
  # through a junction, or U-turn at the grid's boundary
  polys, succ, index = [], [], {}

  def right_of(yaw):
    return np.array([-np.sin(yaw), np.cos(yaw)])

  def add_lane(p_from, p_to):
    d = p_to - p_from
    yaw = np.arctan2(d[1], d[0])
    off = right_of(yaw) * LANE_W / 2
    n = max(int(np.linalg.norm(d) / 4.0), 2)
    polys.append(np.linspace(p_from + off, p_to + off, n))
    succ.append([])
    key = (tuple(np.round(p_from, 1)), tuple(np.round(p_to, 1)))
    index[key] = len(polys) - 1
    return len(polys) - 1

  nodes_h = [[np.array([x, y]) for x in xs] for y in ys]
  for row in nodes_h:
    for a, b in zip(row[:-1], row[1:]):
      add_lane(a, b)
      add_lane(b, a)
  for col in [[np.array([x, y]) for y in ys] for x in xs]:
    for a, b in zip(col[:-1], col[1:]):
      add_lane(a, b)
      add_lane(b, a)
  for (a, b), i in index.items():
    av, bv = np.array(a), np.array(b)
    d = bv - av
    nxt = tuple(np.round(bv + d, 1))
    if (tuple(np.round(bv, 1)), nxt) in index:
      succ[i].append(index[(tuple(np.round(bv, 1)), nxt)])
    elif (b, a) in index:
      succ[i].append(index[(b, a)])

  from scipy import ndimage
  off = ~(road | sidewalk)
  obstacle = ndimage.binary_erosion(off, iterations=int(2.5 * ppm))
  ground_sem = ground_semantic_channel(road, sidewalk, lane_all)
  lane_dir = rasterize_direction(polys, road, 1.0 / ppm, world_offset)
  raster = np.stack([road, sidewalk, lane_all, lane_broken, stopline,
                     junction, obstacle]).astype(np.uint8) * 255
  raster = np.concatenate([raster, ground_sem[None], lane_dir[None]], 0)
  assert raster.shape[0] == Layer.NUM

  if lights:
    lp, ly, le, lo, lg, lyw, lr = map(np.array, zip(*lights))
  else:
    lp = np.zeros((0, 2)); ly = np.zeros((0,)); le = np.zeros((0, 2))
    lo = lg = lyw = lr = np.zeros((0,))
  if stops:
    sp, sy, se = map(np.array, zip(*stops))
  else:
    sp = np.zeros((0, 2)); sy = np.zeros((0,)); se = np.zeros((0, 2))

  return SyntheticTown(
      raster=raster, world_offset=world_offset, ppm=ppm,
      light_pos=lp.astype(np.float32), light_yaw=ly.astype(np.float32),
      light_extent=le.astype(np.float32), light_offset_s=lo.astype(np.float32),
      light_green_s=lg.astype(np.float32),
      light_yellow_s=lyw.astype(np.float32), light_red_s=lr.astype(np.float32),
      stop_pos=sp.astype(np.float32), stop_yaw=sy.astype(np.float32),
      stop_extent=se.astype(np.float32),
      lane_polys=polys, lane_successors=succ,
      junction_centers=centers, junction_half=JUNCTION_HALF,
      xs=xs, ys=ys)


def sample_route_keypoints(town: SyntheticTown, rng: np.random.Generator,
                           min_len_m: float = 300.0,
                           max_turns: int = 12):
  """Random lattice walk along right-hand lanes -> (xy [K,2], yaw [K]).

  Keypoints sit on lane centres at junction entries and exits, so the
  Hermite route compiler produces proper turn arcs. Draws from `rng` in
  the JAX package's order."""
  headings = np.array([[1, 0], [-1, 0], [0, 1], [0, -1]], np.float32)
  ix = rng.integers(0, len(town.xs))
  iy = rng.integers(0, len(town.ys))
  node0 = np.array([town.xs[ix], town.ys[iy]], np.float32)
  block0 = town.xs[1] - town.xs[0] if len(town.xs) > 1 else 120.0
  # the first junction must be approachable from inside the grid: the
  # spawn street (node - h*block) has to exist
  ok = [hh for hh in headings
        if (town.xs[0] - 1 <= (node0 - hh * block0)[0] <= town.xs[-1] + 1
            and town.ys[0] - 1 <= (node0 - hh * block0)[1]
            <= town.ys[-1] + 1)]
  h = ok[rng.integers(0, len(ok))] if ok else headings[0]

  def right_of(v):
    return np.array([-v[1], v[0]], np.float32)

  keypoints, yaws = [], []
  node = np.array([town.xs[ix], town.ys[iy]], np.float32)
  total = 0.0
  prev_exit = None
  for _ in range(max_turns):
    # next heading: straight 3:1 against each turn, staying in the grid
    options = []
    for cand in headings:
      if np.dot(cand, h) < -0.5:
        continue                      # no U-turns
      nxt = node + cand * (town.xs[1] - town.xs[0] if len(town.xs) > 1
                           else 120.0)
      if (town.xs[0] - 1 <= nxt[0] <= town.xs[-1] + 1 and
          town.ys[0] - 1 <= nxt[1] <= town.ys[-1] + 1):
        options.append(cand)
    if not options:
      break
    probs = np.array([3.0 if np.dot(o, h) > 0.5 else 1.0 for o in options])
    h_new = options[rng.choice(len(options), p=probs / probs.sum())]

    # entry keypoint (on the incoming lane, before the junction) and exit
    entry = node - h * (JUNCTION_HALF + 2.0) + right_of(h) * LANE_W / 2
    exit_p = node + h_new * (JUNCTION_HALF + 2.0) + \
        right_of(h_new) * LANE_W / 2
    if prev_exit is None:
      # spawn mid-block, well clear of the first junction's trigger boxes
      spawn = entry - h * 35.0
      lo = np.array([town.xs[0] - JUNCTION_HALF + 2,
                     town.ys[0] - JUNCTION_HALF + 2])
      hi = np.array([town.xs[-1] + JUNCTION_HALF - 2,
                     town.ys[-1] + JUNCTION_HALF - 2])
      keypoints.append(np.clip(spawn, lo, hi))
      yaws.append(np.arctan2(h[1], h[0]))
    if prev_exit is not None:
      total += np.linalg.norm(entry - prev_exit)
    keypoints += [entry, exit_p]
    yaws += [np.arctan2(h[1], h[0]), np.arctan2(h_new[1], h_new[0])]
    prev_exit = exit_p
    h = h_new
    node = node + h * (town.xs[1] - town.xs[0] if len(town.xs) > 1 else 120.0)
    if total >= min_len_m:
      break
  return np.array(keypoints, np.float32), np.array(yaws, np.float32)
