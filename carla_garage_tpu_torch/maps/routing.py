"""Host-side route compiler: sparse keypoints -> dense 1 m centreline
arrays (port of carla_garage_tpu/maps/routing.py; numpy).

Keypoints carry headings, so a C1 cubic-Hermite spline through (position,
heading) pairs reproduces lane-following paths with smooth junction
turns; long gaps between keypoints follow the road surface through a grid
router. Runs once per route; the device only sees the padded arrays
(``structs.Route``).
"""

from __future__ import annotations

import numpy as np

from carla_garage_tpu_torch.maps import native_router
from carla_garage_tpu_torch.structs import Cmd


class RoadRouter:
  """Shortest paths over a downsampled road-occupancy grid: 8-connected
  cells of `stride` pixels, edge costs that favour the road interior."""

  def __init__(self, road_mask, ppm: float, world_offset, stride: int = 8):
    from scipy import ndimage
    H, W = road_mask.shape
    h, w = H // stride, W // stride
    grid = road_mask[:h * stride, :w * stride].reshape(
        h, stride, w, stride).max((1, 3)) > 0
    inside = ndimage.distance_transform_edt(road_mask)[
        stride // 2::stride, stride // 2::stride][:h, :w] / ppm
    self.stride, self.ppm = stride, ppm
    self.world_offset = np.asarray(world_offset, np.float64)
    self.grid = grid
    self.h, self.w = h, w
    ids = -np.ones((h, w), np.int64)
    ys, xs = np.nonzero(grid)
    ids[ys, xs] = np.arange(len(xs))
    self.ids = ids
    self.cell_yx = np.stack([ys, xs], -1)
    # interior preference: hugging the edge costs up to 3x
    node_pen = 1.0 + 2.0 * np.clip(1.0 - inside[ys, xs] / 3.0, 0.0, 1.0)
    self.penalty_grid = np.zeros((h, w), np.float32)
    self.penalty_grid[ys, xs] = node_pen
    self.cell_m = stride / ppm
    self._node_pen = node_pen
    self._graph = None          # scipy's graph, built on first use

  @property
  def graph(self):
    if self._graph is None:
      from scipy import sparse
      grid, ids = self.grid, self.ids
      h, w = self.h, self.w
      ys, xs = self.cell_yx[:, 0], self.cell_yx[:, 1]
      node_pen = self._node_pen
      rows, cols, vals = [], [], []
      for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
          if dx == 0 and dy == 0:
            continue
          ys2, xs2 = ys + dy, xs + dx
          ok = (ys2 >= 0) & (ys2 < h) & (xs2 >= 0) & (xs2 < w)
          ok[ok] &= grid[ys2[ok], xs2[ok]]
          src = ids[ys[ok], xs[ok]]
          dst = ids[ys2[ok], xs2[ok]]
          cost = np.hypot(dx, dy) * self.cell_m * 0.5 * (
              node_pen[src] + node_pen[dst])
          rows.append(src)
          cols.append(dst)
          vals.append(cost)
      n = len(xs)
      self._graph = sparse.csr_matrix(
          (np.concatenate(vals), (np.concatenate(rows),
                                  np.concatenate(cols))), shape=(n, n))
    return self._graph

  def _node(self, xy):
    p = (np.asarray(xy, np.float64) - self.world_offset) * self.ppm
    cx = int(np.clip(p[0] // self.stride, 0, self.w - 1))
    cy = int(np.clip(p[1] // self.stride, 0, self.h - 1))
    if self.ids[cy, cx] >= 0:
      return int(self.ids[cy, cx])
    # nearest road cell within a small window
    best, bd = -1, 1e18
    r = 4
    for yy in range(max(cy - r, 0), min(cy + r + 1, self.h)):
      for xx in range(max(cx - r, 0), min(cx + r + 1, self.w)):
        if self.ids[yy, xx] >= 0:
          d = (yy - cy) ** 2 + (xx - cx) ** 2
          if d < bd:
            bd, best = d, int(self.ids[yy, xx])
    return best

  def route(self, a_xy, b_xy):
    """Road path between two world points -> [N,2] world coords or None.

    The native C++ A* (``maps/native_router.py``) when it loads, else
    scipy's csgraph Dijkstra; the two may return different paths."""
    a, b = self._node(a_xy), self._node(b_xy)
    if a < 0 or b < 0:
      return None
    if native_router.available():
      ay, ax = self.cell_yx[a]
      by, bx = self.cell_yx[b]
      cells = native_router.route_grid(
          self.grid, self.penalty_grid, int(ay) * self.w + int(ax),
          int(by) * self.w + int(bx), self.cell_m)
      if cells is not None:
        yx = np.stack([cells // self.w, cells % self.w], -1)
        xy = (yx[:, ::-1] + 0.5) * self.stride / self.ppm
        return (xy + self.world_offset).astype(np.float32)
      return None
    from scipy.sparse import csgraph
    _, pred = csgraph.dijkstra(self.graph, indices=a,
                               return_predecessors=True)
    if pred[b] < 0 and a != b:
      return None
    path = [b]
    while path[-1] != a:
      nxt = pred[path[-1]]
      if nxt < 0:
        break
      path.append(int(nxt))
    path = path[::-1]
    yx = self.cell_yx[path]
    xy = (yx[:, ::-1] + 0.5) * self.stride / self.ppm
    return (xy + self.world_offset).astype(np.float32)


def interpolate_keypoints_routed(xy: np.ndarray, yaw: np.ndarray,
                                 router: "RoadRouter | None",
                                 hop: float = 1.0,
                                 gap_threshold: float = 35.0) -> np.ndarray:
  """interpolate_keypoints, but keypoint gaps longer than gap_threshold
  follow the road through the router instead of a blind Hermite arc."""
  pieces = []
  for i in range(len(xy) - 1):
    p0, p1 = xy[i], xy[i + 1]
    d = np.linalg.norm(p1 - p0)
    if d < 1e-6:
      continue
    path = None
    if router is not None and d > gap_threshold:
      path = router.route(p0, p1)
      if path is not None and len(path) >= 3:
        # drop the endpoints (replaced by the exact keypoints), smooth
        mid = path[1:-1].astype(np.float64)
        if len(mid) >= 5:
          k = np.ones(3) / 3
          mid[:, 0] = np.convolve(mid[:, 0], k, mode="same") * 1.0 + 0.0
          mid[:, 1] = np.convolve(mid[:, 1], k, mode="same")
          mid[0] = path[1]
          mid[-1] = path[-2]
        pieces.append(np.concatenate([[p0], mid], 0).astype(np.float32))
        continue
    t0 = d * np.array([np.cos(yaw[i]), np.sin(yaw[i])])
    t1 = d * np.array([np.cos(yaw[i + 1]), np.sin(yaw[i + 1])])
    pieces.append(hermite_segment(p0, t0, p1, t1,
                                  max(int(d / hop) * 8, 8)).astype(
        np.float32))
  pieces.append(xy[-1:])
  fine = np.concatenate(pieces, 0)
  seg = np.linalg.norm(np.diff(fine, axis=0), axis=-1)
  arc = np.concatenate([[0.0], np.cumsum(seg)])
  total = arc[-1]
  n_out = max(int(np.floor(total / hop)) + 1, 2)
  targets = np.arange(n_out) * hop
  out = np.stack([np.interp(targets, arc, fine[:, 0]),
                  np.interp(targets, arc, fine[:, 1])], -1)
  return out.astype(np.float32)


def hermite_segment(p0, t0, p1, t1, n):
  """Cubic Hermite curve samples (excluding endpoint). p,t [2]; n samples."""
  s = np.linspace(0.0, 1.0, n, endpoint=False)[:, None]
  h00 = 2 * s**3 - 3 * s**2 + 1
  h10 = s**3 - 2 * s**2 + s
  h01 = -2 * s**3 + 3 * s**2
  h11 = s**3 - s**2
  return h00 * p0 + h10 * t0 + h01 * p1 + h11 * t1


def interpolate_keypoints(xy: np.ndarray, yaw: np.ndarray,
                          hop: float = 1.0) -> np.ndarray:
  """Dense points [R,2] at ~hop spacing through keypoints with headings
  (xy [K,2], yaw [K] radians), Hermite arcs between them."""
  pieces = []
  for i in range(len(xy) - 1):
    p0, p1 = xy[i], xy[i + 1]
    d = np.linalg.norm(p1 - p0)
    if d < 1e-6:
      continue
    t0 = d * np.array([np.cos(yaw[i]), np.sin(yaw[i])])
    t1 = d * np.array([np.cos(yaw[i + 1]), np.sin(yaw[i + 1])])
    pieces.append(hermite_segment(p0, t0, p1, t1, max(int(d / hop) * 8, 8)))
  pieces.append(xy[-1:])
  fine = np.concatenate(pieces, 0)
  # resample to uniform hop spacing by arc length
  seg = np.linalg.norm(np.diff(fine, axis=0), axis=-1)
  arc = np.concatenate([[0.0], np.cumsum(seg)])
  total = arc[-1]
  n_out = max(int(np.floor(total / hop)) + 1, 2)
  targets = np.arange(n_out) * hop
  out = np.stack([np.interp(targets, arc, fine[:, 0]),
                  np.interp(targets, arc, fine[:, 1])], -1)
  if total - targets[-1] > 0.25 * hop:
    out = np.concatenate([out, fine[-1:]], 0)
  return out.astype(np.float32)


def classify_commands(points: np.ndarray, junction_mask: np.ndarray,
                      turn_threshold_deg: float = 25.0) -> np.ndarray:
  """Per-point navigation command from geometry: junction traversals get
  LEFT / RIGHT / STRAIGHT by the heading change across the junction,
  everything else LANE_FOLLOW."""
  n = len(points)
  cmd = np.full((n,), Cmd.LANE_FOLLOW, np.int32)
  yaws = np.arctan2(*np.diff(points, axis=0).T[::-1])
  yaws = np.concatenate([yaws, yaws[-1:]])
  i = 0
  while i < n:
    if junction_mask[i]:
      j = i
      while j < n and junction_mask[j]:
        j += 1
      a0 = yaws[max(i - 2, 0)]
      a1 = yaws[min(j + 1, n - 1)]
      dyaw = np.degrees(np.arctan2(np.sin(a1 - a0), np.cos(a1 - a0)))
      # CARLA yaw grows clockwise (y "south"): positive = right turn
      if dyaw > turn_threshold_deg:
        c = Cmd.RIGHT
      elif dyaw < -turn_threshold_deg:
        c = Cmd.LEFT
      else:
        c = Cmd.STRAIGHT
      cmd[i:j] = c
      i = j
    else:
      i += 1
  return cmd


def downsample_route(points: np.ndarray, cmd: np.ndarray,
                     spacing_m: float = 50.0):
  """Sparse command route: keep command-change boundaries and a point
  every `spacing_m`."""
  keep = [0]
  dist = 0.0
  for i in range(1, len(points)):
    dist += float(np.linalg.norm(points[i] - points[i - 1]))
    cmd_change = cmd[i] != cmd[i - 1]
    if cmd_change or dist >= spacing_m or i == len(points) - 1:
      keep.append(i)
      dist = 0.0
  keep = np.asarray(sorted(set(keep)), np.int32)
  return points[keep], cmd[keep]


def sample_lane_route(lane_polys, lane_successors,
                      rng: np.random.Generator,
                      min_len_m: float = 250.0, max_len_m: float = 500.0,
                      is_connector=None, kp_spacing: float = 20.0):
  """Random walk over a town's directed lane graph -> (xy [K,2], yaw [K])
  with keypoints every `kp_spacing` metres, or None when no long enough
  walk exists from the sampled start (the caller retries)."""
  n = len(lane_polys)
  if n == 0:
    return None
  poly = None
  for _ in range(32):
    li = int(rng.integers(0, n))
    if is_connector is not None and len(is_connector) == n and \
        bool(is_connector[li]):
      continue                      # don't start mid-junction
    p = np.asarray(lane_polys[li], np.float32)
    if len(p) >= 2:
      li0, poly = li, p
      break
  if poly is None:
    return None
  parts = [poly]
  total = float(np.linalg.norm(np.diff(poly, axis=0), axis=-1).sum())
  cur = li0
  for _ in range(64):
    if total >= max_len_m:
      break
    succ = lane_successors[cur]
    if not succ:
      break
    cur = int(succ[rng.integers(0, len(succ))])
    p = np.asarray(lane_polys[cur], np.float32)
    if len(p) < 2:
      break
    parts.append(p)
    total += float(np.linalg.norm(np.diff(p, axis=0), axis=-1).sum())
    if total >= min_len_m and rng.random() < 0.2:
      break                         # vary route length
  if total < min_len_m:
    return None
  path = np.concatenate(parts)
  seg = np.linalg.norm(np.diff(path, axis=0), axis=-1)
  arc = np.concatenate([[0.0], np.cumsum(seg)])
  t = np.append(np.arange(0.0, arc[-1], kp_spacing), arc[-1])
  xy = np.stack([np.interp(t, arc, path[:, 0]),
                 np.interp(t, arc, path[:, 1])], -1).astype(np.float32)
  d = np.gradient(xy, axis=0)
  yaw = np.arctan2(d[:, 1], d[:, 0]).astype(np.float32)
  return xy, yaw
