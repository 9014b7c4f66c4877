"""Town-wide lane-graph recovery from road rasters (host side; port of
carla_garage_tpu/maps/lane_graph.py, numpy and scipy).

The CARLA town rasters carry geometry only: no topology, and empty
`stopline` layers. This module recovers what the simulator needs from the
binary road layer:

  1. skeletonize the road raster (Zhang-Suen thinning);
  2. build a node/edge centerline graph (junction nodes = skeleton branch
     points, edges = centerline polylines between them);
  3. emit directed lanes per edge, offset right of travel by the local road
     half-width (right-hand traffic), with one-way carriageway detection
     (yellow center marking / twin-carriageway side test);
  4. connect lanes across junctions with Hermite connector arcs (successor
     topology for NPC routing);
  5. synthesize signalization: traffic-light stop-line trigger boxes on every
     approach of major junctions with coordinated 2-phase timing, stop signs
     on the minor entries of unsignalized T-junctions;
  6. rasterize a per-pixel lane DIRECTION channel (16 yaw bins) used by the
     wrong-way test of the OutsideRouteLanes criterion.

The code is the JAX package's, call for call and in the same order (the
pixel set that ``extract_graph`` walks is iterated as a Python ``set``), so
a raster gives the same floats, lanes and successor lists in both
packages. It is one-time host preprocessing; ``maps/importer.py`` turns
its output into the town the scene builder takes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy import ndimage

LANE_W = 3.5
LIGHT_GREEN_S = 10.0
LIGHT_YELLOW_S = 3.0
LIGHT_ALL_RED_S = 2.0
DIR_BINS = 16          # lane-direction raster quantization


# ---------------------------------------------------------------------------
# 1. Skeletonization (Zhang-Suen thinning, vectorized numpy)
# ---------------------------------------------------------------------------

def _shift(a: np.ndarray, dy: int, dx: int) -> np.ndarray:
  """Zero-padded shift: value of the neighbor at (dy,dx)."""
  h, w = a.shape
  out = np.zeros_like(a)
  ys0, ys1 = max(dy, 0), h + min(dy, 0)
  xs0, xs1 = max(dx, 0), w + min(dx, 0)
  out[ys0:ys1, xs0:xs1] = a[max(-dy, 0):h - max(dy, 0),
                            max(-dx, 0):w - max(dx, 0)]
  return out


def _neighbors8(a: np.ndarray):
  """P2..P9: clockwise from north (Zhang-Suen convention)."""
  return [_shift(a, -1, 0), _shift(a, -1, 1), _shift(a, 0, 1),
          _shift(a, 1, 1), _shift(a, 1, 0), _shift(a, 1, -1),
          _shift(a, 0, -1), _shift(a, -1, -1)]


def skeletonize(mask: np.ndarray, max_iter: int = 200) -> np.ndarray:
  """Zhang-Suen thinning of a boolean mask to a 1-px skeleton."""
  img = mask.astype(np.uint8).copy()
  for _ in range(max_iter):
    changed = False
    for step in (0, 1):
      p = _neighbors8(img)
      b = sum(p)                                     # neighbor count
      seq = p + [p[0]]
      a = sum(((seq[i] == 0) & (seq[i + 1] == 1)).astype(np.uint8)
              for i in range(8))                     # 0->1 transitions
      if step == 0:
        c1 = p[0] * p[2] * p[4] == 0                 # P2*P4*P6
        c2 = p[2] * p[4] * p[6] == 0                 # P4*P6*P8
      else:
        c1 = p[0] * p[2] * p[6] == 0                 # P2*P4*P8
        c2 = p[0] * p[4] * p[6] == 0                 # P2*P6*P8
      rm = (img == 1) & (b >= 2) & (b <= 6) & (a == 1) & c1 & c2
      if rm.any():
        img[rm] = 0
        changed = True
    if not changed:
      break
  return img.astype(bool)


# ---------------------------------------------------------------------------
# 2. Centerline graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CenterGraph:
  """nodes [J,2] px centers; edges = list of (polyline_px [P,2],
  node_a, node_b) with node index -1 for dangling (dead-end) ends."""
  nodes: np.ndarray
  edges: list


def extract_graph(skel: np.ndarray) -> CenterGraph:
  nb = sum(_neighbors8(skel.astype(np.uint8)))
  branch = skel & (nb >= 3)
  # cluster branch pixels into junction nodes (nearby branches merge)
  lab, n_nodes = ndimage.label(
      ndimage.binary_dilation(branch, iterations=3),
      structure=np.ones((3, 3)))
  lab = np.where(branch, lab, 0)
  if n_nodes:
    cys, cxs = [], []
    for i in range(1, n_nodes + 1):
      ys, xs = np.nonzero(lab == i)
      cys.append(ys.mean())
      cxs.append(xs.mean())
    nodes = np.stack([cxs, cys], -1).astype(np.float32)
  else:
    nodes = np.zeros((0, 2), np.float32)

  # path components = skeleton minus branch pixels
  paths = skel & ~branch
  plab, n_paths = ndimage.label(paths, structure=np.ones((3, 3)))
  edges = []
  offs = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
          (1, 1)]
  for i in range(1, n_paths + 1):
    ys, xs = np.nonzero(plab == i)
    if len(ys) < 3:
      continue
    pix = set(zip(ys.tolist(), xs.tolist()))
    # endpoints: <=1 neighbor inside the component
    ends = []
    for (y, x) in pix:
      cnt = sum((y + dy, x + dx) in pix for dy, dx in offs)
      if cnt <= 1:
        ends.append((y, x))
    start = ends[0] if ends else next(iter(pix))
    # ordered walk
    order = [start]
    seen = {start}
    cur = start
    while True:
      nxt = None
      for dy, dx in offs:
        cand = (cur[0] + dy, cur[1] + dx)
        if cand in pix and cand not in seen:
          nxt = cand
          break
      if nxt is None:
        break
      order.append(nxt)
      seen.add(nxt)
      cur = nxt
    poly = np.array([[x, y] for (y, x) in order], np.float32)

    def node_at(py, px):
      for dy, dx in offs + [(0, 0)]:
        l = lab[min(max(py + dy, 0), lab.shape[0] - 1),
                min(max(px + dx, 0), lab.shape[1] - 1)]
        if l > 0:
          return l - 1
      return -1

    na = node_at(order[0][0], order[0][1])
    nb_ = node_at(order[-1][0], order[-1][1])
    edges.append((poly, na, nb_))
  return CenterGraph(nodes=nodes, edges=edges)


# ---------------------------------------------------------------------------
# 3-6. Town lanes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TownLanes:
  """Host-side lane network + synthesized signalization for one town."""
  lane_polys: list            # [P,2] world-m directed polylines
  lane_successors: list       # list[list[int]]
  lane_halfwidth: np.ndarray  # [N] m — half width of the lane's corridor
  is_connector: np.ndarray    # [N] bool — junction connector arcs
  junction_centers: np.ndarray  # [J,2] world m
  junction_radius: np.ndarray   # [J] m
  light_pos: np.ndarray       # [L,2]
  light_yaw: np.ndarray
  light_extent: np.ndarray
  light_offset_s: np.ndarray
  light_green_s: np.ndarray
  light_yellow_s: np.ndarray
  light_red_s: np.ndarray
  stop_pos: np.ndarray        # [S,2]
  stop_yaw: np.ndarray
  stop_extent: np.ndarray
  direction_raster: np.ndarray  # [H,W] uint8: 0=none, 1..DIR_BINS yaw bin


def _smooth_resample(poly: np.ndarray, step: float = 3.0,
                     k: int = 5) -> np.ndarray:
  """Moving-average smooth + arc-length resample of a polyline (meters)."""
  if len(poly) >= k:
    pad = np.concatenate([poly[:1].repeat(k // 2, 0), poly,
                          poly[-1:].repeat(k // 2, 0)])
    ker = np.ones(k) / k
    poly = np.stack([np.convolve(pad[:, 0], ker, "valid"),
                     np.convolve(pad[:, 1], ker, "valid")], -1)
  seg = np.linalg.norm(np.diff(poly, axis=0), axis=-1)
  arc = np.concatenate([[0.0], np.cumsum(seg)])
  total = arc[-1]
  if total < step:
    return poly[[0, -1]]
  t = np.arange(0.0, total + step / 2, step)
  return np.stack([np.interp(t, arc, poly[:, 0]),
                   np.interp(t, arc, poly[:, 1])], -1).astype(np.float32)


def _hermite(p0, y0, p1, y1, step: float = 2.0) -> np.ndarray:
  """Cubic Hermite arc from (p0,heading y0) to (p1,heading y1)."""
  d = max(np.linalg.norm(p1 - p0), 1.0)
  m0 = np.array([np.cos(y0), np.sin(y0)]) * d
  m1 = np.array([np.cos(y1), np.sin(y1)]) * d
  n = max(int(d / step) + 2, 4)
  t = np.linspace(0.0, 1.0, n)[:, None]
  h00 = 2 * t ** 3 - 3 * t ** 2 + 1
  h10 = t ** 3 - 2 * t ** 2 + t
  h01 = -2 * t ** 3 + 3 * t ** 2
  h11 = t ** 3 - t ** 2
  return (h00 * p0 + h10 * m0 + h01 * p1 + h11 * m1).astype(np.float32)


def _poly_yaw(poly: np.ndarray) -> np.ndarray:
  d = np.diff(poly, axis=0)
  yaw = np.arctan2(d[:, 1], d[:, 0])
  return np.concatenate([yaw, yaw[-1:]])


def _offset_poly(poly: np.ndarray, lateral: float) -> np.ndarray:
  """Offset a polyline laterally (positive = right of travel; CARLA frame
  right vector of heading t = (-sin t, cos t))."""
  yaw = _poly_yaw(poly)
  right = np.stack([-np.sin(yaw), np.cos(yaw)], -1)
  return (poly + right * lateral).astype(np.float32)


def build_town_lanes(road: np.ndarray, ppm: float,
                     world_offset: np.ndarray,
                     yellow: np.ndarray | None = None,
                     rng_seed: int = 0,
                     direction_hints: np.ndarray | None = None,
                     signal_hints: dict | None = None
                     ) -> TownLanes:
  """Extract the full lane network + signalization from a road raster.

  road: [H,W] bool full-res (ppm px/m). yellow: optional yellow-marking
  layer (same shape) for two-way detection on US-style towns.
  direction_hints: optional [K,3] (x, y, yaw) ground-truth travel
  directions — e.g. the benchmark route XML keypoints, which come from
  the real OpenDRIVE map — used to orient one-way carriageways the
  raster geometry alone cannot disambiguate.
  signal_hints: optional {'signalized': [N,2], 'unsignalized': [M,2]}
  world points at REAL junction approaches — the scenario annotations'
  Scenario7-9 (signalized) / Scenario10 (unsignalized) trigger
  transforms, which come from the real OpenDRIVE map
  (leaderboard/data/scenarios/*_all_scenarios.json). A junction whose
  center lies near a hint gets its signalization forced to ground truth
  instead of the geometric heuristic.
  """
  f = max(int(round(ppm)), 1)          # downsample to ~1 m/px for thinning
  pixel_m = f / ppm                    # meters per downsampled pixel
  H, W = road.shape
  hp, wp = H // f * f, W // f * f
  ds = road[:hp, :wp].reshape(hp // f, f, wp // f, f).max((1, 3))
  # fill 1-px holes so lane-marking gaps don't split the skeleton (keep
  # real medians >= ~2 m intact so divided carriageways stay separate)
  ds = ndimage.binary_closing(ds, structure=np.ones((3, 3)))
  skel = skeletonize(ds)
  graph = extract_graph(skel)

  # half-width on the downsampled grid (EDT at full res is the cost hot
  # spot for the big towns; +-0.5 m accuracy is plenty here)
  edt_m = ndimage.distance_transform_edt(ds) * pixel_m
  if yellow is not None:
    yds = yellow[:hp, :wp].reshape(hp // f, f, wp // f, f).max((1, 3))
  else:
    yds = None

  def _px(pts_m: np.ndarray):
    p = (pts_m - world_offset) / pixel_m
    px = np.clip(np.round(p[..., 0]).astype(int), 0, ds.shape[1] - 1)
    py = np.clip(np.round(p[..., 1]).astype(int), 0, ds.shape[0] - 1)
    return px, py

  def halfwidth_at(pts_m: np.ndarray) -> np.ndarray:
    px, py = _px(pts_m)
    return edt_m[py, px]

  def sample_mask(mask: np.ndarray, pts_m: np.ndarray) -> np.ndarray:
    px, py = _px(pts_m)
    return mask[py, px]

  # --- per-edge corridors -> directed lanes ---
  lane_polys: list = []
  lane_succ: list = []
  lane_half: list = []
  lane_conn: list = []
  # bookkeeping for junction wiring: per node, incoming/outgoing lane ids
  n_nodes = len(graph.nodes)
  node_in: list = [[] for _ in range(n_nodes)]
  node_out: list = [[] for _ in range(n_nodes)]
  # (lane_id -> (node at end, node at start)) for signal placement
  edge_of_lane: list = []

  def add_lane(poly, half, node_from, node_to, connector=False):
    lane_polys.append(poly)
    lane_succ.append([])
    lane_half.append(half)
    lane_conn.append(connector)
    edge_of_lane.append((node_from, node_to))
    lid = len(lane_polys) - 1
    if node_to >= 0:
      node_in[node_to].append(lid)
    if node_from >= 0:
      node_out[node_from].append(lid)
    return lid

  # --- phase 1: corridor classification ---
  # A yellow marking running along the centerline marks a two-way road
  # (US-style towns); absent that, a one-way carriageway is recognized by
  # its twin: a parallel road corridor across a median on ONE side. In a
  # town WITHOUT any yellow markings (Town06-style: all divided
  # carriageways + ramps), corridors with road on both or neither side
  # are "unknown" and get their direction by flow-continuity propagation
  # from oriented neighbors (phase 2) — treating them as two-way would
  # put oncoming lanes on one-way highways.
  town_has_yellow = yellow is not None and yellow.sum() > 500
  corridors = []    # dict(center, half, na, nb, mode) mode: two|one|unk
  for poly_px, na, nb in graph.edges:
    center = _smooth_resample(poly_px * f / ppm + world_offset, step=3.0)
    if len(center) < 2:
      continue
    seg_total = np.linalg.norm(np.diff(center, axis=0), axis=-1).sum()
    if seg_total < 8.0 and na >= 0 and nb >= 0:
      continue                       # sliver between merged junctions
    half = float(np.median(halfwidth_at(center)))
    if half < 1.2:
      continue                       # too narrow to drive
    yellow_center = False
    if yds is not None:
      yfrac = max(float(np.mean(sample_mask(yds, _offset_poly(center, o))))
                  for o in (-1.0, 0.0, 1.0))
      yellow_center = yfrac > 0.25
    mode = "two"
    if not yellow_center:
      # twin carriageway probe: first road hit beyond the edge per side.
      # In yellow-marked towns parallel STREETS sit ~40+ m apart, so the
      # probe stays short; in no-yellow (all-divided) towns the twin
      # carriageway itself can be across a ~50 m median (Town06), so
      # probe much further — there is nothing two-way to confuse it with.
      reach = 22.0 if town_has_yellow else 60.0
      probes = np.arange(half + 2.0, half + reach, 2.0)
      nl = nr = 0
      first_l, first_r = np.inf, np.inf
      yaws = _poly_yaw(center)
      for frac in (0.3, 0.5, 0.7):
        i = int(len(center) * frac)
        yaw_i = yaws[i]
        left = np.array([np.sin(yaw_i), -np.cos(yaw_i)])
        hl = sample_mask(ds, center[i] + left[None] * probes[:, None])
        hr = sample_mask(ds, center[i] - left[None] * probes[:, None])
        nl += int(hl.sum())
        nr += int(hr.sum())
        if hl.any():
          first_l = min(first_l, float(probes[np.argmax(hl)]))
        if hr.any():
          first_r = min(first_r, float(probes[np.argmax(hr)]))
      tot = 3 * len(probes)
      if nl >= 0.25 * tot and nr <= 0.08 * tot:
        mode = "one"                 # twin already on the left
      elif nr >= 0.25 * tot and nl <= 0.08 * tot:
        mode = "one"
        center = center[::-1]        # flip so the twin is on the left
        na, nb = nb, na
      elif not town_has_yellow:
        # divided-carriageway town: prefer the CLOSER parallel band as
        # the twin (medians are narrower than block gaps); ambiguous
        # corridors resolve by propagation
        if np.isfinite(first_l) and (first_l < first_r - 3.0):
          mode = "one"
        elif np.isfinite(first_r) and (first_r < first_l - 3.0):
          mode = "one"
          center = center[::-1]
          na, nb = nb, na
        else:
          mode = "unk"
    corridors.append(dict(center=center, half=half, na=na, nb=nb,
                          mode=mode))

  # --- phase 1b: ground-truth direction hints override geometry ---
  # (only where the corridor is not a confirmed yellow-center two-way:
  # a hint along a two-way road is just one legal direction of it)
  if direction_hints is not None and len(direction_hints):
    hints = np.asarray(direction_hints, np.float32)
    for c in corridors:
      if town_has_yellow and c["mode"] == "two":
        continue
      center = c["center"]
      yaws = _poly_yaw(center)
      d = np.linalg.norm(hints[:, None, :2] - center[None], axis=-1)
      near = d.min(1) < max(c["half"] + 2.0, 6.0)
      if not near.any():
        continue
      fwd = rev = 0
      for hi in np.nonzero(near)[0]:
        ci = int(d[hi].argmin())
        dy = abs(np.arctan2(np.sin(hints[hi, 2] - yaws[ci]),
                            np.cos(hints[hi, 2] - yaws[ci])))
        if dy < 1.05:
          fwd += 1
        elif dy > 2.1:
          rev += 1
      if fwd and rev:
        c["mode"] = "two"            # driven both ways => two-way
      elif fwd:
        c["mode"] = "one"
      elif rev:
        c["mode"] = "one"
        c["center"] = c["center"][::-1]
        c["na"], c["nb"] = c["nb"], c["na"]

  # --- phase 2: orient unknown corridors by flow continuity ---
  def _end_dirs(c):
    yaws = _poly_yaw(c["center"])
    return c["center"][0], yaws[0], c["center"][-1], yaws[-1]

  for _ in range(4):
    changed = False
    for c in corridors:
      if c["mode"] != "unk":
        continue
      score_fwd = score_rev = 0
      p0, y0, p1, y1 = _end_dirs(c)
      for o in corridors:
        # only ORIENTED neighbors carry flow constraints (two-way
        # corridors are direction-free and constrain nothing)
        if o is c or o["mode"] != "one":
          continue
        q0, w0, q1, w1 = _end_dirs(o)
        pairs = [(q1, w1, "out_of_o"), (q0, w0, "into_o")]
        for q, wy, kind in pairs:
          # o's end feeds c's start (forward) / c's end (reverse)?
          if kind == "out_of_o":
            if np.linalg.norm(q - p0) < 12.0 and \
               abs(np.arctan2(np.sin(wy - y0), np.cos(wy - y0))) < 1.2:
              score_fwd += 1
            if np.linalg.norm(q - p1) < 12.0 and \
               abs(np.arctan2(np.sin(wy + np.pi - y1),
                              np.cos(wy + np.pi - y1))) < 1.2:
              score_rev += 1
          else:        # c feeds INTO o's start
            if np.linalg.norm(q - p1) < 12.0 and \
               abs(np.arctan2(np.sin(wy - y1), np.cos(wy - y1))) < 1.2:
              score_fwd += 1
            if np.linalg.norm(q - p0) < 12.0 and \
               abs(np.arctan2(np.sin(wy + np.pi - y0),
                              np.cos(wy + np.pi - y0))) < 1.2:
              score_rev += 1
      if score_fwd > score_rev:
        c["mode"] = "one"
        changed = True
      elif score_rev > score_fwd:
        c["mode"] = "one"
        c["center"] = c["center"][::-1]
        c["na"], c["nb"] = c["nb"], c["na"]
        changed = True
    if not changed:
      break
  for c in corridors:
    if c["mode"] == "unk":
      c["mode"] = "two"              # safe fallback

  # --- lane emission ---
  for c in corridors:
    center, half, na, nb = c["center"], c["half"], c["na"], c["nb"]
    if c["mode"] == "two":
      n_per = int(np.clip(round(half / LANE_W), 1, 2))
      for k in range(n_per):
        lat = (k + 0.5) / n_per * half
        add_lane(_offset_poly(center, lat), half, na, nb)
        # the reverse lane offsets right relative to ITS travel direction
        add_lane(_offset_poly(center[::-1], lat), half, nb, na)
    else:
      n_per = int(np.clip(round(2 * half / LANE_W), 1, 4))
      for k in range(n_per):
        lat = ((k + 0.5) / n_per - 0.5) * 2 * half
        add_lane(_offset_poly(center, lat), half, na, nb)

  # --- junction connectors + successors ---
  for j in range(n_nodes):
    for li in node_in[j]:
      pe = lane_polys[li][-1]
      ye = _poly_yaw(lane_polys[li])[-1]
      cands = []
      for lo in node_out[j]:
        ps = lane_polys[lo][0]
        ys = _poly_yaw(lane_polys[lo])[0]
        turn = abs(np.arctan2(np.sin(ys - ye), np.cos(ys - ye)))
        # no U-turn back onto the reverse twin of the same corridor
        if turn > 2.5 and np.linalg.norm(ps - pe) < 2 * LANE_W:
          continue
        if turn > 2.8:
          continue
        cands.append((turn, lo, ps, ys))
      cands.sort(key=lambda c: c[0])
      for turn, lo, ps, ys in cands[:4]:
        arc = _hermite(pe, ye, ps, ys)
        cid = add_lane(arc, LANE_W / 2, -1, -1, connector=True)
        lane_succ[cid].append(lo)
        lane_succ[li].append(cid)

  # dead-end lanes: U-turn onto the reverse lane if one starts nearby
  for li, poly in enumerate(lane_polys):
    if lane_succ[li] or lane_conn[li]:
      continue
    pe = poly[-1]
    for lo, p2 in enumerate(lane_polys):
      if lo != li and not lane_conn[lo] and \
         np.linalg.norm(p2[0] - pe) < 3 * LANE_W:
        lane_succ[li].append(lo)
        break

  # --- signalization ---
  lights, stops = [], []
  junction_centers, junction_radius = [], []
  cycle = 2 * (LIGHT_GREEN_S + LIGHT_YELLOW_S + LIGHT_ALL_RED_S)
  node_world = graph.nodes * f / ppm + world_offset if n_nodes else \
      np.zeros((0, 2), np.float32)
  for j in range(n_nodes):
    # approaches = incoming non-connector lanes, deduped per corridor side
    inc = [li for li in node_in[j] if not lane_conn[li]]
    if not inc:
      continue
    yaws = np.array([_poly_yaw(lane_polys[li])[-1] for li in inc])
    halfs = np.array([lane_half[li] for li in inc])
    # distinct approach directions (cluster by yaw within 30 deg)
    dirs: list = []
    for y in yaws:
      if not any(abs(np.arctan2(np.sin(y - d), np.cos(y - d))) < 0.5
                 for d in dirs):
        dirs.append(float(y))
    n_app = len(dirs)
    if n_app < 3 and not (n_app == 2 and len(inc) >= 4):
      continue                        # through-road kink, not a junction
    junction_centers.append(node_world[j])
    junction_radius.append(float(halfs.max() + 4.0))
    # CARLA's urban towns signalize junctions by default; a T-junction
    # whose stem is clearly narrower than the through road gets stop signs
    # on the minor entries instead (the "unsignalized minor entry" case).
    signalized = n_app >= 4 or halfs.min() > 0.7 * halfs.max()
    # ground-truth override where the scenario annotations mark this
    # junction (hint transforms sit on approach lanes ~10-20 m out)
    if signal_hints:
      r_hint = float(halfs.max()) + 20.0
      d_sig = d_unsig = np.inf
      sig = signal_hints.get("signalized")
      if sig is not None and len(sig):
        d_sig = float(np.linalg.norm(sig - node_world[j], axis=1).min())
      unsig = signal_hints.get("unsignalized")
      if unsig is not None and len(unsig):
        d_unsig = float(np.linalg.norm(unsig - node_world[j],
                                       axis=1).min())
      if min(d_sig, d_unsig) < r_hint:
        signalized = d_sig <= d_unsig
    if signalized:
      for li in inc:
        pe = lane_polys[li][-1]
        ye = float(_poly_yaw(lane_polys[li])[-1])
        grp = int(abs(np.sin(ye)) > abs(np.cos(ye)))     # EW=0 / NS=1
        offset = 0.0 if grp == 0 else (LIGHT_GREEN_S + LIGHT_YELLOW_S +
                                       LIGHT_ALL_RED_S)
        lights.append((pe, ye, np.array([1.5, LANE_W / 2 * 0.9]), offset))
    else:
      # stop signs on the minor entries of the T (approaches most
      # perpendicular to the through pair)
      through = None
      for a in range(len(dirs)):
        for b in range(a + 1, len(dirs)):
          d = abs(np.arctan2(np.sin(dirs[a] - dirs[b]),
                             np.cos(dirs[a] - dirs[b])))
          if d > 2.6:
            through = (dirs[a], dirs[b])
      for li in inc:
        ye = float(_poly_yaw(lane_polys[li])[-1])
        is_minor = through is None or all(
            abs(np.arctan2(np.sin(ye - t), np.cos(ye - t))) > 0.5
            for t in through)
        if is_minor:
          pe = lane_polys[li][-1]
          stops.append((pe, ye, np.array([2.0, LANE_W / 2])))

  # --- lane-direction raster channel (built at ds res, upsampled) ---
  dir_ds = rasterize_direction(lane_polys, ds, pixel_m, world_offset)
  direction = np.zeros((H, W), np.uint8)
  up = np.repeat(np.repeat(dir_ds, f, 0), f, 1)
  direction[:up.shape[0], :up.shape[1]] = up[:H, :W]
  direction[~road] = 0

  def pack(rows, n_cols):
    if rows:
      return [np.asarray(x, np.float32) for x in zip(*rows)]
    return [np.zeros((0,) + s, np.float32)
            for s in [(2,), (), (2,), ()][:n_cols]]

  if lights:
    lp, ly, le, lo_ = pack(lights, 4)
  else:
    lp = np.zeros((0, 2), np.float32)
    ly = lo_ = np.zeros((0,), np.float32)
    le = np.zeros((0, 2), np.float32)
  if stops:
    sp, sy, se = pack(stops, 3)
  else:
    sp = np.zeros((0, 2), np.float32)
    sy = np.zeros((0,), np.float32)
    se = np.zeros((0, 2), np.float32)
  L = len(lp)
  return TownLanes(
      lane_polys=lane_polys, lane_successors=lane_succ,
      lane_halfwidth=np.asarray(lane_half, np.float32),
      is_connector=np.asarray(lane_conn, bool),
      junction_centers=(np.asarray(junction_centers, np.float32).reshape(
          -1, 2)),
      junction_radius=np.asarray(junction_radius, np.float32),
      light_pos=lp.reshape(L, 2), light_yaw=ly,
      light_extent=le.reshape(L, 2), light_offset_s=lo_,
      light_green_s=np.full((L,), LIGHT_GREEN_S, np.float32),
      light_yellow_s=np.full((L,), LIGHT_YELLOW_S, np.float32),
      light_red_s=np.full((L,), cycle - LIGHT_GREEN_S - LIGHT_YELLOW_S,
                          np.float32),
      stop_pos=sp.reshape(-1, 2), stop_yaw=sy, stop_extent=se.reshape(-1, 2),
      direction_raster=direction)


def rasterize_direction(lane_polys: list, road: np.ndarray,
                        pixel_m: float,
                        world_offset: np.ndarray) -> np.ndarray:
  """[H,W] uint8 lane-direction channel: 0 = none, 1..DIR_BINS = yaw bin.

  Lanes are stamped as sampled seeds, then nearest-seed propagated over
  all road pixels (EDT indices). Two-way corridors stamp both directions;
  the nearest lane wins, so each half of the road carries its own
  direction — exactly what the wrong-way criterion needs. Works at
  whatever resolution `road` is given in (pixel_m meters per pixel)."""
  H, W = road.shape
  seeds = np.zeros((H, W), np.uint8)
  for poly in lane_polys:
    if len(poly) < 2:
      continue
    seg = np.linalg.norm(np.diff(poly, axis=0), axis=-1)
    arc = np.concatenate([[0.0], np.cumsum(seg)])
    total = arc[-1]
    if total < pixel_m:
      continue
    t = np.arange(0.0, total, 0.5 * pixel_m)
    xs = np.interp(t, arc, poly[:, 0])
    ys = np.interp(t, arc, poly[:, 1])
    yaw = np.arctan2(np.gradient(ys), np.gradient(xs))
    bins = (np.round(yaw / (2 * np.pi / DIR_BINS)).astype(int)
            % DIR_BINS) + 1
    px = np.clip(np.round((xs - world_offset[0]) / pixel_m).astype(int),
                 0, W - 1)
    py = np.clip(np.round((ys - world_offset[1]) / pixel_m).astype(int),
                 0, H - 1)
    seeds[py, px] = bins
  if not seeds.any():
    return seeds
  _, (iy, ix) = ndimage.distance_transform_edt(seeds == 0,
                                               return_indices=True)
  out = seeds[iy, ix]
  out[~road] = 0
  return out


def bin_to_yaw(bins: np.ndarray) -> np.ndarray:
  """Inverse of the direction-bin quantization (bins 1..DIR_BINS)."""
  return (bins - 1) * (2 * np.pi / DIR_BINS)
