"""Port parity: lane-graph recovery from road rasters
(carla_garage_tpu_torch/maps/lane_graph.py) against the JAX package's
module, bit for bit on the CPU.

Six rasters: the cross road, twin carriageways across a median, a
yellow-marked two-way grid, a T-junction whose narrow stem gets stop
signs, a no-yellow grid oriented by direction hints, and the cross road
under signal hints (signalized and unsignalized). On each: ``skeletonize``
and ``extract_graph`` of the downsampled mask ``build_town_lanes`` thins,
then ``build_town_lanes`` itself: every array equal (values and dtype),
every polyline equal and in the same order, the successor lists ``==``.
The rasters are those of ``tests/test_lane_graph.py``, copied.
"""

import numpy as np
import pytest
from scipy import ndimage

from carla_garage_tpu.maps import lane_graph as j_lg
from carla_garage_tpu_torch.maps import lane_graph as lg
from carla_garage_tpu_torch.maps.synthetic import make_town

OFF = np.zeros(2, np.float32)


def _cross_road(size=200, ppm=2.0, half=4.0):
  """A plus-shaped two-street town raster at ppm px/m."""
  n = int(size * ppm)
  g = np.arange(n) / ppm
  gx, gy = np.meshgrid(g, g)
  cx = cy = size / 2
  return (np.abs(gy - cy) <= half) | (np.abs(gx - cx) <= half)


def _twin(ppm=2.0):
  """Two parallel carriageways across a 13 m median."""
  g = np.arange(int(200 * ppm)) / ppm
  gx, gy = np.meshgrid(g, g)
  return (np.abs(gy - 90) <= 3.5) | (np.abs(gy - 110) <= 3.5)


def _t_junction(ppm=2.0):
  """A wide through road and a narrow stem: stop signs on the stem."""
  g = np.arange(int(200 * ppm)) / ppm
  gx, gy = np.meshgrid(g, g)
  return (np.abs(gy - 100) <= 6.0) | ((np.abs(gx - 100) <= 2.5) & (gy > 100))


def _grid(yellow: bool):
  """The procedural grid town at 3 x 3 streets, 600 x 600 px at 4 px/m;
  its center marking doubles as a yellow two-way marking."""
  t = make_town(n_x=3, n_y=3, block=60.0, margin=15.0)
  road = t.raster[0] > 0
  return road, (t.raster[3] > 0) if yellow else None, t


def _cases():
  road, yel, _ = _grid(True)
  g_road, _, town = _grid(False)
  # route keypoints against the grid's own lane directions: orient the
  # no-yellow corridors the way the synthetic lanes drive
  hints = np.concatenate([np.concatenate(
      [p[::3], np.arctan2(*np.diff(p, axis=0)[:1].T[::-1])
       .repeat(len(p[::3]))[:, None]], -1) for p in town.lane_polys[:12]])
  hint = np.array([[100.0, 112.0]], np.float32)
  return {
      "cross": (_cross_road(), 2.0, {}),
      "twin": (_twin(), 2.0, {}),
      "yellow_grid": (road, 4.0, dict(yellow=yel)),
      "t_junction": (_t_junction(), 2.0, {}),
      "direction_hints": (g_road, 4.0,
                          dict(direction_hints=hints.astype(np.float32))),
      "signal_unsig": (_cross_road(), 2.0,
                       dict(signal_hints={"unsignalized": hint})),
      "signal_sig": (_cross_road(), 2.0,
                     dict(signal_hints={"signalized": hint})),
  }


CASES = _cases()


def _thinned_input(road, ppm):
  """The closed, downsampled mask build_town_lanes thins (its first
  lines)."""
  f = max(int(round(ppm)), 1)
  H, W = road.shape
  hp, wp = H // f * f, W // f * f
  ds = road[:hp, :wp].reshape(hp // f, f, wp // f, f).max((1, 3))
  return ndimage.binary_closing(ds, structure=np.ones((3, 3)))


def _equal(a, b, what):
  a, b = np.asarray(a), np.asarray(b)
  assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                     a.shape, b.shape)
  np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_skeleton_and_graph_match_jax(name):
  road, ppm, _ = CASES[name]
  ds = _thinned_input(road, ppm)
  sk, j_sk = lg.skeletonize(ds), j_lg.skeletonize(ds)
  _equal(sk, j_sk, "skeleton")
  g, j_g = lg.extract_graph(sk), j_lg.extract_graph(j_sk)
  _equal(g.nodes, j_g.nodes, "nodes")
  assert len(g.edges) == len(j_g.edges) > 0
  for i, ((p, a, b), (jp, ja, jb)) in enumerate(zip(g.edges, j_g.edges)):
    _equal(p, jp, f"edge {i}")
    assert (a, b) == (ja, jb), i


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_town_lanes_matches_jax(name):
  road, ppm, kw = CASES[name]
  off = np.array([-20.0, 35.5], np.float32) if name == "yellow_grid" else OFF
  t = lg.build_town_lanes(road, ppm, off, **kw)
  j = j_lg.build_town_lanes(road, ppm, off, **kw)
  assert len(t.lane_polys) == len(j.lane_polys) > 0
  for i, (p, jp) in enumerate(zip(t.lane_polys, j.lane_polys)):
    _equal(p, jp, f"lane {i}")
  assert t.lane_successors == j.lane_successors
  for f in ("lane_halfwidth", "is_connector", "junction_centers",
            "junction_radius", "light_pos", "light_yaw", "light_extent",
            "light_offset_s", "light_green_s", "light_yellow_s",
            "light_red_s", "stop_pos", "stop_yaw", "stop_extent",
            "direction_raster"):
    _equal(getattr(t, f), getattr(j, f), f)
  # each raster exercises what it was made for
  if name == "t_junction":
    assert len(t.stop_pos) > 0
  if name == "signal_unsig":
    assert len(t.light_pos) == 0
  if name in ("cross", "signal_sig", "yellow_grid"):
    assert len(t.light_pos) >= 4
  assert t.is_connector.any() or name == "twin"
