"""Port parity: the CARLA town importer (carla_garage_tpu_torch/maps/
importer.py) and ``make_town_batch`` on imported towns, against the JAX
package on the CPU.

``write_asset_root`` writes a small asset root in the reference's layout:
two towns in the h5 layer layout (``Town01``: the procedural grid at
3 x 3 streets, 600 x 600 px at 4 px/m, its center marking a yellow
two-way marking; ``Town02``: a 2 x 3 grid without yellow, shifted by a
world offset), a ``longest6.xml`` and a ``lav.xml`` of routes sampled on
the grids' own lanes, and scenario annotations (Scenario1/3/4 along the
lanes; Scenario7/8/10 at Town01's junctions; a Town02 file listing one
site set under every type, the degenerate case). Both packages' town
caches (``CGT_TOWN_CACHE``) point into the test's temporary directory.

- ``load_town`` equals JAX's in every ``ImportedTown`` field, fresh and
  again through the port's disk cache; the port never reads a pickle the
  JAX package wrote (a fresh process loads no ``carla_garage_tpu``
  module and writes a file of its own name).
- ``parse_routes_xml``, ``load_benchmark_routes``, ``load_scenarios`` and
  ``signal_hints_for`` equal JAX's; a missing asset root raises OSError
  in both; no root given and none in $CGT_ASSETS_ROOT raises
  FileNotFoundError.
- ``make_town_batch`` on an imported town is bit-equal to JAX's: plain,
  padded, route-cropped and with annotated scenarios. One town name from
  two asset roots gives two towns, also on the device.
- ``grid_town_arrays`` (the h5 layers of the grid town) equals
  ``make_town``'s channels, and ``make_town`` equals JAX's.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG
from carla_garage_tpu.maps import importer as j_imp
from carla_garage_tpu.maps import synthetic as j_syn
from carla_garage_tpu.sim import scene_builder as j_sb
from carla_garage_tpu_torch.config import DEFAULT_CONFIG
from carla_garage_tpu_torch.maps import importer, routing
from carla_garage_tpu_torch.maps.synthetic import make_town
from carla_garage_tpu_torch.maps.town_map import LaneGraph
from carla_garage_tpu_torch.sim import scene_builder
from carla_garage_tpu_torch.sim.scenarios import ScenarioType as ST
from test_torch_port_scenarios import _compare_batches
from test_torch_port_scene import clear_jax_town_caches

V = 16
JC = JCFG.replace(sim=dataclasses.replace(JCFG.sim, max_vehicles=V))
CFG = DEFAULT_CONFIG.replace(sim=dataclasses.replace(DEFAULT_CONFIG.sim,
                                                     max_vehicles=V))
TOWNS = {"Town01": dict(n_x=3, n_y=3, yellow=True, offset=(0.0, 0.0)),
         "Town02": dict(n_x=2, n_y=3, yellow=False, offset=(-50.0, -20.0))}


@pytest.fixture(autouse=True)
def _fresh_jax_town_caches():
  clear_jax_town_caches()


def grid_town_arrays(n_x, n_y, yellow, offset, block=60.0, margin=15.0):
  """(h5 layers, ppm, world_offset, grid town) of a procedural grid town
  whose world is shifted by `offset`: the town's lanes, shifted, are
  lanes of the h5 town."""
  t = make_town(n_x=n_x, n_y=n_y, block=block, margin=margin)
  arrays = importer.grid_town_arrays(n_x=n_x, n_y=n_y, block=block,
                                     margin=margin, yellow=yellow)
  off = np.asarray(offset, np.float32)
  shifted = dataclasses.replace(
      t, lane_polys=[p + off for p in t.lane_polys])
  return arrays, t.ppm, off, shifted


def sample_routes(town, n, seed, min_m=90.0, max_m=200.0):
  """n lane-graph routes (keypoints xy, yaw) whose goal lies 40 m or more
  from their start."""
  rng = np.random.default_rng(seed)
  out = []
  while len(out) < n:
    res = routing.sample_lane_route(town.lane_polys, town.lane_successors,
                                    rng, min_len_m=min_m, max_len_m=max_m)
    if res is not None and np.linalg.norm(res[0][-1] - res[0][0]) > 40.0:
      out.append(res)
  return out


def write_asset_root(root, towns=TOWNS, n_routes=(3, 2), h5=True) -> dict:
  """Write the asset root (see the module docstring). Returns {town:
  (arrays, ppm, world_offset)}. h5=False leaves the town files out."""
  layers, l6, lav, public = {}, [], [], {}
  for ti, (name, spec) in enumerate(towns.items()):
    arrays, ppm, off, town = grid_town_arrays(**spec)
    layers[name] = (arrays, ppm, off)
    if h5:
      importer.write_town_h5(root, name, arrays, ppm, off)
    routes = sample_routes(town, n_routes[ti] + 1, seed=ti)
    for k, (xy, yaw) in enumerate(routes[:-1]):
      l6.append((f"{ti * 10 + k}", name, xy, yaw))
    lav.append((f"{ti * 10 + 9}", name, *routes[-1]))
    # Scenario1/3/4 sites every 8 m or so along every third lane each,
    # facing the lane's travel direction: random routes meet them too
    public[name] = {k: [(float(x), float(y), float(np.degrees(np.arctan2(
        *(p[-1] - p[0])[::-1])))) for p in town.lane_polys[i::3]
        for x, y in p[1:-1:2]]
        for i, k in enumerate(("Scenario1", "Scenario3", "Scenario4"))}
  data = os.path.join(root, importer.ROUTES_DIR)
  importer.write_routes_xml(os.path.join(data, "longest6.xml"), l6)
  importer.write_routes_xml(os.path.join(data, "lav.xml"), lav)
  scen = os.path.join(data, "scenarios")
  importer.write_scenarios_json(
      os.path.join(scen, "all_towns_traffic_scenarios_public.json"), public)
  # Town01: signalized approaches at two junctions, an unsignalized one
  importer.write_scenarios_json(
      os.path.join(scen, "town01_all_scenarios.json"),
      {"Town01": {"Scenario7": [(60.0, 26.0, 90.0), (60.0, 26.0, 90.0)],
                  "Scenario8": [(129.0, 73.25, 180.0)],
                  "Scenario10": [(15.0 + 1.75, 120.0, -90.0)]}})
  # Town02: one blanket site list under every type (no information)
  sites = [(-50.0 + 15.0, -20.0 + 30.0, 90.0),
           (-50.0 + 75.0, -20.0 + 90.0, 0.0)]
  importer.write_scenarios_json(
      os.path.join(scen, "town02_all_scenarios.json"),
      {"Town02": {k: sites for k in ("Scenario7", "Scenario8", "Scenario9",
                                     "Scenario10")}})
  return layers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core): a torch
  thread pool of its own per process would oversubscribe the cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
  """The asset root, with both packages' town caches in a directory of
  the test's own."""
  base = tmp_path_factory.mktemp("assets")
  r = str(base / "reference")
  write_asset_root(r)
  mp = pytest.MonkeyPatch()
  mp.setenv("CGT_TOWN_CACHE", str(base / "town_cache"))
  yield r
  mp.undo()


def _town_fields_equal(t, j):
  for f in dataclasses.fields(j_imp.ImportedTown):
    a, b = getattr(t, f.name), getattr(j, f.name)
    if f.name == "lane_polys":
      assert len(a) == len(b) > 0
      for i, (p, q) in enumerate(zip(a, b)):
        assert p.dtype == q.dtype
        np.testing.assert_array_equal(p, q, err_msg=f"lane {i}")
    elif f.name in ("name", "ppm", "lane_successors"):
      assert a == b and type(a) is type(b), f.name
    else:
      a, b = np.asarray(a), np.asarray(b)
      assert a.dtype == b.dtype and a.shape == b.shape, f.name
      np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("name", sorted(TOWNS))
def test_load_town_matches_jax_fresh_and_cached(root, name):
  j = j_imp.load_town(name, root)
  t = importer.load_town(name, root)
  assert type(t) is importer.ImportedTown
  _town_fields_equal(t, j)
  assert len(t.light_pos) and t.raster.shape == (9, 600, 600 if
                                                 name == "Town01" else 360)
  # a second process's load: the in-process memo dropped, the port's own
  # disk file read back
  disk = importer.town_cache_path(name, root)
  assert os.path.exists(disk) and "_torch_" in os.path.basename(disk)
  importer._TOWN_CACHE.clear()
  _town_fields_equal(importer.load_town(name, root), j)


def test_port_never_loads_a_jax_pickle(root, tmp_path):
  """Only a JAX-written town in the cache directory: a fresh process
  loads the town through the port, imports no module of the JAX package
  and writes a cache file of its own name beside JAX's."""
  cache = tmp_path / "cache"
  env = dict(os.environ, CGT_TOWN_CACHE=str(cache))
  mp = pytest.MonkeyPatch()
  mp.setenv("CGT_TOWN_CACHE", str(cache))
  j_imp._TOWN_CACHE.clear()
  j_imp.load_town("Town02", root)
  mp.undo()
  j_file, = os.listdir(cache)
  code = (
      "import sys, pickle\n"
      "from carla_garage_tpu_torch.maps import importer\n"
      f"t = importer.load_town('Town02', {root!r})\n"
      "assert type(t) is importer.ImportedTown, type(t)\n"
      "bad = [m for m in sys.modules if m.split('.')[0] == "
      "'carla_garage_tpu']\n"
      "assert not bad, bad\n"
      "print(importer.town_cache_path('Town02', "
      f"{root!r}))\n")
  out = subprocess.run([sys.executable, "-c", code], env=env, cwd=os.path.
                       dirname(os.path.dirname(os.path.abspath(__file__))),
                       capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr
  t_file = os.path.basename(out.stdout.strip())
  assert sorted(os.listdir(cache)) == sorted([j_file, t_file])
  with open(cache / t_file, "rb") as f:
    raw = f.read()
  assert b"carla_garage_tpu_torch.maps.importer" in raw
  assert b"carla_garage_tpu.maps" not in raw
  assert isinstance(pickle.loads(raw), importer.ImportedTown)


def test_routes_scenarios_and_hints_match_jax(root):
  for bench in ("longest6", "lav"):
    j = j_imp.load_benchmark_routes(bench, root)
    t = importer.load_benchmark_routes(bench, root)
    assert len(t) == len(j) > 0
    for a, b in zip(t, j):
      assert (a.route_id, a.town) == (b.route_id, b.town)
      for f in ("keypoints_xy", "keypoints_yaw"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
  path = os.path.join(root, importer.ROUTES_DIR, "longest6.xml")
  assert [r.route_id for r in importer.parse_routes_xml(path)] == \
      [r.route_id for r in j_imp.parse_routes_xml(path)]
  for town in ("Town01", "Town02", "Town07"):
    j, t = j_imp.load_scenarios(town, root), importer.load_scenarios(town,
                                                                     root)
    assert sorted(t) == sorted(j)
    for k in j:
      assert t[k].dtype == j[k].dtype
      np.testing.assert_array_equal(t[k], j[k])
    jh, th = j_imp.signal_hints_for(town, root), \
        importer.signal_hints_for(town, root)
    assert (jh is None) == (th is None)
    if jh is not None:
      assert sorted(th) == sorted(jh)
      for k in jh:
        np.testing.assert_array_equal(th[k], jh[k])
  assert set(importer.load_scenarios("Town01", root)) == {
      "Scenario1", "Scenario3", "Scenario4", "Scenario7", "Scenario8",
      "Scenario10"}
  assert importer.signal_hints_for("Town01", root) is not None
  assert importer.signal_hints_for("Town02", root) is None   # degenerate
  assert importer.signal_hints_for("Town07", root) is None   # none at all


def test_missing_asset_root_raises_like_jax(tmp_path):
  gone = str(tmp_path / "absent")
  for load in (j_imp.load_town, importer.load_town):
    with pytest.raises(OSError):
      load("Town01", gone)
  for load in (j_imp.load_benchmark_routes, importer.load_benchmark_routes):
    with pytest.raises(FileNotFoundError):
      load("longest6", gone)
  with pytest.raises(OSError):
    scene_builder.make_town_batch(CFG, "Town03", assets_root=gone,
                                  device="cpu")


@pytest.mark.parametrize("load", [
    lambda: importer.load_town("Town01"),
    lambda: importer.load_benchmark_routes("longest6"),
    lambda: importer.load_scenarios("Town01"),
    lambda: scene_builder.make_town_batch(CFG, "Town01", device="cpu")],
    ids=["load_town", "routes", "scenarios", "make_town_batch"])
def test_no_asset_root_raises_and_the_environment_names_one(root, load,
                                                            monkeypatch):
  """The root is the argument, else $CGT_ASSETS_ROOT, and nothing else."""
  monkeypatch.delenv("CGT_ASSETS_ROOT", raising=False)
  assert not importer.assets_available()
  with pytest.raises(FileNotFoundError, match="CGT_ASSETS_ROOT"):
    load()
  monkeypatch.setenv("CGT_ASSETS_ROOT", root)
  assert importer.assets_available()
  assert load() is not None


def test_one_town_name_from_two_roots_is_two_towns(root, tmp_path):
  """A second root whose Town01 is another grid: the town, its lanes
  and its device copy come from the root asked for, in either order."""
  other = str(tmp_path / "other")
  write_asset_root(other, towns={"Town01": TOWNS["Town02"]}, n_routes=(2,))
  for r in (root, other, root):
    town, maps, lanes, _, _ = scene_builder.make_town_batch(
        CFG, "Town01", assets_root=r, device="cpu", seed=1, **TOWN_ARGS)
    want = importer.load_town("Town01", r)
    assert town.raster.shape == want.raster.shape
    np.testing.assert_array_equal(maps.layers[0].numpy(), want.raster)
    ref = LaneGraph.from_polylines(want.lane_polys, want.lane_successors,
                                   device="cpu")
    for f in ("points", "num_valid", "successor"):
      assert torch.equal(getattr(lanes, f), getattr(ref, f)), f
  assert importer.load_town("Town01", root).raster.shape != \
      importer.load_town("Town01", other).raster.shape


@pytest.mark.parametrize("spec", [
    dict(n_x=3, n_y=3, block=60.0, margin=15.0),
    dict(n_x=2, n_y=3, block=60.0, margin=15.0, yellow=False),
    dict(n_x=2, n_y=2, block=75.0, margin=20.0, ppm=3.0)])
def test_grid_town_arrays_are_make_towns_channels(spec):
  grid = {k: v for k, v in spec.items() if k != "yellow"}
  t = make_town(**grid)
  j = j_syn.make_town(**grid)
  np.testing.assert_array_equal(t.raster, j.raster)
  a = importer.grid_town_arrays(**spec)
  center = a["lane_marking_yellow_broken"] if spec.get("yellow", True) \
      else a["lane_marking_white_broken"]
  for k, c in (("road", 0), ("sidewalk", 1), ("lane_marking_all", 2)):
    np.testing.assert_array_equal(a[k], t.raster[c], err_msg=k)
  np.testing.assert_array_equal(center, t.raster[3])


TOWN_ARGS = dict(batch=2, n_vehicles=6, n_walkers=2, min_route_m=90.0,
                 max_route_m=200.0)


@pytest.mark.parametrize("kw", [
    dict(seed=1),
    dict(seed=2, pad_hw=(640, 620)),
    dict(seed=3, crop_hw=(480, 480), crop_margin_m=20.0),
    dict(seed=4, use_scenarios=True)],
    ids=["plain", "pad", "crop", "scenarios"])
@pytest.mark.parametrize("town", sorted(TOWNS))
def test_make_town_batch_on_an_imported_town_matches_jax(root, town, kw):
  args = dict(TOWN_ARGS, assets_root=root, **kw)
  j = j_sb.make_town_batch(JC, town, **args)
  t = scene_builder.make_town_batch(CFG, town, device="cpu", **args)
  np.testing.assert_array_equal(t[0].raster, j[0].raster)
  np.testing.assert_array_equal(t[0].world_offset, j[0].world_offset)
  _compare_batches(j[1:], t[1:],
                   expect_scenarios=bool(kw.get("use_scenarios")))
  if kw.get("use_scenarios"):
    specs = t[3].scenarios
    kinds = set(specs.kind[specs.valid].tolist())
    # Scenario1 comes from the annotations only
    assert ST.CONTROL_LOSS in kinds, kinds
