"""Port parity: the CARLA benchmark runner on imported towns
(carla_garage_tpu_torch/eval/benchmark.py ``run_carla_benchmark``), its
analysis artifacts, the ``run_benchmarks`` entry point and the training
scripts' handling of imported towns, against the JAX package on the CPU.

The asset root is ``test_torch_port_importer.write_asset_root``'s (two
small grid towns, 3 + 2 Longest6 routes). Both runners are cut to one
chunk of TICKS ticks: JAX's ``rollout_chunked`` (and its recorded twin)
is patched to its real self with chunk TICKS, and the port's to a plain
rollout of the same ticks that replays JAX's draws (a tick splits
``state.rng`` three ways, episode.py:51: the policy's key, whose draws are
the expert's steer noise or the sensor agent's GNSS, compass and LiDAR
noise, and the scenario engine's control-loss noise; PlanT draws
nothing). Records agree with JAX's in route ids, towns, indices, status,
infraction counts and event kinds and ticks; scores within 1e-3 (they are
percentages), event positions within 1e-3 m, route lengths within 1e-5
relative. Cases: per town with the expert (and ``analysis_dir``: the same
file names as JAX's ``write_analysis``), one mixed-town batch with the
expert, per town with the micro sensor policy and its agent state, one
mixed-town batch with the micro PlanT.
"""

import csv
import dataclasses
import functools
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from carla_garage_tpu.agents import plant_agent as j_pa
from carla_garage_tpu.agents import sensor_agent as j_agent
from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG
from carla_garage_tpu.eval import benchmark as j_bench
from carla_garage_tpu.maps import importer as j_imp
from carla_garage_tpu.models import plant as j_plant
from carla_garage_tpu.models import transfuser as jtf
from carla_garage_tpu.sim import episode as j_episode
from carla_garage_tpu.sim import scene_builder as j_sb
from carla_garage_tpu_torch.agents.plant_agent import (make_plant_policy,
                                                       plant_agent_reset)
from carla_garage_tpu_torch.agents.sensor_agent import (make_transfuser_policy,
                                                        sensor_agent_reset)
from carla_garage_tpu_torch.config import DEFAULT_CONFIG
from carla_garage_tpu_torch.convert import load_flax_params
from carla_garage_tpu_torch.eval import benchmark
from carla_garage_tpu_torch.maps import importer
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.models.plant import PlanT
from carla_garage_tpu_torch.scripts import run_benchmarks as rb
from carla_garage_tpu_torch.scripts import train_plant as tp
from carla_garage_tpu_torch.scripts import train_transfuser as tf
from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
from carla_garage_tpu_torch.sim import episode, scene_builder
from carla_garage_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_port_eval import _random_params
from test_torch_port_importer import write_asset_root
from test_torch_port_scenarios import _compare_batches
from test_torch_port_scene import clear_jax_town_caches
from test_torch_port_tick import _tick_config

V, TICKS = 16, 24
T = lambda a: torch.from_numpy(np.array(a))
JC = JCFG.replace(sim=dataclasses.replace(JCFG.sim, max_vehicles=V))
CFG = DEFAULT_CONFIG.replace(sim=dataclasses.replace(DEFAULT_CONFIG.sim,
                                                     max_vehicles=V))
RUN = dict(benchmark="longest6", n_vehicles=6, n_walkers=2,
           max_ticks=TICKS, seed=3, verbose=False)
JAX_META_KEYS = {"benchmark", "reps", "n_vehicles", "n_walkers", "capacity",
                 "seed", "scenarios", "single_batch", "towns", "wall_s",
                 "cmdline"}


@pytest.fixture(autouse=True)
def _fresh_jax_town_caches():
  clear_jax_town_caches()


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
  base = tmp_path_factory.mktemp("assets")
  r = str(base / "reference")
  write_asset_root(r)
  mp = pytest.MonkeyPatch()
  mp.setenv("CGT_TOWN_CACHE", str(base / "town_cache"))
  yield r
  mp.undo()


def expert_draws(rng, B, K, n_lidar=None):
  rng, r_step, r_scn = jax.random.split(rng, 3)
  return rng, {"steer_noise": T(jax.random.normal(r_step, (B,))),
               "control_loss": T(jax.random.normal(r_scn, (B, K)))}


def sensor_draws(rng, B, K, n_lidar):
  rng, r_step, r_scn = jax.random.split(rng, 3)
  r_gps, r_cmp, r_lid = jax.random.split(r_step, 3)
  return rng, {"gps": T(jax.random.normal(r_gps, (B, 2))),
               "compass": T(jax.random.normal(r_cmp, (B,))),
               "lidar": T(jax.random.uniform(r_lid, (B, n_lidar))),
               "control_loss": T(jax.random.normal(r_scn, (B, K)))}


def plant_draws(rng, B, K, n_lidar=None):
  rng, _, r_scn = jax.random.split(rng, 3)
  return rng, {"control_loss": T(jax.random.normal(r_scn, (B, K)))}


def _cut_to_one_chunk(monkeypatch, draw_fn, seed, n_lidar=None):
  """Both runners cut to TICKS ticks; the port's ticks replay JAX's draws
  from the state key JAX's scene builder gives (``jax.random.key(seed)``)."""
  real = j_episode.rollout_chunked
  monkeypatch.setattr(
      j_bench, "rollout_chunked",
      lambda *a, chunk=None, **kw: real(*a, chunk=TICKS, **kw))
  monkeypatch.setattr(
      j_bench, "_rollout_chunked_recorded",
      functools.partial(j_bench._rollout_chunked_recorded, chunk=TICKS))

  def draws_for(scene, state):
    B, K = state.tick.shape[0], scene.scenarios.kind.shape[1]
    rng, out = jax.random.key(seed), []
    for _ in range(TICKS):
      rng, d = draw_fn(rng, B, K, n_lidar)
      out.append(d)
    return out

  def replayed(cfg, maps, lanes, scene, state, max_ticks, chunk, policy,
               generator):
    assert (max_ticks, chunk) == (TICKS, benchmark.CARLA_CHUNK)
    return episode.rollout(cfg, maps, lanes, scene, state, TICKS, policy,
                           draws=draws_for(scene, state))

  def replayed_recorded(cfg, maps, lanes, scene, state, max_ticks, policy,
                        generator):
    st, traj = episode.rollout_recorded(cfg, maps, lanes, scene, state,
                                        TICKS, every=10, policy=policy,
                                        draws=draws_for(scene, state))
    return st, {k: v.numpy() for k, v in traj.items()}

  monkeypatch.setattr(benchmark, "rollout_chunked", replayed)
  monkeypatch.setattr(benchmark, "_rollout_chunked_recorded",
                      replayed_recorded)


def compare_records(recs, j_recs, g, j_g):
  assert [r["route_id"] for r in recs] == [r["route_id"] for r in j_recs]
  assert len(recs) > 0
  for t, j in zip(recs, j_recs):
    assert list(t) == list(j)
    for k in ("route_id", "town", "index", "status", "infractions"):
      assert t[k] == j[k], (k, t[k], j[k])
    assert [(e["kind"], e["tick"]) for e in t["events"]] == \
        [(e["kind"], e["tick"]) for e in j["events"]]
    for a, b in zip(t["events"], j["events"]):
      np.testing.assert_allclose(a["pos"], b["pos"], atol=1e-3)
    assert list(t["scores"]) == list(j["scores"])
    for k, v in j["scores"].items():
      assert abs(t["scores"][k] - v) <= 1e-3, (k, t["scores"][k], v)
    np.testing.assert_allclose(t["meta"]["route_length"],
                               j["meta"]["route_length"], rtol=1e-5)
    assert t["meta"]["duration_game"] == j["meta"]["duration_game"]
  assert list(g) == list(j_g)
  for k, v in j_g.items():
    assert abs(g[k] - v) <= 1e-3 * max(abs(v), 1.0), (k, g[k], v)


def test_per_town_expert_with_analysis_matches_jax(root, monkeypatch,
                                                   tmp_path):
  _cut_to_one_chunk(monkeypatch, expert_draws, RUN["seed"])
  j_dir, t_dir = tmp_path / "j", tmp_path / "t"
  j_recs, j_g = j_bench.run_carla_benchmark(
      JC, assets_root=root, analysis_dir=str(j_dir), **RUN)
  recs, g = benchmark.run_carla_benchmark(
      CFG, assets_root=root, analysis_dir=str(t_dir), device="cpu", **RUN)
  compare_records(recs, j_recs, g, j_g)
  assert {r["town"] for r in recs} == {"Town01", "Town02"}
  assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir))
  assert "infractions_Town01.png" in os.listdir(t_dir)


def test_single_batch_expert_over_two_towns_matches_jax(root, monkeypatch):
  _cut_to_one_chunk(monkeypatch, expert_draws, RUN["seed"])
  j_recs, j_g = j_bench.run_carla_benchmark(JC, assets_root=root,
                                            single_batch=True, **RUN)
  recs, g = benchmark.run_carla_benchmark(CFG, assets_root=root,
                                          single_batch=True, device="cpu",
                                          **RUN)
  compare_records(recs, j_recs, g, j_g)
  assert [r["town"] for r in recs] == ["Town01"] * 3 + ["Town02"] * 2
  # each record is its own episode's slice of the mixed batch
  assert [r["index"] for r in recs] == [0] * 5


def test_per_town_sensor_agent_matches_jax(root, monkeypatch):
  c = _tick_config()
  cam = camera_ray_grid(CFG, scale=8)
  lid_f = lidar_ray_grid(CFG, half=0, decimate=16)
  lid_r = lidar_ray_grid(CFG, half=1, decimate=16)
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  jm = jtf.LidarCenterNet(c)
  zeros = [np.zeros(x, np.float32) for x in
           ((2, c.img_h, c.img_w, 3), (2, c.lidar_h, c.lidar_w, 2), (2, 2),
            (2, 6), (2,))]
  params = _random_params(jax.eval_shape(jm.init, jax.random.key(0),
                                         *zeros), seed=7)
  _cut_to_one_chunk(monkeypatch, sensor_draws, RUN["seed"], n_lidar)
  j_policy = j_agent.make_transfuser_policy(jm, None, c, cam, lid_f, lid_r,
                                            direct=True,
                                            brake_threshold=0.33)
  j_recs, j_g = j_bench.run_carla_benchmark(
      JC, assets_root=root, towns=["Town01"], policy=j_policy,
      policy_params=params,
      agent_reset=lambda cfg, B: j_agent.sensor_agent_reset(cfg, B, n_lidar),
      **RUN)
  model = load_flax_params(ttf.LidarCenterNet(ttf.TransfuserConfig(
      **dataclasses.asdict(c))), jax.tree.map(np.asarray, params))
  policy = make_transfuser_policy(model, None, c, cam, lid_f, lid_r,
                                  direct=True, brake_threshold=0.33)
  recs, g = benchmark.run_carla_benchmark(
      CFG, assets_root=root, towns=["Town01"], policy=policy,
      agent_reset=lambda cfg, B, device: sensor_agent_reset(
          cfg, B, n_lidar, device=device), device="cpu", **RUN)
  compare_records(recs, j_recs, g, j_g)
  assert len(recs) == 3


@pytest.fixture(scope="module")
def micro_plant():
  pcfg = j_plant.micro_plant()
  jm = j_plant.PlanT(pcfg)
  O, R = pcfg.max_objects, pcfg.num_route_points
  x = (np.zeros((1, O, 7), np.float32), np.zeros((1, O), np.int32),
       np.zeros((1, R, 2), np.float32)) + (np.zeros(1, np.float32),) * 4
  params = _random_params(jax.eval_shape(jm.init, jax.random.key(0), *x),
                          seed=4)
  tm = load_flax_params(PlanT(pcfg), jax.tree.map(np.asarray, params))
  return pcfg, jm, params, tm


def test_single_batch_plant_matches_jax(root, monkeypatch, micro_plant):
  pcfg, jm, params, tm = micro_plant
  _cut_to_one_chunk(monkeypatch, plant_draws, RUN["seed"])
  j_policy = j_pa.make_plant_policy(jm, None, pcfg, direct=True,
                                    brake_threshold=0.33)
  j_recs, j_g = j_bench.run_carla_benchmark(
      JC, assets_root=root, single_batch=True, policy=j_policy,
      policy_params=params, agent_reset=j_pa.plant_agent_reset, **RUN)
  policy = make_plant_policy(tm, None, pcfg, direct=True,
                             brake_threshold=0.33)
  recs, g = benchmark.run_carla_benchmark(
      CFG, assets_root=root, single_batch=True, policy=policy,
      agent_reset=plant_agent_reset, device="cpu", **RUN)
  compare_records(recs, j_recs, g, j_g)


# ---- the run_benchmarks entry point ----

def _save_micro_checkpoints(path, micro_plant):
  c = _tick_config()
  with torch.random.fork_rng():
    torch.manual_seed(0)
    tmodel = ttf.LidarCenterNet(ttf.TransfuserConfig(
        **dataclasses.asdict(c)))
  save_checkpoint(str(path / "tf"), tmodel,
                  meta={"model": "transfuser",
                        "config": dataclasses.asdict(c)})
  pcfg, _, _, tm = micro_plant
  save_checkpoint(str(path / "plant"), tm,
                  meta={"model": "plant", "config": dataclasses.asdict(pcfg)})


@pytest.mark.parametrize("agent,extra", [
    ("expert", ["--single-batch", "--honest"]),
    ("transfuser", ["--towns", "Town01", "--jpeg-quality", "90"]),
    ("plant", ["--benchmarks", "longest6", "lav"])])
def test_run_benchmarks_writes_jax_layout(root, monkeypatch, tmp_path,
                                          micro_plant, agent, extra):
  """run(args) end to end at one chunk of 4 ticks: the endpoint JSON with
  JAX's meta keys, and a CSV of the same records that reads back."""
  monkeypatch.setattr(benchmark, "CARLA_CHUNK", 4)
  _save_micro_checkpoints(tmp_path, micro_plant)
  ck = {"transfuser": ["--checkpoint", str(tmp_path / "tf")],
        "plant": ["--checkpoint", str(tmp_path / "plant")]}.get(agent, [])
  args = rb.parse_args(["--agent", agent, "--max-ticks", "4",
                        "--n-vehicles", "4", "--results-dir",
                        str(tmp_path / "out")] + ck + extra)
  if "--benchmarks" not in extra:
    args.benchmarks = ["longest6"]
  out = rb.run(args, device="cpu", assets_root=root)
  assert sorted(out) == sorted(args.benchmarks)
  for bench, res in out.items():
    data = json.loads(open(res["json"]).read())
    keys = JAX_META_KEYS | ({"checkpoint", "uncertainty_threshold",
                             "jpeg_quality"} if agent != "expert" else set())
    assert set(data["meta"]) == keys and data["meta"]["benchmark"] == bench
    recs = data["_checkpoint"]["records"]
    assert [r["route_id"] for r in recs] == \
        [r["route_id"] for r in res["records"]]
    assert all(r["meta"]["duration_game"] == 0.2 for r in recs)
    with open(res["csv"]) as f:
      rows = list(csv.reader(f))
    assert rows[0][:6] == ["route_id", "town", "status", "DS", "RC", "IS"]
    assert [r[0] for r in rows[1:]] == [r["route_id"] for r in recs]
    assert benchmark.load_completed(res["json"]) == {
        r["route_id"] for r in recs if r["status"].startswith("Completed")}
  name = os.path.basename(out["longest6"]["json"])
  assert name == {"expert": "longest6_expert_r1_honest_v4_sb.json",
                  "transfuser": "longest6_transfuser_r1_v4.json",
                  "plant": "longest6_plant_r1_v4.json"}[agent]
  if agent == "transfuser":
    assert data["meta"]["jpeg_quality"] == 90


def test_run_benchmarks_absent_root_writes_nothing(tmp_path):
  args = rb.parse_args(["--results-dir", str(tmp_path / "out"),
                        "--assets-root", str(tmp_path / "absent")])
  with pytest.raises(FileNotFoundError):
    rb.run(args, device="cpu")
  assert os.listdir(tmp_path / "out") == []


# ---- the training scripts on imported towns ----

class Stop(Exception):
  pass


def test_train_transfuser_pads_to_the_h5_road_shapes(root, monkeypatch,
                                                     tmp_path):
  """JAX's town_hw rule (scripts/train_transfuser.py:426-445): an
  imported town's raster is its h5 road layer's shape, 'synth*' is
  1680 x 1680, and the run pads every town to the largest of each."""
  import h5py
  shapes = {}
  for name in ("Town01", "Town02"):
    with h5py.File(os.path.join(root, j_imp.MAPS_DIR, f"{name}.h5")) as f:
      shapes[name] = tuple(f["road"].shape)
    assert tf.town_hw(name, root) == shapes[name]
  assert shapes == {"Town01": (600, 600), "Town02": (600, 360)}
  assert tf.town_hw("synth3") == (1680, 1680)
  seen = []

  def capture(cfg, args, pad_hw, crop_hw, dev):
    seen.append((pad_hw, crop_hw))
    raise Stop

  monkeypatch.setattr(tf, "load_datasets", capture)
  for towns, want in ((["Town01", "synth"], (1680, 1680)),
                      (["Town02"], (600, 600))):
    args = tf.parse_args(["--towns", *towns, "--eval-towns", "Town01",
                          "--crop-px", "0", "--assets-root", root,
                          "--out", str(tmp_path / "ck"), "--micro"])
    with pytest.raises(Stop):
      tf.run(args, device="cpu")
    assert seen[-1] == (want, None)


def test_train_plant_datagen_shard_on_an_imported_town(root, monkeypatch):
  """tp.datagen_shard on 'Town01' (10 frames = 50 ticks in chunks of 5
  frames; the first 2 frames have waypoint labels): the scene it collects
  on is JAX's make_town_batch of that imported town bit for bit, and its
  dataset holds samples."""
  args = types.SimpleNamespace(episodes=2, n_vehicles=6, n_walkers=2,
                               min_route_m=90.0, max_route_m=200.0,
                               frames=10, assets_root=root)
  monkeypatch.setattr(tp, "CHUNK", 5)
  seen = {}
  real = tp.build_plant_dataset

  def record(c, p, frames, scene):
    seen["scene"] = scene
    return real(c, p, frames, scene)

  monkeypatch.setattr(tp, "build_plant_dataset", record)
  cfg = tp.honest_cfg(V)
  ds, n_clean = tp.datagen_shard(cfg, tp.plant_config(), args, "Town01",
                                 seed=5, device="cpu")
  j = j_sb.make_town_batch(JC, "Town01", batch=2, seed=5, n_vehicles=6,
                           n_walkers=2, use_scenarios=True, min_route_m=90.0,
                           max_route_m=200.0, assets_root=root)
  t = scene_builder.make_town_batch(cfg, "Town01", batch=2, seed=5,
                                    n_vehicles=6, n_walkers=2,
                                    use_scenarios=True, min_route_m=90.0,
                                    max_route_m=200.0, assets_root=root,
                                    device="cpu")
  _compare_batches(j[1:], t[1:], expect_scenarios=True)
  assert torch.equal(seen["scene"].route.points, t[3].route.points)
  assert len(ds) > 0 and 0 <= n_clean <= 2
