"""Port parity: the closed-loop evaluation around the tick, torch vs JAX on
the CPU: leaderboard scores and benchmark records, the chunked and
recorded rollouts, DAgger datagen and its JSONL export.

Scores, records and the global record on one final criteria state agree
with JAX's to 1e-5 relative, statuses and counts exactly.
``rollout_recorded``'s snapshots and final state match JAX's to 1e-4,
ints and bools exactly; it and ``rollout_chunked`` are also held against
a plain ``rollout`` of the same ticks from the same generator. DAgger
frames (the micro TransFuser++ driving, the expert labelling, on a
scenario scene) agree with JAX's to slice 1's tick tolerances (1e-4).
Both replay JAX's draws into the port: a tick splits ``state.rng`` three ways
(episode.py:51), the policy's key two ways (datagen.py:124: the expert's
steer noise, then the sensor agent's GNSS, compass and LiDAR draws), and
the scenario key gives the control-loss noise. ``export_frames_jsonl``
writes JAX's bytes from the same frames.
"""

import dataclasses
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carla_garage_tpu.sensors.camera as j_camera
import carla_garage_tpu.sensors.lidar as j_lidar
from carla_garage_tpu.agents import sensor_agent as j_agent
from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG
from carla_garage_tpu.eval import benchmark as j_bench
from carla_garage_tpu.models import transfuser as jtf
from carla_garage_tpu.sensors import raycast as j_rc
from carla_garage_tpu.sim import criteria as j_cr
from carla_garage_tpu.sim import datagen as j_dg
from carla_garage_tpu.sim import episode as j_episode
from carla_garage_tpu.sim import scoring as j_scoring
from carla_garage_tpu.sim.scene_builder import make_town_batch
from carla_garage_tpu_torch.agents.sensor_agent import (make_transfuser_policy,
                                                        sensor_agent_reset)
from carla_garage_tpu_torch.config import DEFAULT_CONFIG
from carla_garage_tpu_torch.convert import load_flax_params
from carla_garage_tpu_torch.eval import benchmark
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
from carla_garage_tpu_torch.sim import datagen, episode, scoring
from carla_garage_tpu_torch.structs import CriteriaState, SimState, tree_items
from test_torch_port_scene import jax_batch_to_port, jax_leaves, to_port
from test_torch_port_tick import _tick_config

B, V = 2, 16
T = lambda a: torch.from_numpy(np.array(a))
JC = JCFG.replace(sim=dataclasses.replace(JCFG.sim, max_vehicles=V))
CFG = DEFAULT_CONFIG.replace(sim=dataclasses.replace(DEFAULT_CONFIG.sim,
                                                     max_vehicles=V))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core): a torch
  thread pool of its own per process would oversubscribe the cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def assert_leaves(want: dict, got: dict, rtol, atol, what=""):
  assert set(want) == set(got), (what, set(want) ^ set(got))
  for key, w in want.items():
    g = np.asarray(got[key])
    assert g.dtype == w.dtype and g.shape == w.shape, (what, key)
    if w.dtype.kind in "biu":
      np.testing.assert_array_equal(g, w, err_msg=f"{what}{key}")
    else:
      np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                 err_msg=f"{what}{key}")


@pytest.fixture(scope="module")
def batch():
  """A JAX-built scenario scene: B=2, 16 vehicle slots, 6 NPCs."""
  _, maps, lanes, scene, state = make_town_batch(
      JC, "synth", batch=B, seed=4, n_vehicles=6, n_walkers=2,
      use_scenarios=True)
  return (maps, lanes, scene, state), jax_batch_to_port(maps, lanes, scene,
                                                        state)


def _final_criteria(n=7):
  """A criteria state as a benchmark ends: one route completed, one
  completed with infractions and off-lane driving, one blocked, timed out,
  deviated, one barely started (driven 0) and one failed plainly, with
  event logs."""
  rng = np.random.default_rng(0)
  cr = j_cr.criteria_reset(n, V, 2, 4, 4)
  E = cr.event_kind.shape[1]
  f32 = lambda a: jnp.asarray(a, jnp.float32)
  i32 = lambda a: jnp.asarray(a, jnp.int32)
  flag = lambda *on: jnp.asarray(np.isin(np.arange(n), on))
  driven = rng.uniform(50, 400, n)
  driven[5] = 0.0
  count = rng.integers(0, 4, n)
  return cr.replace(
      penalty=f32(np.r_[1.0, rng.uniform(0.3, 0.9, n - 1)]),
      route_completion=f32(np.r_[1.0, 0.995, rng.uniform(0, 0.9, n - 2)]),
      driven_m=f32(driven),
      outside_lane_m=f32(driven * np.r_[0, 0.1, rng.uniform(0, .2, n - 2)]),
      n_collision_vehicle=i32(rng.integers(0, 3, n)),
      n_collision_walker=i32(rng.integers(0, 2, n)),
      n_collision_static=i32(rng.integers(0, 2, n)),
      n_red_light=i32(rng.integers(0, 3, n)),
      n_stop_sign=i32(rng.integers(0, 2, n)),
      blocked=flag(2), timed_out=flag(2, 3), deviated=flag(4),
      event_count=i32(count),
      event_kind=i32(rng.integers(1, 6, (n, E))),
      event_tick=i32(rng.integers(0, 4000, (n, E))),
      event_pos=f32(rng.uniform(0, 400, (n, E, 2))))


def test_scores_and_records_match_jax(tmp_path, capsys):
  n = 7
  j_crit = _final_criteria(n)
  rng = np.random.default_rng(1)
  seg = rng.uniform(0.9, 1.1, (n, 600)).astype(np.float32)
  nv = rng.integers(200, 600, n).astype(np.int32)
  tick = rng.integers(100, 5000, n).astype(np.int32)
  ns = types.SimpleNamespace
  j_scene = ns(route=ns(seg_len=jnp.asarray(seg), num_valid=jnp.asarray(nv)))
  t_scene = ns(route=ns(seg_len=T(seg), num_valid=T(nv)))
  t_crit = to_port(j_crit, CriteriaState)
  lens = np.array([seg[i, :nv[i]].sum() for i in range(n)])

  j_sc = j_scoring.compute_scores(JC, j_crit, jnp.asarray(lens))
  t_sc = scoring.compute_scores(CFG, t_crit, T(lens))
  want = {f"/{k}": np.asarray(getattr(j_sc, k)) for k in
          ("score_route", "score_penalty", "score_composed", "completed")}
  want.update({f"/infractions_per_km/{k}": np.asarray(v)
               for k, v in j_sc.infractions_per_km.items()})
  assert_leaves(want, dict(tree_items(t_sc, "")), 1e-5, 0, "scores")
  assert t_sc.completed.tolist() == [True, True] + [False] * (n - 2)
  j_g, t_g = j_scoring.global_stats(j_sc), scoring.global_stats(t_sc)
  assert set(j_g) == set(t_g) and t_g["num_routes"] == j_g["num_routes"]
  for k in ("driving_score", "route_completion", "infraction_score"):
    np.testing.assert_allclose(float(t_g[k]), float(j_g[k]), rtol=1e-5)

  ids = [f"r{i}" for i in range(n - 1)] + [None]      # a padding episode
  j_recs = j_bench._records(JC, j_scene, ns(criteria=j_crit,
                                             tick=jnp.asarray(tick)),
                            ids, "SynthTown")
  t_recs = benchmark._records(CFG, t_scene, ns(criteria=t_crit, tick=T(tick)),
                              ids, "SynthTown")
  assert len(t_recs) == len(j_recs) == n - 1
  statuses = set()
  for j, t in zip(j_recs, t_recs):
    assert json.dumps(sorted(t)) == json.dumps(sorted(j))
    for key in ("route_id", "town", "index", "status", "infractions",
                "events", "meta"):
      assert t[key] == j[key], key
    assert set(t["scores"]) == set(j["scores"])
    for k, v in j["scores"].items():
      np.testing.assert_allclose(t["scores"][k], v, rtol=1e-5, err_msg=k)
    statuses.add(t["status"])
  assert len(statuses) == 5, statuses
  j_agg, t_agg = j_bench.aggregate(j_recs), benchmark.aggregate(t_recs)
  assert list(t_agg) == list(j_agg)
  for k, v in j_agg.items():
    np.testing.assert_allclose(t_agg[k], v, rtol=1e-5, err_msg=k)

  # the output helpers: the endpoint and the CSV read back
  path = tmp_path / "endpoint.json"
  benchmark.write_endpoint(t_recs, t_agg, str(path), meta={"seed": 0})
  back = json.loads(path.read_text())
  assert back["_checkpoint"]["records"] == t_recs
  assert back["values"][0] == t_agg["driving_score"]
  assert benchmark.load_completed(str(path)) == {"r0", "r1"}
  benchmark.write_csv(t_recs, str(tmp_path / "r.csv"))
  j_bench.write_csv(j_recs, str(tmp_path / "j.csv"))
  assert (tmp_path / "r.csv").read_text() == (tmp_path / "j.csv").read_text()
  capsys.readouterr()
  benchmark.print_table(t_recs)
  table = capsys.readouterr().out
  j_bench.print_table(j_recs)
  assert table == capsys.readouterr().out and table.count("\n") == n + 1


def test_chunked_and_recorded_rollouts_match_plain(batch, monkeypatch):
  """10 expert ticks with scenarios: rollout_chunked (chunks of 4, so 12
  ticks) and rollout_recorded (every 5) against plain rollouts from the
  same generator, and the runner's chunked recording against
  rollout_recorded; then a batch whose episodes are all done runs one
  chunk and stays frozen."""
  _, (maps, lanes, scene, state) = batch
  gen = lambda: torch.Generator().manual_seed(7)
  run = functools.partial(episode.rollout, CFG, maps, lanes, scene)
  plain = run(state, 12, generator=gen())
  chunked = episode.rollout_chunked(CFG, maps, lanes, scene, state, 10,
                                    chunk=4, generator=gen())
  for (path, a), (_, b) in zip(tree_items(plain), tree_items(chunked)):
    assert torch.equal(a, b), path
  final, traj = episode.rollout_recorded(CFG, maps, lanes, scene, state, 12,
                                         every=5, generator=gen())
  ten = run(state, 10, generator=gen())
  for (path, a), (_, b) in zip(tree_items(ten), tree_items(final)):
    assert torch.equal(a, b), path
  assert traj["veh_pos"].shape == (2, B, 8, 2)
  # the runner's chunked recording: two chunks of one snapshot each
  c_final, c_traj = benchmark._rollout_chunked_recorded(
      CFG, maps, lanes, scene, state, 10, chunk=5, every=5, generator=gen())
  for (path, a), (_, b) in zip(tree_items(ten), tree_items(c_final)):
    assert torch.equal(a, b), path
  assert set(c_traj) == set(traj)
  for k, v in traj.items():
    np.testing.assert_array_equal(c_traj[k], v.numpy(), err_msg=k)

  calls = []
  real = episode.rollout
  monkeypatch.setattr(episode, "rollout",
                      lambda *a, **kw: calls.append(1) or real(*a, **kw))
  done = ten.replace(done=torch.ones(B, dtype=torch.bool))
  out = episode.rollout_chunked(CFG, maps, lanes, scene, done, 1000,
                                chunk=3, generator=gen())
  assert len(calls) == 1
  for (path, a), (_, b) in zip(tree_items(done), tree_items(out)):
    assert torch.equal(a, b), path


def test_rollout_recorded_matches_jax(batch):
  """JAX's rollout_recorded (10 expert ticks with scenarios, a snapshot
  every 5) against the port's with JAX's draws replayed: each tick splits
  state.rng three ways, the expert's steer noise from the second key, the
  control-loss noise from the third. The snapshots (nearest actors by a
  stable argsort, invalid slots at +inf, 2-D and 3-D gathers) and the
  final state leaf for leaf: ints and bools equal, floats to 1e-4."""
  (j_maps, j_lanes, j_scene, j_state), (maps, lanes, scene, _) = batch
  # every other vehicle slot empty, so that fewer than 8 are valid and the
  # snapshot's last slots are invalid ones at +inf, in slot order
  veh = j_state.vehicles
  j_state = j_state.replace(vehicles=veh.replace(
      valid=veh.valid & (jnp.arange(V) % 2 == 0)))
  state = to_port(j_state, SimState)
  j_final, j_traj = jax.jit(functools.partial(
      j_episode.rollout_recorded, JC, j_maps, j_lanes, j_scene, n_ticks=10,
      every=5))(j_state)
  K = scene.scenarios.kind.shape[1]
  rng, draws = j_state.rng, []
  for _ in range(10):
    rng, r_step, r_scn = jax.random.split(rng, 3)
    draws.append({"steer_noise": T(jax.random.normal(r_step, (B,))),
                  "control_loss": T(jax.random.normal(r_scn, (B, K)))})
  final, traj = episode.rollout_recorded(CFG, maps, lanes, scene, state, 10,
                                         every=5, draws=draws)
  assert_leaves({k: np.asarray(v) for k, v in j_traj.items()},
                {k: v.numpy() for k, v in traj.items()}, 1e-4, 1e-4,
                "traj/")
  assert_leaves(jax_leaves(j_final, SimState, ""),
                dict(tree_items(final, "")), 1e-4, 1e-4, "final")
  assert traj["veh_pos"].shape == (2, B, 8, 2)
  valid = traj["veh_valid"].numpy()
  assert valid.any() and not valid[..., -1].any()
  assert int(final.tick.min()) == 10


def test_run_synthetic_benchmark_layout(monkeypatch):
  """The runner end to end at a tiny size (one chunk of 4 ticks): records
  and the global record in the JAX package's layout."""
  monkeypatch.setattr(benchmark, "CHUNK", 4)
  recs, g = benchmark.run_synthetic_benchmark(
      CFG, n_routes=2, n_vehicles=4, max_ticks=4, device="cpu",
      generator=torch.Generator().manual_seed(0))
  assert [r["route_id"] for r in recs] == ["synth_0_rep0", "synth_1_rep0"]
  assert list(recs[0]) == ["route_id", "town", "index", "status",
                           "infractions", "events", "scores", "meta"]
  assert list(recs[0]["infractions"]) == list(j_bench.INFRACTION_KEYS)
  assert list(g) == list(j_bench.aggregate(recs))
  assert recs[0]["meta"]["duration_game"] == 0.2


def _dagger_draws(rng, n_lidar, K):
  """One JAX tick's draws under make_dagger_policy and the next key."""
  rng, r_step, r_scn = jax.random.split(rng, 3)
  r_ex, r_ag = jax.random.split(r_step)
  r_gps, r_cmp, r_lid = jax.random.split(r_ag, 3)
  return rng, {"steer_noise": T(jax.random.normal(r_ex, (B,))),
               "gps": T(jax.random.normal(r_gps, (B, 2))),
               "compass": T(jax.random.normal(r_cmp, (B,))),
               "lidar": T(jax.random.uniform(r_lid, (B, n_lidar))),
               "control_loss": T(jax.random.normal(r_scn, (B, K)))}


def test_collect_dagger_frames_matches_jax(batch, monkeypatch, tmp_path):
  """2 frames (10 ticks) of DAgger at B=2: the micro model drives, the
  expert labels; frames and final state leaf for leaf, then the JSONL
  export of those frames."""
  pallas = functools.partial(j_rc.cast_rays, use_pallas=True)
  monkeypatch.setattr(j_camera, "cast_rays", pallas)
  monkeypatch.setattr(j_lidar, "cast_rays", pallas)
  (j_maps, j_lanes, j_scene, j_state), (maps, lanes, scene, state) = batch
  c = _tick_config()
  cam = camera_ray_grid(CFG, scale=8)
  lid_f = lidar_ray_grid(CFG, half=0, decimate=16)
  lid_r = lidar_ray_grid(CFG, half=1, decimate=16)
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  jm = jtf.LidarCenterNet(c)
  zeros = [np.zeros(s, np.float32) for s in
           ((B, c.img_h, c.img_w, 3), (B, c.lidar_h, c.lidar_w, 2),
            (B, 2), (B, 6), (B,))]
  params = _random_params(jax.eval_shape(jm.init, jax.random.key(0),
                                         *zeros))
  j_policy = j_agent.make_transfuser_policy(jm, params, c, cam, lid_f, lid_r,
                                            direct=True)
  j_state = j_state.replace(agent=j_agent.sensor_agent_reset(JC, B, n_lidar))
  j_final, j_frames = jax.jit(lambda st, p: j_dg.collect_dagger_frames(
      JC, j_maps, j_lanes, j_scene, st, j_policy, p, n_frames=2))(j_state,
                                                                  params)

  model = load_flax_params(
      ttf.LidarCenterNet(ttf.TransfuserConfig(**dataclasses.asdict(c))),
      jax.tree.map(np.asarray, params))
  policy = make_transfuser_policy(model, None, c, cam, lid_f, lid_r)
  st = state.replace(agent=sensor_agent_reset(CFG, B, n_lidar, device="cpu"))
  K = scene.scenarios.kind.shape[1]
  rng, draws = j_state.rng, []
  for _ in range(2 * datagen.SAVE_FREQ):
    rng, d = _dagger_draws(rng, n_lidar, K)
    draws.append(d)
  final, frames = datagen.collect_dagger_frames(CFG, maps, lanes, scene, st,
                                                policy, 2, draws=draws)
  assert frames.ego_pos.shape == (2, B, 2)
  # the model's f32 outputs steer the ego; sin/cos and the UKF agree to
  # an ulp: 1e-4 of positions up to a few hundred metres
  assert_leaves(jax_leaves(j_frames, datagen.Frames, ""),
                dict(tree_items(frames, "")), 1e-4, 1e-4, "frames")
  want = {k: np.asarray(v) for k, v in _jax_state_leaves(j_final).items()}
  assert_leaves(want, dict(tree_items(final, "")), 1e-4, 1e-4, "final")
  # the expert rode along: its planner advanced while the model drove
  assert int(final.expert.planner_dense.idx.min()) > 0

  j_path, t_path = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
  j_dg.export_frames_jsonl(j_frames, str(j_path), episode=1)
  datagen.export_frames_jsonl(to_port(j_frames, datagen.Frames),
                              str(t_path), episode=1)
  assert t_path.read_bytes() == j_path.read_bytes()
  lines = t_path.read_text().splitlines()
  assert len(lines) == 2 and json.loads(lines[0])["vehicles"]


def _random_params(shapes, seed=0):
  """Seeded weights for a flax parameter tree of these shapes, made in
  numpy (no compiled init): kernels ~ N(0, 1/fan_in), scales near 1,
  biases and embeddings small."""
  rng = np.random.default_rng(seed)

  def leaf(path, s):
    name = jax.tree_util.keystr(path).split("'")[-2]
    x = rng.normal(0.0, 1.0, s.shape)
    if name == "kernel":
      x = x / np.sqrt(max(np.prod(s.shape[:-1]), 1))
    elif name == "scale":
      x = 1.0 + 0.05 * x
    else:
      x = 0.02 * x
    return jnp.asarray(x, s.dtype)

  return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_state_leaves(j_state) -> dict:
  """The JAX state's leaves by the port's paths; the sensor agent's state
  is a JAX struct of the same field names."""
  from carla_garage_tpu_torch.agents.sensor_agent import SensorAgentState
  out = jax_leaves(j_state.replace(agent=()), SimState, "")
  out.update(jax_leaves(j_state.agent, SensorAgentState, "/agent"))
  return out
