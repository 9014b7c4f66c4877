"""Port parity: TransFuser++ training's repairs and the train_transfuser
entry point (carla_garage_tpu_torch/scripts/train_transfuser.py) against
the JAX package and the JAX script's own functions.

- The waypoint head trains: one micro step of a ``use_wp_gru=True`` model
  at ``wp_w`` 1 and 0 against JAX's step (loss, every aux loss and every
  gradient, the tolerances of tests/test_torch_port_train.py), from the
  same weights, frames and draws.
- One step object serves every dataset: built on dataset A and stepped
  on dataset B, it gives bit for bit what one built on B gives.
- ``build_dataset``: the port's expert with JAX's draws replayed records
  JAX's frames (1e-4; ints, bools and the gate equal); the sampler's pools
  and speed counts from JAX's frames are JAX's exactly. The speed weights
  from counts and ``sample_frames`` from one numpy seed are the script's.
- ``closed_loop_eval`` against JAX's functions composed as the script
  composes them at a chunk of 2 (the script hard-codes 512), float32 on
  both sides (the bf16 forward is held elsewhere), draws replayed.
- The shard cache key follows every datagen argument; a run stopped at an
  eval boundary and resumed equals an uninterrupted one bit for bit; a
  changed --lr is refused; the best checkpoint holds the boundary's
  weights, not the last.
"""

import dataclasses
import os
import pathlib
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from carla_garage_tpu.agents import sensor_agent as j_agent
from carla_garage_tpu.models import transfuser as jtf
from carla_garage_tpu.sim import episode as j_episode
from carla_garage_tpu.sim import scene_builder as j_sb
from carla_garage_tpu.sim import scoring as j_scoring
from carla_garage_tpu.train import transfuser_train as j_tt
from carla_garage_tpu_torch.config import DEFAULT_CONFIG
from carla_garage_tpu_torch.convert import load_flax_params
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.scripts import train_transfuser as tf
from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
from carla_garage_tpu_torch.sensors.lidar import (full_lidar_grid,
                                                  lidar_ray_grid)
from carla_garage_tpu_torch.sim.datagen import Frames
from carla_garage_tpu_torch.sim.episode import rollout
from carla_garage_tpu_torch.structs import tree_items
from carla_garage_tpu_torch.train import transfuser_train as tt
from carla_garage_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_port_eval import _random_params
from test_torch_port_scene import clear_jax_town_caches, jax_leaves, to_port
from test_torch_port_tick import _tick_config
from test_torch_port_train import (CFG, JCFG, TCFG, assert_grads_close,
                                   batch_draws, close, setup)  # noqa: F401

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent /
                       "scripts"))
import train_transfuser as j_tf  # noqa: E402  (the JAX script)

B = 2
T = lambda a: torch.from_numpy(np.array(a))
TCFG_WP = dataclasses.replace(TCFG, use_wp_gru=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core): a torch
  thread pool of its own per process would oversubscribe the cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_jax_town_caches():
  clear_jax_town_caches()


@pytest.fixture(scope="module")
def wp_jax_step(setup):  # noqa: F811
  """JAX's train step of the waypoint-head model under sgd(1.0) at wp_w 1
  and 0 from one set of weights: {wp_w: (new params, aux)}, with the
  frame indices and the draws replayed into the port."""
  s = setup
  jm = jtf.LidarCenterNet(TCFG_WP)
  zeros = [np.zeros(x, np.float32) for x in
           ((B, TCFG.img_h, TCFG.img_w, 3), (B, TCFG.lidar_h, TCFG.lidar_w,
                                             2), (B, 2), (B, 6), (B,))]
  params = jax.tree.map(np.asarray, _random_params(
      jax.eval_shape(jm.init, jax.random.key(0), *zeros), seed=2))
  tx = optax.sgd(1.0)
  step_fn, _, _ = j_tt.make_transfuser_train_step(
      JCFG, TCFG_WP, jm, tx, s["maps"], s["scene"], s["frames"], s["cam"],
      s["lid"])
  f_idx = np.array([1, 3], np.int32)
  rng = jax.random.key(21)
  out = {}
  for wp_w in (1.0, 0.0):
    p = jax.tree.map(jnp.array, params)
    new, _, aux = step_fn(p, tx.init(p), jnp.asarray(f_idx), rng,
                          s["maps"], s["scene"], s["frames"], wp_w)
    out[wp_w] = (jax.tree.map(np.asarray, new),
                 {k: np.asarray(v) for k, v in aux.items()})
  draws = [batch_draws(jax.random.split(r, 1)[0], s["n_lidar"])
           for r in jax.random.split(rng, len(f_idx))]
  return dict(params=params, out=out, f_idx=f_idx.tolist(), draws=draws)


def _port(params):
  return load_flax_params(ttf.LidarCenterNet(
      ttf.TransfuserConfig(**dataclasses.asdict(TCFG_WP))), params)


@pytest.mark.parametrize("wp_w", [1.0, 0.0])
def test_waypoint_head_step_matches_jax(setup, wp_jax_step, wp_w):  # noqa: F811
  s, j = setup, wp_jax_step
  new_want, aux_want = j["out"][wp_w]
  model = _port(j["params"])
  old = {n: p.detach().clone() for n, p in model.named_parameters()}
  want_new = {n: p.detach() for n, p in _port(new_want).named_parameters()}
  opt = torch.optim.SGD(model.parameters(), lr=1.0)
  step, _, _ = tt.make_transfuser_train_step(
      CFG, TCFG_WP, model, opt, s["t_maps"], s["t_scene"], s["t_frames"],
      s["cam"], s["lid"])
  aux = step(j["f_idx"], draws=j["draws"], wp_w=wp_w)
  assert "loss_wp" in aux and set(aux) == set(aux_want)
  for k, v in aux_want.items():
    close(aux[k], v, 2e-4, 1e-5, k)
  if wp_w == 0.0:
    assert float(aux["loss_wp"]) == 0.0
  else:
    assert float(aux["loss_wp"]) > 0.0
  assert_grads_close(model, old, want_new)
  wp_head = [n for n in old if n.startswith("wp_decoder")]
  moved = any(not torch.equal(old[n], dict(model.named_parameters())[n])
              for n in wp_head)
  assert wp_head and moved == (wp_w == 1.0)


def test_one_step_object_serves_every_dataset(setup):  # noqa: F811
  """A step built on dataset A (other poses, every episode done) and
  stepped on B equals one built on B, and so does its eval step."""
  s = setup
  fa = s["t_frames"]
  frames_a = fa.replace(ego_pos=fa.ego_pos + 3.0,
                        alive=torch.zeros_like(fa.alive))
  data_b = (s["t_maps"], s["t_scene"], s["t_frames"])
  results = []
  for built_on, data in (((s["t_maps"], s["t_scene"], frames_a), data_b),
                         (data_b, None)):
    torch.manual_seed(0)
    model = ttf.LidarCenterNet(ttf.TransfuserConfig(
        **dataclasses.asdict(TCFG_WP)))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    step, eval_step, _ = tt.make_transfuser_train_step(
        CFG, TCFG_WP, model, opt, *built_on, s["cam"], s["lid"])
    gen = torch.Generator().manual_seed(3)
    aux = step([2, 5], generator=gen, data=data)
    aux2 = step([4], generator=gen, data=data, wp_w=0.0)
    ev = eval_step([1], generator=gen, data=data)
    results.append((aux, aux2, ev, model.state_dict()))
  (a, a2, ea, sa), (b, b2, eb, sb) = results
  for x, y in ((a, b), (a2, b2), (ea, eb)):
    assert set(x) == set(y)
    for k in x:
      assert torch.equal(x[k], y[k]), k
  for k in sa:
    assert torch.equal(sa[k], sb[k]), k
  assert float(a["loss"]) > 0 and float(a2["loss_wp"]) == 0.0


def _script_args(**kw):
  a = dict(episodes=B, frames=20, min_vehicles=4, max_vehicles=8,
           crop_margin_m=130.0, min_route_m=250.0, max_route_m=500.0,
           no_scenarios=False, eval_n_vehicles=8, dagger_frames=20,
           assets_root=None)
  a.update(kw)
  return types.SimpleNamespace(**a)


def test_build_dataset_matches_jax(monkeypatch):
  args = _script_args()
  seed = 17
  ds_j = j_tf.build_dataset(args, seed=seed, town_name="synth")
  n_veh = int(np.random.default_rng(seed).integers(4, 9))
  _, _, _, j_scene, j_state = j_sb.make_town_batch(
      j_tf.CFG, "synth", batch=B, seed=seed, n_vehicles=n_veh, n_walkers=2,
      crop_margin_m=130.0, min_route_m=250.0, max_route_m=500.0,
      use_scenarios=True)
  K = j_scene.scenarios.kind.shape[1]
  rng, draws = j_state.rng, []
  for _ in range(args.frames * 5):
    rng, r_step, r_scn = jax.random.split(rng, 3)
    draws.append({"steer_noise": T(jax.random.normal(r_step, (B,))),
                  "control_loss": T(jax.random.normal(r_scn, (B, K)))})
  real = tf.collect_expert_frames

  def collect(c, maps, lanes, scene, st, n, generator=None):
    tick = draws[:n * 5]
    del draws[:n * 5]
    return real(c, maps, lanes, scene, st, n, draws=tick)

  monkeypatch.setattr(tf, "collect_expert_frames", collect)
  ds = tf.build_dataset(DEFAULT_CONFIG, args, seed=seed, town_name="synth",
                        device="cpu")
  assert not draws
  want = jax_leaves(ds_j["frames"], Frames, "")
  got = dict(tree_items(ds["frames"], ""))
  assert set(want) == set(got)
  for k, w in want.items():
    # 100 expert ticks with scenarios (the expert tests' 1e-4)
    close(got[k], w, 1e-4, 1e-4, k)
  assert ds["n_clean"] == ds_j["n_clean"]
  pools = tf.frame_pools(DEFAULT_CONFIG, to_port(ds_j["frames"], Frames))
  for got_pools in (ds, pools):
    for k in ("usable", "usable_brake", "holdout", "speed_counts"):
      np.testing.assert_array_equal(got_pools[k], ds_j[k], err_msg=k)
      assert got_pools[k].dtype == np.asarray(ds_j[k]).dtype, k
  assert len(ds["usable"]) and len(ds["holdout"]) == 1


def test_speed_weights_and_sample_frames_match_the_script():
  """The speed weights (scripts/train_transfuser.py:495-499) and
  sample_frames (:534-540), each as the script writes it."""
  for counts in ([120.0, 3.0, 400.0, 1500.0], [0.0, 1.0, 0.0, 9000.0],
                 [50.0, 50.0, 50.0, 50.0]):
    dss = [{"speed_counts": np.asarray(counts) * f} for f in (0.25, 0.75)]
    c = np.maximum(sum(d["speed_counts"] for d in dss), 1.0)
    want = tuple(np.clip(c.sum() / (4.0 * c), 0.05, 20.0).tolist())
    assert tf.speed_class_weights(dss) == want

  pools = [dict(usable=np.arange(3, 40), usable_brake=np.array([5, 9, 30])),
           dict(usable=np.arange(0, 12), usable_brake=np.zeros(0, np.int64))]
  np_rng, want_rng = np.random.default_rng(0), np.random.default_rng(0)

  def script_sample(ds, k):
    ps = [ds["usable_brake"] if (len(ds["usable_brake"]) and
                                 want_rng.random() < 0.5)
          else ds["usable"] for _ in range(k)]
    return jnp.asarray([want_rng.choice(p) for p in ps], jnp.int32)

  for i in range(20):
    ds = pools[i % 2]
    got = tf.sample_frames(ds, 4, np_rng, 0.5)
    assert got == np.asarray(script_sample(ds, 4)).tolist()
    assert all(isinstance(x, int) for x in got)
  assert np_rng.random() == want_rng.random()


def test_closed_loop_eval_matches_jax_composed(monkeypatch):
  c = _tick_config()
  args = _script_args(eval_n_vehicles=6)
  cam = camera_ray_grid(DEFAULT_CONFIG, scale=8)
  lid_f = lidar_ray_grid(DEFAULT_CONFIG, half=0, decimate=16)
  lid_r = lidar_ray_grid(DEFAULT_CONFIG, half=1, decimate=16)
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  jm = jtf.LidarCenterNet(c)
  zeros = [np.zeros(x, np.float32) for x in
           ((B, c.img_h, c.img_w, 3), (B, c.lidar_h, c.lidar_w, 2), (B, 2),
            (B, 6), (B,))]
  params = _random_params(jax.eval_shape(jm.init, jax.random.key(0),
                                         *zeros), seed=6)
  seed, town, max_ticks, chunk = 321, "synth3", 4, 2
  jcfg = j_tf.CFG
  # JAX's closed_loop_eval, composed at chunk 2 and float32
  _, maps, lanes, scene, state = j_sb.make_town_batch(
      jcfg, town, batch=B, seed=seed, n_vehicles=6, n_walkers=2,
      use_scenarios=True, crop_margin_m=130.0)
  route_lens = jnp.asarray([
      float(np.asarray(scene.route.seg_len)[i][
          :int(np.asarray(scene.route.num_valid)[i])].sum())
      for i in range(B)])
  policy = j_agent.make_transfuser_policy(jm, None, c, cam, lid_f, lid_r,
                                          direct=True, bf16=False,
                                          brake_threshold=0.33)
  st = state.replace(agent=j_agent.sensor_agent_reset(jcfg, B, n_lidar))
  final = j_episode.rollout_chunked(jcfg, maps, lanes, scene, st, max_ticks,
                                    chunk=chunk, policy=policy,
                                    policy_params=params)
  sc = j_scoring.compute_scores(jcfg, final.criteria, route_lens)
  cr = final.criteria
  m = lambda x: float(np.asarray(x, np.float32).mean())
  want = dict(DS=float(jnp.mean(sc.score_composed)),
              RC=float(jnp.mean(sc.score_route)),
              IS=float(jnp.mean(sc.score_penalty)),
              coll_veh=m(cr.n_collision_vehicle),
              coll_wlk=m(cr.n_collision_walker),
              coll_stat=m(cr.n_collision_static),
              red_light=m(cr.n_red_light), stop_sign=m(cr.n_stop_sign),
              outside_lane_m=m(cr.outside_lane_m), blocked=m(cr.blocked))

  K = scene.scenarios.kind.shape[1]
  rng, draws = state.rng, []
  for _ in range(max_ticks):
    rng, r_step, r_scn = jax.random.split(rng, 3)
    r_gps, r_cmp, r_lid = jax.random.split(r_step, 3)
    draws.append({"gps": T(jax.random.normal(r_gps, (B, 2))),
                  "compass": T(jax.random.normal(r_cmp, (B,))),
                  "lidar": T(jax.random.uniform(r_lid, (B, n_lidar))),
                  "control_loss": T(jax.random.normal(r_scn, (B, K)))})

  def replayed(cfg, mp_, ln, sc_, st_, n_ticks, chunk, policy, generator):
    ticks = 0
    while ticks < n_ticks:
      st_ = rollout(cfg, mp_, ln, sc_, st_, chunk, policy,
                    draws=draws[ticks:ticks + chunk])
      ticks += chunk
      if bool(st_.done.all()):
        break
    return st_

  real_policy = tf.make_sensor_policy
  monkeypatch.setattr(tf, "rollout_chunked", replayed)
  monkeypatch.setattr(tf, "make_sensor_policy",
                      lambda *a, **kw: real_policy(*a, **{**kw,
                                                          "bf16": False}))
  model = load_flax_params(ttf.LidarCenterNet(ttf.TransfuserConfig(
      **dataclasses.asdict(c))), jax.tree.map(np.asarray, params))
  cfg = DEFAULT_CONFIG.replace(sim=dataclasses.replace(
      DEFAULT_CONFIG.sim, max_vehicles=jcfg.sim.max_vehicles))
  got = tf.closed_loop_eval(cfg, args, c, model, None, cam, lid_f, lid_r, B,
                            seed, max_ticks=max_ticks, town_name=town,
                            chunk=chunk, device="cpu")
  assert set(got) == set(want)
  for k, w in want.items():
    assert abs(got[k] - w) <= 1e-5 * max(abs(w), 1.0), (k, got[k], w)
  assert want["RC"] > 0


def test_cache_key_follows_every_datagen_argument():
  args = tf.parse_args(["--towns", "synth"])
  cfg = DEFAULT_CONFIG
  base = tf.cache_key(args, cfg, None)
  for flag, value in (("crop_margin_m", 90.0), ("episodes", 8),
                      ("frames", 40), ("min_vehicles", 10),
                      ("max_vehicles", 60), ("min_route_m", 100.0),
                      ("max_route_m", 900.0), ("crop_px", 0),
                      ("no_scenarios", True)):
    changed = types.SimpleNamespace(**{**vars(args), flag: value})
    assert tf.cache_key(changed, cfg, None) != base, flag
  assert tf.cache_key(args, cfg, (1800, 1800)) != base
  wide = cfg.replace(sim=dataclasses.replace(cfg.sim, max_vehicles=140))
  assert tf.cache_key(args, wide, None) != base
  same = types.SimpleNamespace(**{**vars(args), "lr": 1.0, "out": "x",
                                  "steps": 7})
  assert tf.cache_key(same, cfg, None) == base


class Stop(Exception):
  pass


def _run_args(out, *extra):
  return tf.parse_args([
      "--micro", "--no-bf16", "--towns", "synth", "--eval-towns", "synth3",
      "--datasets", "1", "--episodes", "2", "--frames", "20", "--steps", "4",
      "--frames-per-step", "1", "--block-steps", "2", "--eval-every", "2",
      "--eval-routes", "1", "--final-eval-seeds", "1", "--min-vehicles",
      "4", "--max-vehicles", "8", "--eval-n-vehicles", "8", "--log-every",
      "1", "--out", str(out), "--results", f"{out}.json", *extra])


def test_resume_equals_an_uninterrupted_run(monkeypatch, tmp_path):
  """4 steps with eval boundaries at 2 and 4 in one run, against a run
  stopped in its third step and started again: the train state, history,
  evals and checkpoints bit for bit. The eval suite is replaced by one
  that scores the boundaries 50, then 10: the best checkpoint is step 2's
  weights. The offline diagnosis runs for real. The model and sensors are
  cut to the training tests' reduced sizes (a 128x128 BEV, a 32x128
  camera, a 16x-decimated sweep)."""
  monkeypatch.setattr(tf, "DEFAULT_CONFIG", CFG)
  monkeypatch.setattr(tf, "model_config", lambda args: TCFG)
  monkeypatch.setattr(tf, "camera_ray_grid",
                      lambda cfg, scale: camera_ray_grid(cfg, scale=8))
  monkeypatch.setattr(tf, "full_lidar_grid",
                      lambda cfg, decimate: full_lidar_grid(cfg,
                                                            decimate=16))
  scores = {}

  def fake_suite(cfg, args, tcfg, model, params, *a, **kw):
    seeds = a[4]
    key = (args.out, len(scores.get(args.out, [])))
    ds = 50.0 if key[1] == 0 else 10.0
    scores.setdefault(args.out, []).append(ds)
    return {"DS": ds, "DS_std": 0.0, "RC": 1.0, "IS": 1.0, "rows": [],
            "seeds": list(seeds)}

  monkeypatch.setattr(tf, "eval_suite", fake_suite)
  whole = tmp_path / "whole"
  out_whole = tf.run(_run_args(whole), device="cpu")

  parted = tmp_path / "parted"
  shutil.copytree(f"{whole}_shards", f"{parted}_shards")
  real_make = tf.make_transfuser_train_step
  calls = []

  def stopping(*a, **kw):
    step, ev, wp = real_make(*a, **kw)

    def s(*sa, **skw):
      calls.append(1)
      if len(calls) == 3:
        raise Stop()
      return step(*sa, **skw)
    return s, ev, wp

  monkeypatch.setattr(tf, "make_transfuser_train_step", stopping)
  built = []
  real_build = tf.build_dataset
  monkeypatch.setattr(tf, "build_dataset",
                      lambda *a, **kw: built.append(1) or real_build(*a,
                                                                     **kw))
  with pytest.raises(Stop):
    tf.run(_run_args(parted), device="cpu")
  ts = torch.load(f"{parted}_trainstate.pt", weights_only=False)
  assert ts["step"] == 2
  monkeypatch.setattr(tf, "make_transfuser_train_step", real_make)
  out_parted = tf.run(_run_args(parted), device="cpu")
  assert not built                     # every shard came from the cache

  a = torch.load(f"{whole}_trainstate.pt", weights_only=False)
  b = torch.load(f"{parted}_trainstate.pt", weights_only=False)
  assert a["step"] == b["step"] == 4
  for k in a["model"]:
    assert torch.equal(a["model"][k], b["model"][k]), k
  assert a["np_rng"] == b["np_rng"]
  assert torch.equal(a["generator"], b["generator"])
  strip = lambda h: [{k: v for k, v in x.items() if k != "wall_s"}
                     for x in h]
  assert strip(a["history"]) == strip(b["history"]) and len(a["history"]) == 4
  assert [e["diagnosis"] for e in a["evals"]] == \
      [e["diagnosis"] for e in b["evals"]]
  assert out_whole["transfuser_DS"] == out_parted["transfuser_DS"]

  best, meta = load_checkpoint(str(whole))
  step2, _ = load_checkpoint(f"{whole}_step2")
  step4, _ = load_checkpoint(f"{whole}_step4")
  assert meta["best_eval"]["step"] == 2
  assert all(torch.equal(best[k], step2[k]) for k in best)
  assert not all(torch.equal(best[k], step4[k]) for k in best)
  assert all(torch.equal(a["model"][k], step4[k]) for k in step4)
  for name in ("", "_step2", "_step4"):
    p_best, _ = load_checkpoint(f"{parted}{name}")
    w_best, _ = load_checkpoint(f"{whole}{name}")
    assert all(torch.equal(p_best[k], w_best[k]) for k in w_best), name

  with pytest.raises(SystemExit, match="lr"):
    tf.run(_run_args(whole, "--lr", "1e-3"), device="cpu")
  assert os.path.exists(f"{whole}_trainstate.pt")
