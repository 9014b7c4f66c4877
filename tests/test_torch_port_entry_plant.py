"""Port parity: the PlanT entry points (carla_garage_tpu_torch/scripts/
train_plant.py and dagger_ab.py) against the JAX scripts' own functions
(``scripts/`` on ``sys.path``), and the multi-town scene builder.

- ``concat_datasets`` with None fields: bit-equal to JAX's.
- ``datagen_shard``: the port's expert, with JAX's draws replayed (a tick
  splits ``state.rng`` three ways, episode.py:51: the expert's steer
  noise, then the scenario engine's control-loss noise), records the
  frames JAX's records (floats to 1e-4, ints and bools equal, the quality
  gate equal); the dataset built from JAX's frames is JAX's dataset
  (1e-5 absolute, ints equal, as tests/test_torch_port_plant_train.py).
- ``plant_eval_suite`` against JAX's functions composed as the script
  composes them, at a chunk of 4 (the script hard-codes 512), with the
  draws replayed: every row's scores to 1e-5 relative, counts equal.
- ``collect_dagger_ds``: waypoint weight 0 on every sample; ``run_arm``'s
  datasets, ``run``'s checkpoint selection and results keys.
- Imported town names: built from an asset root; an absent root stops every
  entry point before any datagen and any results file.
- ``make_town_batch("synth<N>")`` and a two-town ``build_batch`` as
  ``tests/test_multi_town.py`` builds it: bit-equal to JAX's.
"""

import argparse
import dataclasses
import json
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_garage_tpu.agents import plant_agent as j_pa
from carla_garage_tpu.maps import synthetic as j_syn
from carla_garage_tpu.models import plant as j_plant
from carla_garage_tpu.sim import episode as j_episode
from carla_garage_tpu.sim import scene_builder as j_sb
from carla_garage_tpu.sim import scoring as j_scoring
from carla_garage_tpu.train import plant_train as j_pt
from carla_garage_tpu_torch.convert import load_flax_params
from carla_garage_tpu_torch.maps import synthetic
from carla_garage_tpu_torch.models.plant import PlanT
from carla_garage_tpu_torch.scripts import dagger_ab as da
from carla_garage_tpu_torch.scripts import train_plant as tp
from carla_garage_tpu_torch.scripts import train_transfuser as tf
from carla_garage_tpu_torch.sim import scene_builder
from carla_garage_tpu_torch.sim.datagen import Frames
from carla_garage_tpu_torch.sim.episode import rollout
from carla_garage_tpu_torch.structs import Scene, tree_items
from carla_garage_tpu_torch.train import plant_train as pt
from carla_garage_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_port_eval import _random_params
from test_torch_port_plant_train import _random_ds, close
from test_torch_port_scenarios import _compare_batches
from test_torch_port_scene import jax_leaves, to_port

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent /
                       "scripts"))
import train_plant as j_tp  # noqa: E402  (the JAX script)

B = 2
T = lambda a: torch.from_numpy(np.array(a))
ARGS = types.SimpleNamespace(episodes=B, n_vehicles=6, n_walkers=2,
                             min_route_m=300.0, max_route_m=500.0, frames=20,
                             dagger_frames=20, assets_root=None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core): a torch
  thread pool of its own per process would oversubscribe the cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def replayed_draws(j_state, K, n, expert=True):
  """n ticks of JAX's draws from the state's key: the expert's steer noise
  (when the expert drives; the PlanT policy draws nothing) and the
  control-loss noise of K scenario rows."""
  rng, out = j_state.rng, []
  for _ in range(n):
    rng, r_step, r_scn = jax.random.split(rng, 3)
    d = {"control_loss": T(jax.random.normal(r_scn, (B, K)))}
    if expert:
      d["steer_noise"] = T(jax.random.normal(r_step, (B,)))
    out.append(d)
  return out


def test_concat_datasets_matches_jax():
  rng = np.random.default_rng(0)

  def part(n, with_w):
    return {f.name: rng.normal(size=(n, 3)).astype(np.float32)
            for f in dataclasses.fields(j_pt.PlantDataset)
            if f.name != "wp_weight"} | {
        "wp_weight": np.zeros(n, np.float32) if with_w else None}

  specs = [part(4, False), part(3, True), part(2, False)]
  j_parts = [j_pt.PlantDataset(**{k: None if v is None else v.copy()
                                  for k, v in s.items()}) for s in specs]
  t_parts = [pt.PlantDataset(**{k: None if v is None else T(v)
                                for k, v in s.items()}) for s in specs]
  want = j_tp.concat_datasets(j_parts)
  got = tp.concat_datasets(t_parts)
  for f in dataclasses.fields(j_pt.PlantDataset):
    close(getattr(got, f.name), getattr(want, f.name), 0, 0, f.name)
  # the parts are left as they were (JAX's grows its first part in place)
  assert len(t_parts[0]) == 4 and t_parts[0].wp_weight is None
  both_none = tp.concat_datasets(t_parts[::2])
  assert both_none.wp_weight is None and len(both_none) == 6


@pytest.fixture(scope="module")
def shard():
  """JAX's datagen_shard and the port's with JAX's draws replayed; the
  frames and scene each side built its dataset from."""
  seed = 5
  j_cfg, cfg = j_tp.honest_cfg(ARGS.n_vehicles), tp.honest_cfg(6)
  j_pcfg, pcfg = j_tp.plant_config(), tp.plant_config()
  seen = {}
  mp = pytest.MonkeyPatch()

  def j_record(c, p, frames, scene):
    seen["jax"] = (frames, scene)
    return j_pt.build_plant_dataset(c, p, frames, scene)

  mp.setattr(j_tp, "build_plant_dataset", j_record)
  j_ds, j_clean = j_tp.datagen_shard(j_cfg, j_pcfg, ARGS, "synth", seed)

  _, _, _, j_scene, j_state = j_sb.make_town_batch(
      j_cfg, "synth", batch=B, seed=seed, n_vehicles=ARGS.n_vehicles,
      n_walkers=ARGS.n_walkers, use_scenarios=True,
      min_route_m=ARGS.min_route_m, max_route_m=ARGS.max_route_m)
  draws = replayed_draws(j_state, j_scene.scenarios.kind.shape[1],
                         ARGS.frames * 5)
  real_collect, real_build = tp.collect_expert_frames, tp.build_plant_dataset

  def collect(c, maps, lanes, scene, st, n, generator=None):
    tick = draws[:n * 5]
    del draws[:n * 5]
    return real_collect(c, maps, lanes, scene, st, n, draws=tick)

  def t_record(c, p, frames, scene):
    seen["port"] = (frames, scene)
    return real_build(c, p, frames, scene)

  mp.setattr(tp, "collect_expert_frames", collect)
  mp.setattr(tp, "build_plant_dataset", t_record)
  ds, n_clean = tp.datagen_shard(cfg, pcfg, ARGS, "synth", seed,
                                 device="cpu")
  mp.undo()
  assert not draws
  return dict(j_ds=j_ds, j_clean=j_clean, ds=ds, n_clean=n_clean,
              seen=seen, cfg=cfg, pcfg=pcfg)


def test_datagen_shard_matches_jax(shard):
  s = shard
  assert s["n_clean"] == s["j_clean"]
  (j_frames, j_scene), (frames, scene) = s["seen"]["jax"], s["seen"]["port"]
  want = jax_leaves(j_frames, Frames, "")
  got = dict(tree_items(frames, ""))
  assert set(want) == set(got)
  for k, w in want.items():
    # 100 expert ticks with scenarios: sin/cos and cumulative sums of two
    # libraries differ by ulps, as in the expert tests (1e-4)
    close(got[k], w, 1e-4, 1e-4, k)
  # the gate is in the alive mask: clean episodes keep their frames
  assert len(s["ds"]) == len(s["j_ds"]) > 0
  rebuilt = pt.build_plant_dataset(s["cfg"], s["pcfg"],
                                   to_port(j_frames, Frames),
                                   to_port(j_scene, Scene))
  for f in dataclasses.fields(j_pt.PlantDataset):
    w = getattr(s["j_ds"], f.name)
    if w is None:
      assert getattr(rebuilt, f.name) is None
      continue
    close(getattr(rebuilt, f.name), w, 0, 1e-5, f.name)


@pytest.fixture(scope="module")
def micro_plant_models():
  pcfg = j_plant.micro_plant()
  jm = j_plant.PlanT(pcfg)
  O, R = pcfg.max_objects, pcfg.num_route_points
  x = (np.zeros((1, O, 7), np.float32), np.zeros((1, O), np.int32),
       np.zeros((1, R, 2), np.float32)) + (np.zeros(1, np.float32),) * 4
  params = _random_params(jax.eval_shape(jm.init, jax.random.key(0), *x),
                          seed=4)
  tm = load_flax_params(PlanT(pcfg), jax.tree.map(np.asarray, params))
  return pcfg, jm, params, tm


def test_plant_eval_suite_matches_jax_composed(micro_plant_models,
                                               monkeypatch):
  pcfg, jm, params, tm = micro_plant_models
  town, seed, max_ticks, chunk = "synth3", 4321, 8, 4
  j_cfg, cfg = j_tp.honest_cfg(6), tp.honest_cfg(6)
  # JAX's plant_eval_suite, composed at chunk 4
  _, maps, lanes, scene, state = j_sb.make_town_batch(
      j_cfg, town, batch=B, seed=seed, n_vehicles=ARGS.n_vehicles,
      n_walkers=ARGS.n_walkers, use_scenarios=True, min_route_m=300.0,
      max_route_m=600.0)
  route_lens = jnp.asarray([
      float(np.asarray(scene.route.seg_len)[i][
          :int(np.asarray(scene.route.num_valid)[i])].sum())
      for i in range(B)])
  policy = j_pa.make_plant_policy(jm, None, pcfg, direct=True,
                                  brake_threshold=0.33)
  final = j_episode.rollout_chunked(
      j_cfg, maps, lanes, scene, state.replace(
          agent=j_pa.plant_agent_reset(j_cfg, B)), max_ticks, chunk=chunk,
      policy=policy, policy_params=params)
  sc = j_scoring.compute_scores(j_cfg, final.criteria, route_lens)
  cr = final.criteria
  m = lambda x: float(np.asarray(x, np.float32).mean())
  want = dict(town=town, seed=seed, DS=float(jnp.mean(sc.score_composed)),
              RC=float(jnp.mean(sc.score_route)),
              IS=float(jnp.mean(sc.score_penalty)),
              coll_veh=m(cr.n_collision_vehicle),
              coll_wlk=m(cr.n_collision_walker),
              red_light=m(cr.n_red_light), blocked=m(cr.blocked))

  draws = replayed_draws(state, scene.scenarios.kind.shape[1], max_ticks,
                         expert=False)

  def replayed(c, mp_, ln, sc_, st, n_ticks, chunk, policy, generator):
    ticks = 0
    while ticks < n_ticks:
      st = rollout(c, mp_, ln, sc_, st, chunk, policy,
                   draws=draws[ticks:ticks + chunk])
      ticks += chunk
      if bool(st.done.all()):
        break
    return st

  monkeypatch.setattr(tp, "rollout_chunked", replayed)
  got = tp.plant_eval_suite(cfg, tm, None, pcfg, [town], [seed], B, ARGS,
                            max_ticks=max_ticks, chunk=chunk, device="cpu")
  assert len(got["rows"]) == 1 and set(got["rows"][0]) == set(want)
  for k, w in want.items():
    g = got["rows"][0][k]
    assert g == w if isinstance(w, (str, int)) else \
        abs(g - w) <= 1e-5 * max(abs(w), 1.0), (k, g, w)
  assert got["DS"] == got["rows"][0]["DS"] and got["DS_std"] == 0.0
  assert want["RC"] > 0


def test_collect_dagger_ds_has_waypoint_weight_zero(micro_plant_models):
  pcfg, _, _, tm = micro_plant_models
  cfg = tp.honest_cfg(6)
  ds = da.collect_dagger_ds(cfg, pcfg, ARGS, tm, None, "synth2", seed=9031,
                            device="cpu")
  assert len(ds) > 0 and ds.wp_weight.shape == (len(ds),)
  assert bool((ds.wp_weight == 0).all())
  mixed = tp.concat_datasets([_random_ds(), ds])
  assert bool((mixed.wp_weight[:40] == 1).all())
  assert bool((mixed.wp_weight[40:] == 0).all())


def test_run_arm_and_the_verdict(monkeypatch):
  """run_arm's datasets: segment 0 on BC, segment 1 on [bc, dag], later
  [train, dag]; DAgger towns and seeds as the JAX script picks them; the
  speed weights of segment 0 carried on. The verdict rule of
  scripts/dagger_ab.py:162-166."""
  bc = _random_ds()
  sizes, collects, weights = [], [], []

  def fake_collect(cfg, pcfg, args, model, params, town, seed, device):
    collects.append((town, seed))
    d = _random_ds()
    d.wp_weight = torch.zeros(len(d))
    return d

  def fake_train(cfg, pcfg, ds, **kw):
    sizes.append(len(ds))
    weights.append(kw["speed_weights"])
    return PlanT(pt_micro()), [{"loss": 1.0}]

  monkeypatch.setattr(da, "collect_dagger_ds", fake_collect)
  monkeypatch.setattr(da, "train_plant", fake_train)
  monkeypatch.setattr(da, "plant_eval_suite",
                      lambda *a, **kw: {"DS": 1.0, "DS_std": 0.0})
  args = types.SimpleNamespace(segments=3, seg_steps=5, batch=8, lr=1e-3,
                               towns=["synth", "synth2", "synth4"],
                               eval_towns=["synth3"], eval_routes=2,
                               eval_max_ticks=8)
  ev = da.run_arm("dagger", None, None, args, bc, [1], device="cpu")
  assert sizes == [40, 80, 120]
  assert collects == [("synth", 9031), ("synth4", 9062)]
  assert weights[0] == pt.estimate_speed_weights(bc)
  assert weights[1:] == weights[:1] * 2
  assert ev["arm"] == "dagger" and ev["total_steps"] == 15
  sizes.clear()
  da.run_arm("bc", None, None, args, bc, [1], device="cpu")
  assert sizes == [40, 40, 40] and len(collects) == 2
  for a, b in ((10.0, 12.5), (10.0, 7.0), (10.0, 11.0)):
    rows = [{"DS": a, "DS_std": 2.0}, {"DS": b, "DS_std": 1.0}]
    delta = rows[1]["DS"] - rows[0]["DS"]
    noise = max(rows[0]["DS_std"], rows[1]["DS_std"])
    want = ("dagger helps" if delta > noise else
            "dagger hurts" if delta < -noise else "within noise")
    assert da.verdict(rows) == (delta, noise, want)


def test_train_plant_run_keeps_the_best_segment(monkeypatch, tmp_path):
  """run with the datagen and the eval suite replaced: the checkpoint
  holds the best segment's weights, bit for bit, and the results JSON the
  JAX script's keys."""
  seg_states, dss = [], iter([10.0, 30.0, 20.0])
  real_train = tp.train_plant
  monkeypatch.setattr(tp, "datagen_shard",
                      lambda *a, **kw: (_random_ds(), 2))

  def train(*a, **kw):
    model, hist = real_train(*a, **kw)
    seg_states.append({k: v.clone() for k, v in model.state_dict().items()})
    return model, hist

  monkeypatch.setattr(tp, "train_plant", train)
  monkeypatch.setattr(tp, "plant_eval_suite",
                      lambda *a, **kw: {"DS": next(dss), "DS_std": 0.0,
                                        "RC": 1.0, "coll_veh": 0.0})
  monkeypatch.setattr(tp, "plant_config", pt_micro)
  args = tp.parse_args(["--towns", "synth", "--eval-towns", "synth3",
                        "--shards", "2", "--steps", "6", "--segments", "3",
                        "--batch", "8", "--out", str(tmp_path / "ck"),
                        "--results", str(tmp_path / "r.json")])
  out = tp.run(args, device="cpu")
  back = json.loads((tmp_path / "r.json").read_text())
  assert set(back) == {"samples", "steps", "best_eval", "evals", "meta"}
  assert back["samples"] == 80 and back["best_eval"]["segment"] == 1
  assert out["best_eval"]["DS"] == 30.0
  saved, meta = load_checkpoint(str(tmp_path / "ck"))
  assert meta["model"] == "plant" and meta["samples"] == 80
  assert all(torch.equal(saved[k], seg_states[1][k]) for k in saved)
  assert not all(torch.equal(saved[k], seg_states[2][k]) for k in saved)


def pt_micro():
  from carla_garage_tpu_torch.models.plant import micro_plant
  return micro_plant()


class Stop(Exception):
  pass


@pytest.mark.parametrize("entry", ["train_plant", "dagger_ab",
                                   "train_transfuser"])
def test_imported_towns_stop_before_any_datagen(entry, monkeypatch,
                                                tmp_path):
  """An imported town name from an absent asset root stops each entry
  point before any datagen and before any results file; from an asset
  root that holds it, the first datagen shard is built on that town."""
  from test_torch_port_importer import write_asset_root
  monkeypatch.setenv("CGT_TOWN_CACHE", str(tmp_path / "cache"))
  root = str(tmp_path / "reference")
  write_asset_root(root)
  built = []

  def first_shard(cfg, *a, **kw):
    args = next(x for x in a if isinstance(x, argparse.Namespace))
    name = kw.get("town_name") or next(x for x in a if isinstance(x, str))
    town, *_ = scene_builder.make_town_batch(
        cfg, name, batch=1, min_route_m=90.0, max_route_m=200.0,
        assets_root=args.assets_root, device="cpu")
    built.append((name, town.raster.shape))
    raise Stop

  for mod, name in ((tp, "datagen_shard"), (da, "datagen_shard"),
                    (tf, "build_dataset")):
    monkeypatch.setattr(mod, name, first_shard)
  mod = {"train_plant": tp, "dagger_ab": da, "train_transfuser": tf}[entry]
  extra = ["--crop-px", "0", "--micro"] if entry == "train_transfuser" \
      else []
  argv = ["--towns", "Town02", "--eval-towns", "synth3", "Town02",
          "--results", str(tmp_path / "r.json"), "--out",
          str(tmp_path / "ck"), "--assets-root",
          str(tmp_path / "absent")] + extra
  if entry == "dagger_ab":
    argv.remove("--out")
    argv.remove(str(tmp_path / "ck"))
  with pytest.raises(OSError):
    mod.run(mod.parse_args(argv), device="cpu")
  assert not built and not (tmp_path / "r.json").exists()
  argv[argv.index("--assets-root") + 1] = root
  with pytest.raises(Stop):
    mod.run(mod.parse_args(argv), device="cpu")
  assert built == [("Town02", (9, 600, 360))]
  assert not (tmp_path / "r.json").exists()


def test_make_town_batch_synth_n_matches_jax():
  name = "synth5"
  kw = dict(batch=B, seed=3, n_vehicles=6, n_walkers=2, use_scenarios=True)
  j = j_sb.make_town_batch(j_tp.honest_cfg(16), name, **kw)
  t = scene_builder.make_town_batch(tp.honest_cfg(16), name, device="cpu",
                                    **kw)
  np.testing.assert_array_equal(t[0].raster, j[0].raster)
  _compare_batches(j[1:], t[1:], expect_scenarios=True)


def test_two_town_batch_matches_jax():
  """tests/test_multi_town.py's batch: two synthetic towns, two episodes
  each, on both packages' builders."""
  out = []
  for syn, build, compile_route, kw in (
      (j_syn, j_sb.build_batch, j_sb.compile_route, {}),
      (synthetic, scene_builder.build_batch, scene_builder.compile_route,
       {"device": "cpu"})):
    rng = np.random.default_rng(0)
    town_a = syn.make_town(n_x=3, n_y=3, block=100.0, seed=1)
    town_b = syn.make_town(n_x=4, n_y=3, block=120.0, seed=2)
    eps, town_idx = [], []
    for ti, t in enumerate((town_a, town_b)):
      for _ in range(2):
        xy, yaw = syn.sample_route_keypoints(t, rng, min_len_m=200.0)
        eps.append(compile_route(t, xy, yaw))
        town_idx.append(ti)
    out.append(build(tp.honest_cfg(16), [town_a, town_b], eps,
                     n_vehicles=3, n_walkers=1, town_of_episode=town_idx,
                     **kw))
  j, t = out
  assert t[0].layers.shape[0] == 2
  np.testing.assert_array_equal(t[2].town_id.numpy(), [0, 0, 1, 1])
  _compare_batches(j, t, expect_scenarios=False)
