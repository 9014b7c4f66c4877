"""Port parity: data-parallel training (``mesh=`` of
``make_transfuser_train_step`` and PlanT's ``make_train_step``, ZeRO-1
from ``make_optimizer``) against the JAX package's meshed steps and the
port's one-process step, on the CPU.

The micro TransFuser++ at ``tests/test_torch_port_train.py``'s reduced
sensor sizes on B=4 episodes, two micro-batches, float32. The JAX step
runs once on a 2-device mesh (scene and frames sharded over the
episodes, parameters replicated; its Pallas renderers in interpret mode);
the port's on two gloo ranks (``parallel/launch.spawn``, torch on one
thread each) with JAX's draws, each rank on its two episodes. The shards
hold different valid-sample weights (episode 3 is done at the frames
used) and different CenterNet box counts (traffic placed around episodes
0-2 only), so a rank-local normalizer would give another gradient. Held:
the losses and aux losses against JAX's meshed step (the port train
test's tolerance), the all-reduced gradients against the one-process
step (1e-5 of their norm) and against JAX's, ZeRO-1 AdamW against plain
AdamW, the Kendall log-variances' gradients with the regularizer counted
once, and the meshed eval step's losses, mIoU and confusion against
JAX's meshed eval step and one process. PlanT likewise, on a batch whose
halves hold different waypoint weights and forecast-label counts.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import carla_garage_tpu.sensors.camera as j_camera
import carla_garage_tpu.sensors.lidar as j_lidar
from carla_garage_tpu.models import plant as j_plant
from carla_garage_tpu.models import transfuser as jtf
from carla_garage_tpu.parallel import mesh as j_mesh
from carla_garage_tpu.sensors import raycast as j_rc
from carla_garage_tpu.sim.datagen import collect_expert_frames
from carla_garage_tpu.sim.scene_builder import make_synthetic_batch
from carla_garage_tpu.train import plant_train as j_pt
from carla_garage_tpu.train import schedules as j_sched
from carla_garage_tpu.train import transfuser_train as j_tt
from carla_garage_tpu_torch.convert import load_flax_params
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.models.plant import PlanT, PlanTConfig
from carla_garage_tpu_torch.parallel import launch, workers
from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
from carla_garage_tpu_torch.sensors.lidar import full_lidar_grid
from carla_garage_tpu_torch.sim.datagen import Frames
from carla_garage_tpu_torch.train import plant_train as pt
from carla_garage_tpu_torch.train import transfuser_train as tt
from test_torch_port_scene import jax_batch_to_port, to_port
from test_torch_port_train import (CFG, JCFG, TCFG, close,
                                   with_traffic_around_ego)

B, F_IDX, LR = 4, [1, 3], 1e-3
T = lambda a: torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core): a torch
  thread pool of its own per process would oversubscribe the cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def batch_draws(key, n_lidar):
  """The draws JAX's make_batch takes from its key, for B episodes."""
  return {"lidar": T(jax.random.uniform(key, (B, n_lidar))),
          "speed_drop": T(jax.random.bernoulli(jax.random.fold_in(key, 7),
                                               0.15, (B,)))}


def unequal_shards(frames):
  """Traffic around episodes 0-2 (episode 2 keeps only the first of the
  placed vehicles), none around episode 3, and episode 3 done at every
  frame index of the step."""
  placed = with_traffic_around_ego(frames)
  keep = np.array([1, 1, 1, 0], bool)[None, :, None]
  vv = np.where(keep, np.asarray(placed.veh_valid),
                np.asarray(frames.veh_valid))
  vv[:, 2, 1:4] = np.asarray(frames.veh_valid)[:, 2, 1:4]
  wv = np.where(keep, np.asarray(placed.wlk_valid),
                np.asarray(frames.wlk_valid))
  wv[:, 2] = np.asarray(frames.wlk_valid)[:, 2]
  alive = np.array(frames.alive)
  alive[F_IDX, 3] = False
  return placed.replace(veh_valid=jnp.asarray(vv), wlk_valid=jnp.asarray(wv),
                        alive=jnp.asarray(alive))


@pytest.fixture(scope="module")
def setup():
  mp = pytest.MonkeyPatch()
  pallas = functools.partial(j_rc.cast_rays, use_pallas=True)
  mp.setattr(j_camera, "cast_rays", pallas)
  mp.setattr(j_lidar, "cast_rays", pallas)
  _, maps, lanes, scene, state = make_synthetic_batch(
      JCFG, batch=B, seed=7, n_vehicles=6, n_walkers=1)
  _, frames = jax.jit(lambda st: collect_expert_frames(
      JCFG, maps, lanes, scene, st, n_frames=12))(state)
  frames = unequal_shards(frames)
  cam = camera_ray_grid(CFG, scale=8)
  lid = full_lidar_grid(CFG, decimate=16)
  jm = jtf.LidarCenterNet(TCFG)
  zeros = [np.zeros(s, np.float32) for s in
           ((2, TCFG.img_h, TCFG.img_w, 3),
            (2, TCFG.lidar_h, TCFG.lidar_w, 2), (2, 2), (2, 6), (2,))]
  params = jax.jit(jm.init)(jax.random.key(0), *zeros)
  np_params = jax.tree.map(np.asarray, params)
  t_maps, _, t_scene, _ = jax_batch_to_port(maps, lanes, scene, state)
  rng = jax.random.key(11)
  n_lidar = lid.shape[0] * lid.shape[1]
  draws = [batch_draws(jax.random.split(r, 1)[0], n_lidar)
           for r in jax.random.split(rng, len(F_IDX))]
  yield dict(maps=maps, scene=scene, frames=frames, cam=cam, lid=lid, jm=jm,
             np_params=np_params, rng=rng, draws=draws, t_maps=t_maps,
             t_scene=t_scene, t_frames=to_port(frames, Frames))
  mp.undo()


def port_model(np_params):
  tc = ttf.TransfuserConfig(**dataclasses.asdict(TCFG))
  return load_flax_params(ttf.LidarCenterNet(tc), np_params)


@pytest.fixture(scope="module")
def jax_meshed(setup):
  """JAX's train step on a 2-device mesh with optax.sgd(1.0) (the new
  parameters are the old minus the gradient), and its eval step on the
  same mesh, inputs and key from the same parameters."""
  s = setup
  jm_ = j_mesh.make_mesh(2)
  tx = optax.sgd(1.0)
  step_fn, eval_fn, _ = j_tt.make_transfuser_train_step(
      JCFG, TCFG, s["jm"], tx, s["maps"], s["scene"], s["frames"], s["cam"],
      s["lid"])
  by_episode = NamedSharding(jm_, P(None, "dp"))
  rep = NamedSharding(jm_, P())
  frames = jax.tree.map(
      lambda x: jax.device_put(x, by_episode if x.ndim >= 2 and
                               x.shape[1] == B else rep), s["frames"])
  scene = j_mesh.shard_leading(jm_, s["scene"], B)
  assert len(scene.route.num_valid.sharding.device_set) == 2
  put = lambda: j_mesh.replicate(jm_, jax.tree.map(jnp.array,
                                                   s["np_params"]))
  maps = j_mesh.replicate(jm_, s["maps"])
  ev = eval_fn(put(), jnp.asarray(F_IDX), s["rng"], maps, scene, frames)
  params = put()
  new, _, aux = step_fn(params, tx.init(params), jnp.asarray(F_IDX),
                        s["rng"], maps, scene, frames)
  return dict(new=jax.tree.map(np.asarray, new),
              aux={k: np.asarray(v) for k, v in aux.items()},
              eval={k: np.asarray(v) for k, v in ev.items()})


def payload(setup, runs):
  s = setup
  return dict(cfg=CFG, tcfg=ttf.TransfuserConfig(**dataclasses.asdict(TCFG)),
              state_dict=port_model(s["np_params"]).state_dict(),
              maps=s["t_maps"], scene=s["t_scene"], frames=s["t_frames"],
              camera_grid=s["cam"], lidar_grid=s["lid"], f_idx=F_IDX,
              draws=s["draws"], runs=runs)


RUNS = [dict(optimizer="sgd", lr=1.0),
        dict(optimizer="zero1", lr=LR, clip_norm=1.0, schedule="multistep"),
        dict(optimizer="sgd", lr=1.0, log_vars=True)]


@pytest.fixture(scope="module")
def port_runs(setup, tmp_path_factory):
  """(rank 0's and rank 1's results, the one-process results) of RUNS;
  one process steps plain AdamW where the ranks step ZeRO-1."""
  d = tmp_path_factory.mktemp("dp_train")
  torch.save(payload(setup, RUNS), d / "dp.pt")
  one_runs = [dict(r, optimizer="adamw") if r["optimizer"] == "zero1"
              else r for r in RUNS]
  torch.save(payload(setup, one_runs), d / "one.pt")
  ranks = launch.spawn(workers.transfuser_step_rank, 2, "gloo", "cpu",
                       str(d / "dp.pt"), tmpdir=str(d), threads=1)
  return ranks, workers.transfuser_step_rank(None, str(d / "one.pt"),
                                             device="cpu")


def rel_err(a: dict, b: dict) -> float:
  """|a - b| over |b|, over every tensor of two dicts with the same keys."""
  assert set(a) == set(b)
  norm = sum(float((b[k].double() ** 2).sum()) for k in b) ** 0.5
  diff = sum(float(((a[k].double() - b[k].double()) ** 2).sum())
             for k in b) ** 0.5
  return diff / norm


def test_shards_hold_unequal_valid_counts(setup):
  """The premise: per micro-batch, the two shards' sample-weight sums and
  CenterNet mask counts differ."""
  s = setup
  lid = torch.as_tensor(s["lid"]).reshape(-1, 3)
  sw_sums, masks = [], []
  for f, d in zip(F_IDX, s["draws"]):
    b = tt.make_train_batch(CFG, TCFG, s["t_maps"], s["t_scene"],
                            s["t_frames"], f, torch.as_tensor(s["cam"]),
                            lid, d)
    sw = b["sample_w"]
    m = (b["centernet"]["mask"] & (sw[:, None] > 0)).sum(1)
    sw_sums.append((float(sw[:2].sum()), float(sw[2:].sum())))
    masks.append((int(m[:2].sum()), int(m[2:].sum())))
  assert all(a != b for a, b in sw_sums), sw_sums
  assert all(a != b for a, b in masks), masks


def test_dp_losses_match_jax_meshed_step(port_runs, jax_meshed):
  ranks, _ = port_runs
  got, want = ranks[0][0]["aux"], jax_meshed["aux"]
  assert set(got) == set(want)
  for k, v in want.items():
    close(got[k], v, 2e-4, 1e-5, k)
  for k in got:
    assert torch.equal(got[k], ranks[1][0]["aux"][k]), k


def test_dp_gradients_match_one_process_and_jax(setup, port_runs,
                                                jax_meshed):
  ranks, one = port_runs
  g0, g1, g_one = (r[0]["grads"] for r in (ranks[0], ranks[1], one))
  assert set(g0) == set(g1)
  for k in g0:
    assert torch.equal(g0[k], g1[k]), k
  err = rel_err(g0, g_one)
  assert err < 1e-5, err
  for k, v in one[0]["aux"].items():
    close(ranks[0][0]["aux"][k], v, 1e-5, 1e-6, f"one process {k}")
  # against JAX's meshed gradients (sgd 1.0: the parameters after the
  # step) to 1e-3 of their norm, the one-process port test's bound; its
  # per-tensor bound is held there, at B=2 (here the first image stage's
  # squeeze-excite weights, whose gradients are 1e-3 of the largest,
  # differ by 7% of their own largest entry between the float32 sides)
  old = {n: p.detach() for n, p in
         port_model(setup["np_params"]).named_parameters()}
  new = {n: p.detach() for n, p in
         port_model(jax_meshed["new"]).named_parameters()}
  err = rel_err(g0, {n: old[n] - new[n] for n in old})
  print(f"gradients against JAX's meshed step: {err:.3g} of the norm")
  assert err < 1e-3, err


def test_zero1_adamw_step_matches_adamw(port_runs):
  """ZeRO-1 over two ranks against one process's plain AdamW (clip 1.0,
  the multistep schedule): the same clipped gradients, parameters bit-equal
  across the ranks and within 2 lr of one process's (AdamW turns float32
  noise in near-zero gradients into steps of about lr), and the optimizer
  state split between the ranks."""
  ranks, one = port_runs
  r0, r1, o = ranks[0][1], ranks[1][1], one[1]
  assert rel_err(r0["grads"], o["grads"]) < 1e-5
  for k in r0["params"]:
    assert torch.equal(r0["params"][k], r1["params"][k]), k
    diff = float((r0["params"][k] - o["params"][k]).abs().max())
    assert diff <= 2 * LR, (k, diff)
  # the weights before the step: the SGD(1.0) run's after it plus its
  # gradient
  old = {k: ranks[0][0]["params"][k] + ranks[0][0]["grads"][k]
         for k in o["params"]}
  moved = max(float((o["params"][k] - old[k]).abs().max()) for k in old)
  assert moved > 0.5 * LR
  assert r0["opt_bytes"] + r1["opt_bytes"] == o["opt_bytes"]
  assert max(r0["opt_bytes"], r1["opt_bytes"]) < 0.6 * o["opt_bytes"]


def test_kendall_regularizer_counted_once(port_runs, jax_meshed):
  """Each rank adds s / 2, so the log-variances' all-reduced gradient is
  one process's, and JAX's gradient of uncertainty_weighted_total at the
  meshed step's losses (log_vars start at 0: exp(-s) = 1)."""
  ranks, one = port_runs
  got, want = ranks[0][2]["log_var_grads"], one[2]["log_var_grads"]
  # the micro model has no waypoint head: no "wp" loss, no gradient
  assert set(got) == set(tt.LOSS_WEIGHTS) - {"wp"}
  for k in got:
    close(got[k], want[k], 1e-5, 1e-6, f"log_var {k}")
  j_losses = {k[len("loss_"):]: jnp.asarray(v)
              for k, v in jax_meshed["aux"].items() if k != "loss"}
  keys = tuple(tt.LOSS_WEIGHTS)
  g = jax.grad(lambda lv: j_sched.uncertainty_weighted_total(
      j_losses, lv))(j_sched.init_log_vars(keys))
  for k in got:
    close(got[k], g[k], 1e-4, 1e-5, f"jax log_var {k}")
  close(ranks[0][2]["aux"]["loss"], one[2]["aux"]["loss"], 1e-5, 1e-6,
        "total")


def test_eval_step_under_a_mesh_matches_jax_and_one_process(setup, tmp_path,
                                                          jax_meshed):
  """eval_step on two gloo ranks, each on its two episodes (unequal
  sample weights and box counts), returns the global batch's losses,
  mIoU, confusion and checkpoint angle error: those of JAX's eval step
  on the 2-device mesh and of one port process. JAX's eval renders frame
  k with key k of its key's split, not with the train step's nested one."""
  s = setup
  n_lidar = s["lid"].shape[0] * s["lid"].shape[1]
  draws = [batch_draws(r, n_lidar)
           for r in jax.random.split(s["rng"], len(F_IDX))]
  torch.save(dict(payload(setup, []), draws=draws), tmp_path / "eval.pt")
  ranks = launch.spawn(workers.transfuser_eval_rank, 2, "gloo", "cpu",
                       str(tmp_path / "eval.pt"), tmpdir=str(tmp_path),
                       threads=1)
  one = workers.transfuser_eval_rank(None, str(tmp_path / "eval.pt"),
                                     device="cpu")
  want = jax_meshed["eval"]
  assert set(ranks[0]) == set(one) == set(want)
  for k in want:
    assert torch.equal(ranks[0][k], ranks[1][k]), k
  assert torch.equal(ranks[0]["confusion"], one["confusion"])
  np.testing.assert_array_equal(ranks[0]["confusion"].numpy(),
                                want["confusion"])
  alive = s["t_frames"].alive[F_IDX]
  assert int(one["confusion"].sum()) == int(alive.sum()) < alive.numel()
  for k in set(want) - {"confusion"}:
    for ref, what in ((one[k], "one process"), (want[k], "jax")):
      got, ref = float(ranks[0][k]), float(ref)
      # mIoU within 1e-6, the losses and the angle error within 1e-5 of
      # their value
      bar = 1e-6 if k.startswith("miou") else 1e-5 * abs(ref)
      assert abs(got - ref) <= bar, (what, k, got, ref)


PCFG = j_plant.micro_plant()


def plant_batch(n=16):
  """A sample batch from a numpy seed whose halves hold different
  waypoint weights and forecast-label counts."""
  rng = np.random.default_rng(3)
  O, R = PCFG.max_objects, PCFG.num_route_points
  fc = rng.integers(0, 16, (n, O, 7)).astype(np.int32)
  ignore = rng.uniform(size=(n, O, 7)) < np.r_[np.full(n // 2, 0.7),
                                                np.full(n // 2, 0.2)][:, None,
                                                                      None]
  fc[ignore] = j_pt.IGNORE_INDEX
  return dict(
      boxes=rng.normal(size=(n, O, 7)).astype(np.float32),
      box_types=rng.integers(0, 4, (n, O)).astype(np.int32),
      route=rng.normal(size=(n, R, 2)).astype(np.float32),
      light=rng.integers(0, 2, n).astype(np.float32),
      stop=rng.integers(0, 2, n).astype(np.float32),
      junction=rng.integers(0, 2, n).astype(np.float32),
      velocity=rng.uniform(0, 8, n).astype(np.float32),
      wp_label=rng.normal(size=(n, PCFG.pred_len, 2)).astype(np.float32),
      speed_label=rng.integers(0, 4, n).astype(np.int32),
      ckpt_label=rng.normal(size=(n, R, 2)).astype(np.float32),
      forecast_label=fc,
      wp_weight=np.r_[0, 0, 0, 1, 1, 1, 1, 1, np.ones(n // 2)].astype(
          np.float32))


def test_plant_dp_step_matches_one_process_and_jax(tmp_path):
  batch = plant_batch()
  half = len(batch["wp_weight"]) // 2
  ok = batch["forecast_label"] != j_pt.IGNORE_INDEX
  assert batch["wp_weight"][:half].sum() != batch["wp_weight"][half:].sum()
  assert ok[:half].sum() != ok[half:].sum()
  jm = j_plant.PlanT(PCFG)
  params = jax.jit(jm.init)(
      jax.random.key(0), batch["boxes"][:2], batch["box_types"][:2],
      batch["route"][:2], batch["light"][:2], batch["stop"][:2],
      batch["junction"][:2], batch["velocity"][:2])
  (_, j_aux), j_grads = jax.jit(jax.value_and_grad(
      lambda p: j_pt.plant_loss(jm, p, batch), has_aux=True))(params)
  to_port_model = lambda p: load_flax_params(
      PlanT(PlanTConfig(**dataclasses.asdict(PCFG))),
      jax.tree.map(np.asarray, p))
  runs = [dict(lr=1.0), dict(lr=1.0, log_vars=True)]
  torch.save(dict(pcfg=PlanTConfig(**dataclasses.asdict(PCFG)),
                  state_dict=to_port_model(params).state_dict(),
                  batch={k: T(v) for k, v in batch.items()},
                  speed_weights=pt.SPEED_WEIGHTS, runs=runs),
             tmp_path / "plant.pt")
  ranks = launch.spawn(workers.plant_step_rank, 2, "gloo", "cpu",
                       str(tmp_path / "plant.pt"), tmpdir=str(tmp_path),
                       threads=1)
  one = workers.plant_step_rank(None, str(tmp_path / "plant.pt"),
                                device="cpu")
  for run in range(2):
    r0, r1, o = ranks[0][run], ranks[1][run], one[run]
    for k in o["aux"]:
      assert torch.equal(r0["aux"][k], r1["aux"][k]), k
      close(r0["aux"][k], o["aux"][k], 1e-5, 1e-6, f"one process {k}")
    assert rel_err(r0["grads"], o["grads"]) < 1e-5
    for k in o["log_var_grads"]:
      close(r0["log_var_grads"][k], o["log_var_grads"][k], 1e-5, 1e-6,
            f"log_var {k}")
  assert set(ranks[0][1]["log_var_grads"]) == set(pt.LOSS_KEYS)
  for k, v in j_aux.items():
    close(ranks[0][0]["aux"][k], v, 1e-5, 1e-6, f"jax {k}")
  want = {n: p.detach() for n, p in
          to_port_model(j_grads).named_parameters()}
  assert rel_err(ranks[0][0]["grads"], want) < 1e-4
