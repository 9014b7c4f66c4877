"""Port parity: PlanT's dataset and training, torch vs JAX on the CPU.

The JAX package records 24 expert frames at B=2 on a synthetic scene,
with two vehicles parked at one spot ahead of each ego in every frame
(equal distances: the stable nearest-first sort must keep slot order),
and builds its PlanT dataset; the port builds its own from the bridged
frames. The training tests then start both sides from that dataset and
the same seeded weights (``load_flax_params``):

  * ``build_plant_dataset``: every field, ints equal, floats to 1e-5;
  * ``iterate_minibatches``: one seed gives JAX's batches and velocity
    dropout exactly;
  * ``plant_loss`` and its gradients (with estimated speed weights and a
    per-sample waypoint weight): losses to 1e-5 relative, gradients to
    1e-4 of the global norm and 1e-3 of a tensor's largest entry
    (attention key biases, zero in exact arithmetic, under 1e-6 of the
    largest gradient);
  * 3 steps of ``train_plant`` (AdamW, multistep, estimated weights,
    velocity dropout) and 2 Kendall steps from the same weights and seed:
    every logged loss to 1e-4 relative, the validation losses, and the
    final weights to 2e-5 (attention key biases, whose gradient is zero
    in exact arithmetic and whose Adam steps are float32 noise, to 3 lr);
  * ``plant_trainer``, the set-up ``train_plant`` drives, stepped by
    hand: the same losses, validation and weights, exactly;
  * the optimizer's learning rate at every update count through the
    multistep milestones, to optax's float32 rounding;
  * ``relabel_with_plant`` and ``estimate_speed_weights``.

JAX's ``train_plant(estimate_weights=True)`` rebinds its module global
``SPEED_WEIGHTS``; the tests restore it with ``monkeypatch``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG0
from carla_garage_tpu.models import plant as j_plant
from carla_garage_tpu.sim.datagen import collect_expert_frames
from carla_garage_tpu.sim.scene_builder import make_synthetic_batch
from carla_garage_tpu.train import plant_train as j_pt
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG0
from carla_garage_tpu_torch.convert import load_flax_params
from carla_garage_tpu_torch.models.plant import PlanT, micro_plant
from carla_garage_tpu_torch.sim.datagen import Frames
from carla_garage_tpu_torch.structs import Scene
from carla_garage_tpu_torch.train import plant_train as pt
from test_torch_port_eval import _random_params
from test_torch_port_scene import to_port

B, V = 2, 16
T = lambda a: torch.from_numpy(np.array(a))
JCFG = JCFG0.replace(sim=dataclasses.replace(JCFG0.sim, max_vehicles=V))
CFG = CFG0.replace(sim=dataclasses.replace(CFG0.sim, max_vehicles=V))
PCFG = micro_plant()


def close(got, want, rtol, atol, what):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else \
      np.asarray(got)
  want = np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  if want.dtype.kind in "biu":
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)
  else:
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def to_port_ds(ds) -> pt.PlantDataset:
  return pt.PlantDataset(**{
      f.name: None if getattr(ds, f.name) is None else T(getattr(ds, f.name))
      for f in dataclasses.fields(j_pt.PlantDataset)})


@pytest.fixture(scope="module")
def data():
  _, maps, lanes, scene, state = make_synthetic_batch(
      JCFG, batch=B, seed=7, n_vehicles=6, n_walkers=2)
  _, frames = jax.jit(lambda st: collect_expert_frames(
      JCFG, maps, lanes, scene, st, n_frames=24))(state)
  # vehicles 0 and 1 parked together 6 m ahead of the ego in every frame
  fwd = np.stack([np.cos(frames.ego_yaw), np.sin(frames.ego_yaw)], -1)
  spot = np.asarray(frames.ego_pos) + 6.0 * fwd
  vp, vy = np.array(frames.veh_pos), np.array(frames.veh_yaw)
  vs, vv = np.array(frames.veh_speed), np.array(frames.veh_valid)
  vp[:, :, 0] = vp[:, :, 1] = spot
  vy[:, :, 0], vy[:, :, 1] = frames.ego_yaw, np.asarray(frames.ego_yaw) + 0.5
  vs[:, :, 0], vs[:, :, 1] = 0.0, 4.0
  vv[:, :, :2] = True
  frames = frames.replace(veh_pos=jnp.asarray(vp), veh_yaw=jnp.asarray(vy),
                          veh_speed=jnp.asarray(vs),
                          veh_valid=jnp.asarray(vv))
  ds = j_pt.build_plant_dataset(JCFG, PCFG, frames, scene)
  return frames, scene, ds


@pytest.fixture(scope="module")
def weights():
  jm = j_plant.PlanT(PCFG)
  O, R = PCFG.max_objects, PCFG.num_route_points
  x = (np.zeros((1, O, 7), np.float32), np.zeros((1, O), np.int32),
       np.zeros((1, R, 2), np.float32)) + (np.zeros(1, np.float32),) * 4
  params = _random_params(jax.eval_shape(jm.init, jax.random.key(0), *x),
                          seed=9)
  return jm, params


def port_model(params) -> PlanT:
  return load_flax_params(PlanT(PCFG), jax.tree.map(np.asarray, params))


def test_build_plant_dataset_matches_jax(data):
  frames, scene, want = data
  got = pt.build_plant_dataset(CFG, PCFG, to_port(frames, Frames),
                               to_port(scene, Scene))
  assert len(got) == len(want) == 32
  for f in dataclasses.fields(j_pt.PlantDataset):
    w = getattr(want, f.name)
    if w is None:
      assert getattr(got, f.name) is None
      continue
    close(getattr(got, f.name), w, 0, 1e-5, f.name)
  # the tie: both parked vehicles, slot order, lead every sample
  assert torch.equal(got.boxes[:, 0, 0], got.boxes[:, 1, 0])
  assert bool((got.boxes[:, 0, 5] == 0.0).all())
  assert bool((got.boxes[:, 1, 5] == 4.0).all())
  assert bool((got.forecast_label != pt.IGNORE_INDEX).any())


def test_iterate_minibatches_matches_jax(data):
  ds = data[2]
  want = list(j_pt.iterate_minibatches(ds, 8, np.random.default_rng(3),
                                       epochs=2, velocity_dropout=0.5))
  got = list(pt.iterate_minibatches(to_port_ds(ds), 8,
                                    np.random.default_rng(3), epochs=2,
                                    velocity_dropout=0.5))
  assert len(got) == len(want) == 8
  for g, w in zip(got, want):
    assert set(g) == set(w)
    for k in w:
      close(g[k], np.asarray(w[k], g[k].numpy().dtype), 0, 0, k)
  assert any(bool((g["velocity"] == 0).any()) for g in got)
  with pytest.raises(ValueError, match="fewer than one batch"):
    next(pt.iterate_minibatches(to_port_ds(ds), 64,
                                np.random.default_rng(0)))


def test_plant_loss_and_gradients_match_jax(data, weights, monkeypatch):
  ds = data[2]
  jm, params = weights
  sw = j_pt.estimate_speed_weights(ds)
  assert sw == pt.estimate_speed_weights(to_port_ds(ds))
  monkeypatch.setattr(j_pt, "SPEED_WEIGHTS", sw)
  batch = {k: getattr(ds, k)[:16] for k in j_pt.BATCH_KEYS
           if getattr(ds, k) is not None}
  batch["wp_weight"] = np.r_[np.zeros(5), np.ones(11)].astype(np.float32)
  (_, aux), grads = jax.jit(jax.value_and_grad(
      lambda p: j_pt.plant_loss(jm, p, batch), has_aux=True))(params)
  model = port_model(params)
  loss, t_aux = pt.plant_loss(model, {k: T(v) for k, v in batch.items()},
                              speed_weights=sw)
  loss.backward()
  assert set(t_aux) == set(aux)
  for k in aux:
    close(t_aux[k], aux[k], 1e-5, 1e-6, k)
  want = port_model(grads)          # JAX's gradients in the port's layout
  g_t = {n: p.grad for n, p in model.named_parameters()}
  g_j = {n: p.detach() for n, p in want.named_parameters()}
  norm = sum(float((g ** 2).sum()) for g in g_j.values()) ** 0.5
  diff = sum(float(((g_t[n] - g) ** 2).sum()) for n, g in g_j.items())
  assert diff ** 0.5 < 1e-4 * norm
  gmax = max(float(g.abs().max()) for g in g_j.values())
  for n, g in g_j.items():
    if n.endswith("key.bias"):
      # zero in exact arithmetic (softmax ignores a per-key constant):
      # both sides hold float32 noise
      assert float(g_t[n].abs().max()) < 1e-6 * gmax, n
      continue
    close(g_t[n], g, 0,
          1e-3 * max(float(g.abs().max()), 1e-6), n)


def _compare_weights(model, j_params, lr):
  want = dict(port_model(j_params).named_parameters())
  for n, p in model.named_parameters():
    tol = 3 * lr if n.endswith("key.bias") else 2e-5
    close(p, want[n].detach(), 0, tol, n)


@pytest.mark.parametrize("kendall", [False, True])
def test_train_plant_matches_jax(data, weights, monkeypatch, kendall):
  ds = data[2]
  jm, params = weights
  monkeypatch.setattr(j_pt, "SPEED_WEIGHTS", j_pt.SPEED_WEIGHTS)
  kw = dict(steps=2 if kendall else 3, batch_size=8, lr=1e-3, seed=2,
            log_every=1, estimate_weights=not kendall,
            learn_loss_weights=kendall)
  _, j_params, j_hist = j_pt.train_plant(JCFG, PCFG, ds, params=params,
                                         **kw)
  sd = port_model(params).state_dict()
  model, hist = pt.train_plant(CFG, PCFG, to_port_ds(ds), params=sd, **kw)
  assert len(hist) == len(j_hist) == kw["steps"]
  assert "val_loss" in hist[-1]
  for h, jh in zip(hist, j_hist):
    assert set(h) == set(jh)
    for k in jh:
      assert abs(h[k] - jh[k]) <= 1e-4 * max(abs(jh[k]), 1.0), (k, h, jh)
  _compare_weights(model, j_params, kw["lr"])


def _random_ds():
  rng = np.random.default_rng(0)
  n, O, R = 40, PCFG.max_objects, PCFG.num_route_points
  ds = pt.PlantDataset(
      boxes=T(rng.normal(size=(n, O, 7)).astype(np.float32)),
      box_types=T(rng.integers(0, 4, (n, O)).astype(np.int32)),
      route=T(rng.normal(size=(n, R, 2)).astype(np.float32)),
      light=T(rng.integers(0, 2, n).astype(np.float32)),
      stop=torch.zeros(n), junction=torch.zeros(n),
      velocity=T(rng.uniform(0, 8, n).astype(np.float32)),
      target_point=T(rng.normal(size=(n, 2)).astype(np.float32)),
      wp_label=T(rng.normal(size=(n, 8, 2)).astype(np.float32)),
      speed_label=T(rng.integers(0, 4, n).astype(np.int32)),
      ckpt_label=T(rng.normal(size=(n, R, 2)).astype(np.float32)),
      forecast_label=T(rng.integers(-1, 4, (n, O, 7)).astype(np.int32)))
  return ds


def test_train_plant_from_seed_runs():
  """No params: the model is initialized from the seed; two runs agree."""
  ds = _random_ds()
  runs = [pt.train_plant(CFG, PCFG, ds, steps=2, batch_size=16, seed=4,
                         log_every=1) for _ in range(2)]
  assert runs[0][1] == runs[1][1] and np.isfinite(runs[0][1][-1]["loss"])
  for a, b in zip(runs[0][0].parameters(), runs[1][0].parameters()):
    assert torch.equal(a, b)
  with pytest.raises(ValueError, match="fewer than one batch"):
    pt.train_plant(CFG, PCFG, ds, steps=1, batch_size=64)


def test_plant_trainer_steps_as_train_plant():
  """``plant_trainer``'s steps and validation are ``train_plant``'s."""
  ds = _random_ds()
  kw = dict(batch_size=16, seed=3, estimate_weights=True)
  model, hist = pt.train_plant(CFG, PCFG, ds, steps=3, log_every=1, **kw)
  tr = pt.plant_trainer(CFG, PCFG, ds, 3, **kw)
  auxes = [{k: float(v) for k, v in tr.step().items()} for _ in range(3)]
  val = tr.validate()
  assert auxes[:2] == hist[:2] and {**auxes[2], **val} == hist[2]
  assert set(val) == {f"val_{k}" for k in auxes[0]}
  for a, b in zip(model.parameters(), tr.model.parameters()):
    assert torch.equal(a, b)


def test_learning_rate_follows_optax_schedule():
  steps, lr = 50, 3e-4
  sched_j = j_pt.make_schedule("multistep", lr, steps)
  model = PlanT(PCFG)
  opt, sched = pt.make_optimizer(model, lr, steps, "multistep")
  assert len(opt.param_groups[0]["params"]) == len(list(model.parameters()))
  milestones = (int(0.64 * steps), int(0.85 * steps))
  for count in range(steps + 2):
    # the rate of the update that follows `count` applied updates
    # optax's schedule is float32
    assert abs(opt.param_groups[0]["lr"] - float(sched_j(count))) <= \
        1e-7 * lr, count
    if count in milestones:
      assert float(sched_j(count)) < float(sched_j(count - 1))
    opt.step()
    sched.step()


def test_relabel_and_speed_weights_match_jax(data, weights):
  ds = data[2]
  jm, params = weights
  want = j_pt.relabel_with_plant(jm, params, ds, batch_size=8)
  got = pt.relabel_with_plant(port_model(params), to_port_ds(ds),
                              batch_size=8)
  close(got.wp_label, want.wp_label, 0, 1e-5, "wp_label")
  close(got.speed_label, want.speed_label, 0, 0, "speed_label")
  close(got.boxes, ds.boxes, 0, 0, "boxes untouched")
  assert not np.array_equal(want.speed_label, ds.speed_label) or \
      not np.allclose(want.wp_label, ds.wp_label)
  assert pt.estimate_speed_weights(got) == j_pt.estimate_speed_weights(want)
