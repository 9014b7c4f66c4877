"""Port parity: TransFuser++ training, torch vs JAX on the CPU.

The micro model at the reduced sensor sizes of
``tests/test_transfuser_pipeline.py`` (128x128 BEV, 32x128 camera; a
16x-decimated full LiDAR sweep) on two episodes. The JAX package collects
12 expert frames, with traffic placed around the ego so that detection
targets exist; both sides train on them from the same weights
(``load_flax_params``) and the same draws: the JAX step's LiDAR-dropoff
and speed-dropout draws (``split(rng, K)``, then ``split(r, 1)[0]`` per
micro-batch, transfuser_train.py:344, :388; uniform for the LiDAR,
``bernoulli(fold_in(key, 7), 0.15)`` for the speed) are replayed into the
port. The JAX renderers take their Pallas path (interpret mode), as the
port always takes its kernels' path. Everything runs in float32.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import carla_garage_tpu.sensors.camera as j_camera
import carla_garage_tpu.sensors.lidar as j_lidar
from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG0
from carla_garage_tpu.models import transfuser as jtf
from carla_garage_tpu.ops import detection as j_det
from carla_garage_tpu.ops import losses as j_losses
from carla_garage_tpu.sensors import raycast as j_rc
from carla_garage_tpu.sim.datagen import collect_expert_frames
from carla_garage_tpu.sim.scene_builder import make_synthetic_batch
from carla_garage_tpu.train import plant_train as j_plant
from carla_garage_tpu.train import schedules as j_sched
from carla_garage_tpu.train import transfuser_train as j_tt
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG0
from carla_garage_tpu_torch.convert import load_flax_params
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.ops import detection as det
from carla_garage_tpu_torch.ops import losses
from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
from carla_garage_tpu_torch.sensors.lidar import full_lidar_grid
from carla_garage_tpu_torch.sim.datagen import Frames
from carla_garage_tpu_torch.structs import tree_map
from carla_garage_tpu_torch.train import schedules
from carla_garage_tpu_torch.train import transfuser_train as tt
from test_torch_port_scene import jax_batch_to_port, to_port

B = 2
T = lambda a: torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core): a torch
  thread pool of its own per process would oversubscribe the cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def _reduced(cfg):
  return cfg.replace(sensor=dataclasses.replace(
      cfg.sensor, lidar_resolution_width=128, lidar_resolution_height=128))


JCFG, CFG = _reduced(JCFG0), _reduced(CFG0)
TCFG = dataclasses.replace(jtf.micro_config(), img_h=32, img_w=128,
                           lidar_h=128, lidar_w=128, img_anchors=(1, 4),
                           lidar_anchors=(4, 4))


def close(got, want, rtol, atol, what):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  if want.dtype.kind in "biu":
    np.testing.assert_array_equal(got, want, err_msg=what)
  else:
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def batch_draws(key, n_lidar):
  """The draws JAX's make_batch takes from its key."""
  return {"lidar": T(jax.random.uniform(key, (B, n_lidar))),
          "speed_drop": T(jax.random.bernoulli(jax.random.fold_in(key, 7),
                                               0.15, (B,)))}


def with_traffic_around_ego(frames):
  """Recorded frames with four vehicles and a walker placed around the ego
  in every frame (the synthetic town's traffic is sparse), so that the
  LiDAR sees them and the CenterNet targets hold boxes."""
  fw = np.asarray(frames.ego_yaw)
  c, s_ = np.cos(fw), np.sin(fw)
  ego = np.asarray(frames.ego_pos)

  def place(dx, dy):
    return ego + np.stack([c * dx - s_ * dy, s_ * dx + c * dy], -1)

  vp = np.array(frames.veh_pos)
  vy, ve = np.array(frames.veh_yaw), np.array(frames.veh_extent)
  vv = np.array(frames.veh_valid)
  for v, (dx, dy, dyaw) in enumerate([(9.0, 0.5, 0.0), (-11.0, 3.5, 0.3),
                                      (6.0, -7.0, 1.4), (21.0, 4.0, -2.0)]):
    vp[:, :, v] = place(dx, dy)
    vy[:, :, v] = fw + dyaw
    ve[:, :, v] = (2.3, 0.95)
    vv[:, :, v] = True
  wp, wv = np.array(frames.wlk_pos), np.array(frames.wlk_valid)
  wp[:, :, 0] = place(5.0, 3.0)
  wv[:, :, 0] = True
  f = jnp.asarray
  return frames.replace(veh_pos=f(vp), veh_yaw=f(vy), veh_extent=f(ve),
                        veh_valid=f(vv), wlk_pos=f(wp), wlk_valid=f(wv))


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
  frames = with_traffic_around_ego(frames)
  cam = camera_ray_grid(CFG, scale=8)
  lid = full_lidar_grid(CFG, decimate=16)
  jm = jtf.LidarCenterNet(TCFG)
  zeros = [np.zeros(s, np.float32) for s in
           ((B, TCFG.img_h, TCFG.img_w, 3),
            (B, TCFG.lidar_h, TCFG.lidar_w, 2), (B, 2), (B, 6), (B,))]
  params = jax.jit(jm.init)(jax.random.key(0), *zeros)
  np_params = jax.tree.map(np.asarray, params)
  t_maps, _, t_scene, _ = jax_batch_to_port(maps, lanes, scene, state)
  yield dict(maps=maps, scene=scene, frames=frames, cam=cam, lid=lid,
             jm=jm, params=params, np_params=np_params,
             n_lidar=lid.shape[0] * lid.shape[1],
             t_maps=t_maps, t_scene=t_scene,
             t_frames=to_port(frames, Frames))
  mp.undo()


def port_model(np_params):
  tc = ttf.TransfuserConfig(**dataclasses.asdict(TCFG))
  return load_flax_params(ttf.LidarCenterNet(tc), np_params)


def test_detection_targets_match_jax():
  rng = np.random.default_rng(0)
  hw = rng.uniform(0.5, 12.0, (2, 20)).astype(np.float32)
  close(det.gaussian_radius(T(hw[0]), T(hw[1])),
        j_det.gaussian_radius(hw[0], hw[1]), 1e-6, 1e-6, "radius")
  centers = rng.uniform(-3, 35, (20, 2)).astype(np.float32)
  radii = rng.uniform(2, 6, 20).astype(np.float32)
  valid = rng.uniform(size=20) > 0.3
  cls = rng.integers(0, 4, 20).astype(np.int32)
  want = j_det.splat_gaussian_heatmap(32, 32, centers, radii, valid, cls, 4)
  got = det.splat_gaussian_heatmap(32, 32, T(centers), T(radii), T(valid),
                                   T(cls), 4)
  # exp of two libraries: a few ulps of values in [0, 1]
  close(got, want, 1e-6, 1e-6, "heatmap")
  assert float(got.max()) == 1.0
  pred = rng.uniform(0.01, 0.99, (2, 32, 32, 4)).astype(np.float32)
  close(det.gaussian_focal_loss(T(pred), got[None].expand(2, -1, -1, -1)),
        j_det.gaussian_focal_loss(pred, np.asarray(want)[None]), 1e-5, 1e-7,
        "focal")


def test_losses_match_jax():
  rng = np.random.default_rng(1)
  logits = rng.normal(size=(3, 5, 4)).astype(np.float32)
  labels = rng.integers(0, 4, (3, 5)).astype(np.int32)
  sw = rng.uniform(0, 1, 3).astype(np.float32)
  w = (0.5, 2.0, 1.0, 0.7)
  for kw in ({}, dict(weights=w, label_smoothing=0.1, sample_weight=sw),
             dict(sample_weight=sw)):
    tkw = {k: T(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    close(losses.cross_entropy(T(logits), T(labels), **tkw),
          j_losses.cross_entropy(logits, labels, **kw), 1e-6, 1e-6,
          f"ce {sorted(kw)}")
  for kw in ({}, dict(weights=w)):
    close(losses.focal_ce(T(logits), T(labels), **kw),
          j_losses.focal_ce(logits, labels, **kw), 1e-6, 1e-6, "focal_ce")
  mask = rng.uniform(size=(3, 5)) > 0.5
  close(losses.l1_masked(T(logits), T(logits[::-1].copy()), T(mask)),
        j_losses.l1_masked(logits, logits[::-1], mask), 1e-6, 1e-6, "l1")
  # labels outside the class range give zero rows, as jax.nn.one_hot
  close(losses.one_hot(T(np.array([0, 3, 4, -1])), 4),
        jax.nn.one_hot(np.array([0, 3, 4, -1]), 4), 0, 0, "one_hot")


def test_render_frame_batch_and_targets_match_jax(setup):
  s = setup
  key = jax.random.key(5)
  want = j_tt.render_frame_batch(JCFG, s["maps"], s["scene"], s["frames"], 9,
                                 s["cam"], s["lid"], key)
  got = tt.render_frame_batch(
      CFG, s["t_maps"], s["t_scene"], s["t_frames"], 9, s["cam"], s["lid"],
      uniform=T(jax.random.uniform(key, (B, s["n_lidar"]))))
  assert set(got) == set(want)
  for k, w in want.items():
    # sin/cos and ray-box divisions of two libraries: ~1e-5 of depths up
    # to 85 m; classes, counts and masks equal
    close(got[k], w, 1e-4, 1e-4, k)
  assert float(got["lidar_bev"].sum()) > 0
  assert bool(got["obj_valid"].any())

  j_batch = dict(want)
  t_batch = dict(got)
  grid = (TCFG.lidar_h // 4, TCFG.lidar_w // 4)
  jt = j_tt.centernet_targets(JCFG, TCFG, j_batch, grid)
  tgt = tt.centernet_targets(CFG, TCFG, t_batch, grid)
  assert set(jt) == set(tgt)
  for k in jt:
    close(tgt[k], jt[k], 1e-5, 1e-5, f"centernet/{k}")
  assert bool(tgt["mask"].any())


def jax_step(setup, tx):
  s = setup
  step_fn, eval_fn, _ = j_tt.make_transfuser_train_step(
      JCFG, TCFG, s["jm"], tx, s["maps"], s["scene"], s["frames"], s["cam"],
      s["lid"])
  return step_fn, eval_fn


@pytest.fixture(scope="module")
def jax_train(setup):
  """One JAX train step with optax.sgd(1.0): params - new params is the
  gradient."""
  s = setup
  tx = optax.sgd(1.0)
  step_fn, _ = jax_step(s, tx)
  f_idx = np.array([1, 3], np.int32)
  rng = jax.random.key(11)
  params = jax.tree.map(jnp.array, s["np_params"])
  new, _, aux = step_fn(params, tx.init(params), jnp.asarray(f_idx), rng,
                        s["maps"], s["scene"], s["frames"])
  draws = [batch_draws(jax.random.split(r, 1)[0], s["n_lidar"])
           for r in jax.random.split(rng, len(f_idx))]
  return dict(new=jax.tree.map(np.asarray, new),
              aux={k: np.asarray(v) for k, v in aux.items()},
              f_idx=f_idx.tolist(), draws=draws)


def port_step(setup, jt, log_vars=None, freeze=False):
  s = setup
  model = port_model(s["np_params"])
  params = tt.trainable_params(model, freeze)
  opt = torch.optim.SGD(params + list((log_vars or {}).values()), lr=1.0)
  step, _, _ = tt.make_transfuser_train_step(
      CFG, TCFG, model, opt, s["t_maps"], s["t_scene"], s["t_frames"],
      s["cam"], s["lid"], log_vars=log_vars)
  aux = step(jt["f_idx"], draws=jt["draws"])
  return model, aux


def assert_grads_close(model, old, want_new):
  """Gradients (old - new under sgd 1.0) agree to 1e-3 of their global
  norm and each tensor to 2e-2 of its largest entry. Against a float64
  run of the port on the same batch, the float32 gradients of the port
  are off by 2.0e-4 of the global norm (3e-3 of a tensor at worst) and
  JAX's by 2.5e-4 (1.2e-2 at worst, the first fusion stage): the f32
  convolutions, GroupNorm moments and attention sums of each library round
  differently through about 30 layers. Attention key biases have a zero
  gradient in exact arithmetic (a shift common to a query's logits leaves
  its softmax unchanged): both sides must give ~0 there."""
  new = dict(model.named_parameters())
  g = {n: (p_old - new[n].detach()).numpy() for n, p_old in old.items()}
  g_want = {n: (p_old - want_new[n]).numpy() for n, p_old in old.items()}
  norm = np.sqrt(sum(float((w ** 2).sum()) for w in g_want.values()))
  diff = np.sqrt(sum(float(((g[n] - g_want[n]) ** 2).sum()) for n in g))
  gmax = max(float(np.abs(w).max()) for w in g_want.values())
  worst = 0.0
  for name, w in g_want.items():
    if name.endswith("key.bias"):
      assert float(np.abs(g[name]).max()) < 1e-5 * gmax, name
      assert float(np.abs(w).max()) < 1e-5 * gmax, name
      continue
    err = float(np.abs(g[name] - w).max()) / max(float(np.abs(w).max()),
                                                 1e-30)
    worst = max(worst, err)
    assert err < 2e-2, (name, err)
  assert diff < 1e-3 * norm, diff / norm
  return diff / norm, worst


def test_train_step_gradients_match_jax(setup, jax_train):
  s, jt = setup, jax_train
  old = {n: p.detach().clone() for n, p in
         port_model(s["np_params"]).named_parameters()}
  want_new = dict(port_model(jt["new"]).named_parameters())
  want_new = {n: p.detach() for n, p in want_new.items()}
  model, aux = port_step(s, jt)
  assert set(aux) == set(jt["aux"])
  for k, v in jt["aux"].items():
    # the losses of renders equal to ~1e-6 through the same float32 model
    close(aux[k], v, 2e-4, 1e-5, k)
  rel, worst = assert_grads_close(model, old, want_new)
  print(f"gradient error: {rel:.3g} of the norm, {worst:.3g} of a tensor")


def test_learned_loss_weights_match_jax(setup, jax_train):
  """log_vars start at 0, so exp(-s) = 1: the model's gradient is the
  fixed-weight one, and each log-variance's gradient is JAX's gradient of
  uncertainty_weighted_total at the step's mean losses."""
  s, jt = setup, jax_train
  keys = tuple(tt.LOSS_WEIGHTS)
  log_vars = schedules.init_log_vars(keys, "cpu")
  old = {n: p.detach().clone() for n, p in
         port_model(s["np_params"]).named_parameters()}
  want_new = {n: p.detach() for n, p in
              port_model(jt["new"]).named_parameters()}
  model, aux = port_step(s, jt, log_vars=log_vars)
  assert_grads_close(model, old, want_new)
  j_losses_ = {k[len("loss_"):]: jnp.asarray(v) for k, v in jt["aux"].items()
               if k != "loss"}
  g = jax.grad(lambda lv: j_sched.uncertainty_weighted_total(
      j_losses_, lv))(j_sched.init_log_vars(keys))
  for k in keys:
    # sgd(1.0) from 0: the new value is minus the gradient
    close(-log_vars[k].detach(), g[k], 1e-4, 1e-5, f"log_var {k}")
  close(aux["loss"], jt["aux"]["loss"], 2e-4, 1e-5, "total")


def test_freeze_backbone_matches_jax(setup, jax_train):
  """optax's multi_transform with set_to_zero for every 'image_' path, as
  train_transfuser builds it, applied to JAX's gradient."""
  s, jt = setup, jax_train
  grads = jax.tree.map(lambda a, b: a - b, s["np_params"], jt["new"])

  def label_fn(tree):
    return jax.tree_util.tree_map_with_path(
        lambda path, _: "frozen" if any(
            "image_" in str(getattr(k, "key", "")) for k in path)
        else "train", tree)

  tx = optax.multi_transform({"train": optax.sgd(1.0),
                              "frozen": optax.set_to_zero()}, label_fn)
  upd, _ = tx.update(grads, tx.init(s["np_params"]), s["np_params"])
  want = optax.apply_updates(s["np_params"], upd)
  old = {n: p.detach().clone() for n, p in
         port_model(s["np_params"]).named_parameters()}
  want_new = {n: p.detach() for n, p in
              port_model(jax.tree.map(np.asarray, want)).named_parameters()}
  model, _ = port_step(s, jt, freeze=True)
  assert_grads_close(model, old, want_new)
  frozen = [n for n, p in model.named_parameters() if "image_" in n]
  assert frozen and all(not p.requires_grad for n, p in
                        model.named_parameters() if n in frozen)
  for n in frozen:
    assert torch.equal(dict(model.named_parameters())[n], old[n]), n


def test_eval_step_matches_jax(setup):
  s = setup
  _, eval_fn = jax_step(s, optax.sgd(1.0))
  f_idx = [0, 2]
  rng = jax.random.key(13)
  want = {k: np.asarray(v) for k, v in eval_fn(
      s["params"], jnp.asarray(f_idx, jnp.int32), rng, s["maps"], s["scene"],
      s["frames"]).items()}
  draws = [batch_draws(r, s["n_lidar"])
           for r in jax.random.split(rng, len(f_idx))]
  model = port_model(s["np_params"])
  opt = torch.optim.SGD(model.parameters(), lr=1.0)
  _, eval_step, wp_valid = tt.make_transfuser_train_step(
      CFG, TCFG, model, opt, s["t_maps"], s["t_scene"], s["t_frames"],
      s["cam"], s["lid"])
  got = eval_step(f_idx, draws=draws)
  assert set(got) == set(want)
  for k, v in want.items():
    # losses as in the train step; an mIoU or the confusion would move
    # only if an argmax flipped on a 1e-6 tie
    close(got[k], v, 2e-4, 1e-5, k)
  assert int(got["confusion"].sum()) == int((
      s["t_frames"].alive[f_idx].sum()))
  assert wp_valid.shape == (12, B)

  # transfuser_loss on the same batch, assembled by make_train_batch
  parts = [tt.make_train_batch(CFG, TCFG, s["t_maps"], s["t_scene"],
                               s["t_frames"], fi, s["cam"], s["lid"], d)
           for fi, d in zip(f_idx, draws)]
  batch = tree_map(lambda *xs: torch.cat(xs), *parts)
  with torch.no_grad():
    total, aux = tt.transfuser_loss(CFG, TCFG, model, None, batch)
  assert len(aux) == 13
  for k, v in aux.items():
    close(v, want[k], 2e-4, 1e-5, f"transfuser_loss {k}")
  close(total, want["loss"], 2e-4, 1e-5, "total")


def test_optimizer_recipe_matches_optax():
  """clip_by_global_norm(1.0) + adamw(multistep, wd 0.01) over 5 steps
  across a milestone (6 planned steps: decays after updates 3 and 5), on a
  small tree with gradients large enough to clip."""
  rng = np.random.default_rng(2)
  shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
  p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
  lr, steps = 1e-2, 6
  tx = optax.chain(optax.clip_by_global_norm(1.0),
                   optax.adamw(j_plant.make_schedule("multistep", lr, steps),
                               weight_decay=0.01))
  jp, state = jax.tree.map(jnp.asarray, p0), None
  state = tx.init(jp)
  tp = {k: torch.nn.Parameter(T(v)) for k, v in p0.items()}
  opt = torch.optim.AdamW(tp.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                          weight_decay=0.01)
  sched = torch.optim.lr_scheduler.LambdaLR(
      opt, schedules.make_schedule("multistep", steps))
  for i in range(5):
    g = {k: (rng.normal(size=s) * (3.0 if i % 2 else 0.1)).astype(np.float32)
         for k, s in shapes.items()}
    upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
    jp = optax.apply_updates(jp, upd)
    for k in tp:
      tp[k].grad = T(g[k])
    torch.nn.utils.clip_grad_norm_(tp.values(), 1.0)
    opt.step()
    sched.step()
    for k in tp:
      # clip_grad_norm_ scales by max/(norm + 1e-6), optax by max/norm:
      # a relative 1e-6 that Adam's normalisation all but cancels
      close(tp[k].detach(), jp[k], 1e-5, 1e-6, f"step {i} {k}")


def test_schedules_match_optax():
  for name, steps in (("multistep", 50), ("multistep", 3),
                      ("cosine_restart", 1000), (None, 10)):
    j = j_plant.make_schedule(name, 0.5, steps)
    f = schedules.make_schedule(name, steps)
    for count in range(0, 3 * steps + 7, max(steps // 40, 1)):
      want = float(j(count)) if callable(j) else j
      assert abs(0.5 * f(count) - want) < 1e-7, (name, steps, count)
  with pytest.raises(ValueError):
    schedules.make_schedule("linear", 10)
  assert schedules.SPEED_WEIGHTS == j_plant.SPEED_WEIGHTS


def test_uncertainty_weighting_matches_jax():
  rng = np.random.default_rng(3)
  ls = {k: float(v) for k, v in zip("abcd", rng.uniform(0.1, 3, 4))}
  lv = {k: float(v) for k, v in zip("abc", rng.normal(size=3))}
  want = j_sched.uncertainty_weighted_total(
      {k: jnp.float32(v) for k, v in ls.items()},
      {k: jnp.float32(v) for k, v in lv.items()})
  got = schedules.uncertainty_weighted_total(
      {k: torch.tensor(v) for k, v in ls.items()},
      {k: torch.tensor(v) for k, v in lv.items()})
  close(got, want, 1e-6, 1e-6, "kendall")
  init = schedules.init_log_vars(("x", "y"), "cpu")
  assert all(p.requires_grad and float(p.detach()) == 0.0
             for p in init.values())


def test_train_transfuser_runs_with_generator_and_bf16(setup):
  """The port's loop end to end on the CPU: bf16 forward/backward on
  bf16 casts of float32 weights (gradients come back float32), Kendall
  weights, a frozen image branch, the validation pass; from one seed two
  runs agree."""
  s = setup
  runs = []
  for _ in range(2):
    model, hist = tt.train_transfuser(
        CFG, TCFG, s["t_maps"], s["t_scene"], s["t_frames"], s["cam"],
        s["lid"], steps=2, lr=1e-3, seed=3, log_every=1, bf16=True,
        learn_loss_weights=True, freeze_backbone=True, frames_per_step=2,
        val_fraction=0.5)
    runs.append((model, hist))
  (m0, h0), (m1, h1) = runs
  assert len(h0) == 2 and np.isfinite(h0[-1]["loss"])
  assert "val_miou_bev_semantic" in h0[-1]
  assert h0 == h1
  for (n, a), (_, b) in zip(m0.named_parameters(), m1.named_parameters()):
    assert a.dtype == torch.float32 and torch.equal(a, b), n
