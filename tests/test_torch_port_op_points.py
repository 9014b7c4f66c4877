"""Port parity: the sensor agent's operating points, torch vs JAX on the CPU.

  * the CenterNet decode (``topk_decode``, with equal peaks) and the
    rotated NMS: ints and masks equal, floats to 1e-6;
  * ``jpeg_artifacts`` at qualities 95 and 50 on float and uint8 images:
    1e-5 of the [0, 1] range (float), equal (uint8);
  * ``LidarCenterNet(use_wp_gru=True)`` against flax from
    ``load_flax_params``, every output to the model test's bar;
  * three ticks of ``sim_step`` with the sensor agent for each option
    (``stop_control``, ``jpeg_quality=95``, ``seq_len=2``, ``map_track``,
    ``direct=False``), the JAX tick's GNSS, compass and LiDAR draws
    replayed into the port: every state leaf, ints and bools equal,
    floats to the tick test's 1e-4. The model is a scripted stand-in on
    both sides whose outputs are smooth functions of every input (camera
    colours and edges, each LiDAR channel, the target point, the speed),
    with a class-3 CenterNet peak ahead of the ego for the stop-sign
    controller, as ``tests/test_op_points.py`` scripts it. Each option is
    also held against the same ticks without it, which must differ.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carla_garage_tpu.sensors.camera as j_camera
import carla_garage_tpu.sensors.lidar as j_lidar
from carla_garage_tpu.agents import sensor_agent as j_agent
from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG
from carla_garage_tpu.models import transfuser as jtf
from carla_garage_tpu.ops import detection as j_det
from carla_garage_tpu.ops import jpeg as j_jpeg
from carla_garage_tpu.sensors import raycast as j_rc
from carla_garage_tpu.sim import episode as j_episode
from carla_garage_tpu.sim.scene_builder import make_synthetic_batch
from carla_garage_tpu_torch.agents.sensor_agent import (
    make_transfuser_policy, sensor_agent_reset)
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.convert import load_flax_params
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.ops import detection as det
from carla_garage_tpu_torch.ops import jpeg
from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
from carla_garage_tpu_torch.sim.episode import sim_step
from carla_garage_tpu_torch.structs import tree_items
from test_torch_port_eval import _random_params
from test_torch_port_model import _compare, _inputs, _np_tree
from test_torch_port_scene import jax_batch_to_port
from test_torch_port_tick import _draws, _leaf, _tick_config

B = 2
T = lambda a: torch.from_numpy(np.array(a))


def _heads(rng, B, g, tie):
  """Random CenterNet outputs [B,g,g,*]; `tie` sets equal peaks at
  separated pixels and classes."""
  heat = rng.normal(-3.0, 1.5, (B, g, g, 4)).astype(np.float32)
  if tie:
    for (y, x, c) in ((3, 5, 3), (9, 2, 0), (9, 12, 3), (1, 1, 1)):
      heat[:, y, x, c] = 4.0
  return {"heatmap": heat,
          "wh": rng.uniform(1, 6, (B, g, g, 2)).astype(np.float32),
          "offset": rng.uniform(0, 1, (B, g, g, 2)).astype(np.float32),
          "yaw_class": rng.normal(size=(B, g, g, 12)).astype(np.float32),
          "yaw_res": rng.normal(0, 0.2, (B, g, g, 1)).astype(np.float32),
          "velocity": rng.uniform(0, 8, (B, g, g, 1)).astype(np.float32),
          "brake": rng.normal(size=(B, g, g, 2)).astype(np.float32)}


@pytest.mark.parametrize("tie", [False, True])
def test_topk_decode_and_nms_match_jax(tie):
  rng = np.random.default_rng(11 + tie)
  preds = _heads(rng, 3, 16, tie)
  kw = dict(ppm=0.5, k=24, min_x=-16.0, min_y=-16.0)
  want = jax.jit(lambda p: j_det.topk_decode(p, **kw))(preds)
  got = det.topk_decode({k: T(v) for k, v in preds.items()}, **kw)
  assert set(got) == set(want)
  for k, w in want.items():
    w, g = np.asarray(w), got[k].numpy()
    assert g.dtype == w.dtype and g.shape == w.shape, k
    if w.dtype.kind in "iu":
      np.testing.assert_array_equal(g, w, err_msg=k)
    else:
      np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=k)
  if tie:
    # the four equal peaks lead, in flat-index order
    assert np.all(np.asarray(want["score"])[:, :4] ==
                  np.asarray(want["score"])[:, :1])
  # NMS over the decoded boxes, with scores low enough that some survive
  # and overlapping boxes that some suppress
  boxes = {k: np.asarray(v) for k, v in want.items()}
  boxes["x"] = boxes["x"][:, :1] + rng.uniform(-3, 3, boxes["x"].shape)
  boxes["score"] = rng.uniform(0.2, 1.0, boxes["score"].shape)
  if tie:
    boxes["score"][:, 5:9] = 0.8
  boxes = {k: np.asarray(v, np.asarray(want[k]).dtype)
           for k, v in boxes.items()}
  keep_j = np.asarray(jax.jit(j_det.nms_rotated)(boxes))
  keep_t = det.nms_rotated({k: T(v) for k, v in boxes.items()}).numpy()
  np.testing.assert_array_equal(keep_t, keep_j)
  assert 0 < keep_t.sum() < (boxes["score"] > 0.3).sum()


@pytest.mark.parametrize("quality", [95, 50])
def test_jpeg_artifacts_matches_jax(quality):
  rng = np.random.default_rng(quality)
  # a render-like image (flat patches with edges) and noise
  flat = np.repeat(np.repeat(rng.integers(0, 8, (2, 4, 16, 3)) / 7.0, 8, 1),
                   8, 2).astype(np.float32)
  noise = rng.uniform(0, 1, (2, 32, 128, 3)).astype(np.float32)
  for img in (flat, noise):
    want = np.asarray(jax.jit(lambda x: j_jpeg.jpeg_artifacts(
        x, quality))(img))
    got = jpeg.jpeg_artifacts(T(img), quality).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got - img).max() > 1e-3          # it did change the image
  u8 = rng.integers(0, 256, (1, 16, 24, 3)).astype(np.uint8)
  want = np.asarray(j_jpeg.jpeg_artifacts(u8, quality))
  got = jpeg.jpeg_artifacts(T(u8), quality).numpy()
  assert got.dtype == np.uint8
  np.testing.assert_array_equal(got, want)
  for a, b in zip(jpeg.quality_tables(quality),
                  j_jpeg.quality_tables(quality)):
    np.testing.assert_array_equal(a, b)


def test_lidar_center_net_wp_gru_matches_flax():
  c = dataclasses.replace(jtf.micro_config(), use_wp_gru=True)
  x = _inputs(c, 2, seed=4)
  jm = jtf.LidarCenterNet(c)
  # seeded weights of init's shapes, made in numpy (no compiled init)
  params = _random_params(jax.eval_shape(
      jm.init, jax.random.key(6), x["rgb"], x["lidar"], x["tp"], x["cmd"],
      x["vel"]), seed=7)
  j_out = jax.jit(jm.apply)(params, x["rgb"], x["lidar"], x["tp"],
                            x["cmd"], x["vel"])
  assert "pred_wp" in j_out
  tm = load_flax_params(
      ttf.LidarCenterNet(ttf.TransfuserConfig(**dataclasses.asdict(c))),
      _np_tree(params)).eval()
  with torch.no_grad():
    t_out = tm(*(T(x[k]) for k in ("rgb", "lidar", "tp", "cmd", "vel")))
  assert t_out["pred_wp"].shape == (2, c.pred_len, 2)
  _compare(jax.tree.map(np.asarray, j_out), t_out)


# --- the agent's options over three ticks -------------------------------

GRID = 64            # the CenterNet grid of the 256x256 LiDAR BEV / 4


def _scripted(xp, rgb, lidar, tp, speed, stop_x):
  """The scripted outputs in array namespace xp (jnp or torch): smooth in
  every input. A class-3 peak `stop_x` metres ahead of the ego."""
  f_rgb = rgb.mean((1, 2))                                   # [B,3]
  edges = xp.abs(rgb[:, :, 1:] - rgb[:, :, :-1]).mean((1, 2, 3))
  f_lid = lidar.mean((1, 2)) * 40.0                          # [B,C]
  lid_w = xp.stack([f_lid[:, k] * (k + 1) for k in range(lidar.shape[-1])],
                   -1).sum(-1)
  ts = xp.stack([-1.0 + 30.0 * edges, 0.5 * f_rgb[:, 0] + 0.2 * lid_w,
                 1.0 + f_rgb[:, 1], 1.5 + 0.05 * speed - 0.3 * lid_w], -1)
  steps = xp.stack([rgb[:, 0, 0, 0] * 0 + (k + 1.0) for k in range(10)], 1)
  lat = 0.1 * xp.tanh(tp[:, 1] / 10.0) + 0.05 * f_rgb[:, 2] + 5.0 * edges
  ckpt = xp.stack([steps * (2.0 + lid_w[:, None]), steps * lat[:, None]],
                  -1)
  wp_scale = 0.6 + 0.4 * f_rgb[:, 1] + 0.1 * lid_w
  wp = xp.stack([steps[:, :8] * wp_scale[:, None],
                 steps[:, :8] * lat[:, None]], -1)
  B = rgb.shape[0]
  g = GRID
  cx = int((stop_x - CFG.sensor.min_x) * g / 64.0)
  cy = int((0.0 - CFG.sensor.min_y) * g / 64.0)
  heat = np.full((B, g, g, 4), -10.0, np.float32)
  heat[:, cy, cx, 3] = 10.0
  yaw_cls = np.full((B, g, g, 12), -5.0, np.float32)
  yaw_cls[..., 0] = 5.0
  const = (lambda a: jnp.asarray(a)) if xp is jnp else torch.from_numpy
  bb = {"heatmap": const(heat),
        "wh": const(np.full((B, g, g, 2), 1.5 * g / 64.0, np.float32)),
        "offset": const(np.zeros((B, g, g, 2), np.float32)),
        "yaw_class": const(yaw_cls),
        "yaw_res": const(np.zeros((B, g, g, 1), np.float32))}
  return {"pred_target_speed": ts, "pred_checkpoint": ckpt,
          "pred_wp": wp, "pred_bb": bb}


class JaxScripted:

  def __init__(self, stop_x):
    self.stop_x = stop_x

  def apply(self, params, rgb, lidar_bev, target_point, cmd, speed):
    return _scripted(jnp, rgb, lidar_bev, target_point, speed, self.stop_x)


class TorchScripted(torch.nn.Module):

  def __init__(self, stop_x):
    super().__init__()
    self.stop_x = stop_x
    self.anchor = torch.nn.Parameter(torch.zeros(()))   # gives the device

  def forward(self, rgb, lidar_bev, target_point, cmd, speed):
    return _scripted(torch, rgb, lidar_bev, target_point, speed,
                     self.stop_x)


OPTIONS = {
    # a detected stop sign overlapping the ego: episode 0 starts at 5 m/s
    # and must brake, episode 1 starts at rest and clears it
    "stop_control": dict(policy=dict(stop_control=True), stop_x=3.0),
    "jpeg_quality": dict(policy=dict(jpeg_quality=95)),
    "seq_len": dict(seq_len=2),
    "map_track": dict(policy=dict(map_track=True)),
    "waypoints": dict(policy=dict(direct=False)),
}


@pytest.fixture(scope="module")
def world():
  mp = pytest.MonkeyPatch()
  pallas = functools.partial(j_rc.cast_rays, use_pallas=True)
  mp.setattr(j_camera, "cast_rays", pallas)
  mp.setattr(j_lidar, "cast_rays", pallas)
  _, maps, lanes, scene, state = make_synthetic_batch(
      JCFG, batch=B, seed=6, n_vehicles=6, n_walkers=1)
  state = state.replace(ego=state.ego.replace(
      speed=jnp.asarray([5.0, 0.0], jnp.float32)))
  yield (maps, lanes, scene, state), jax_batch_to_port(maps, lanes, scene,
                                                       state)
  mp.undo()


def _port_run(world_t, draws, policy_kw, seq_len=1, stop_x=10.0):
  t_maps, t_lanes, t_scene, t_state = world_t
  c = _tick_config()
  cam = camera_ray_grid(CFG, scale=8)
  lid_f = lidar_ray_grid(CFG, half=0, decimate=16)
  lid_r = lidar_ray_grid(CFG, half=1, decimate=16)
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  policy = make_transfuser_policy(TorchScripted(stop_x), None, c, cam,
                                  lid_f, lid_r, **policy_kw)
  st = t_state.replace(agent=sensor_agent_reset(CFG, B, n_lidar,
                                                seq_len=seq_len,
                                                device="cpu"))
  states = []
  for d in draws:
    st = sim_step(CFG, t_maps, t_lanes, t_scene, st, policy, draws=d)
    states.append(st)
  return states


@pytest.mark.parametrize("option", list(OPTIONS))
def test_sensor_agent_option_matches_jax(world, option):
  (maps, lanes, scene, state), world_t = world
  spec = OPTIONS[option]
  c = _tick_config()
  cam = camera_ray_grid(CFG, scale=8)
  lid_f = lidar_ray_grid(CFG, half=0, decimate=16)
  lid_r = lidar_ray_grid(CFG, half=1, decimate=16)
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  seq_len, stop_x = spec.get("seq_len", 1), spec.get("stop_x", 10.0)
  policy_kw = spec.get("policy", {})
  j_policy = j_agent.make_transfuser_policy(
      JaxScripted(stop_x), {}, c, cam, lid_f, lid_r, **policy_kw)
  j_state = state.replace(agent=j_agent.sensor_agent_reset(
      JCFG, B, n_lidar, seq_len=seq_len))
  j_step = jax.jit(lambda st: j_episode.sim_step(JCFG, maps, lanes, scene,
                                                 st, j_policy))
  rng, draws, j_states = j_state.rng, [], []
  for _ in range(3):
    rng, d = _draws(rng, n_lidar)
    draws.append(d)
    j_state = j_step(j_state)
    j_states.append(j_state)

  t_states = _port_run(world_t, draws, policy_kw, seq_len, stop_x)
  for j_st, t_st in zip(j_states, t_states):
    n = 0
    for path, t in tree_items(t_st):
      want, got = _leaf(j_st, path), t.numpy()
      assert got.dtype == want.dtype and got.shape == want.shape, path
      if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=path)
      else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=path)
      n += 1
    assert n > 80
  final = t_states[-1]
  assert final.agent.prev_lidar.shape[1] == seq_len
  if option == "stop_control":
    # episode 0 brakes inside the tracked box; episode 1, at rest,
    # cleared it on the first tick, re-adopted it and sits in the cooldown
    ag = final.agent
    assert bool(ag.stop_box_valid.all())
    assert int(ag.clear_stop[0]) == 0 and int(ag.clear_stop[1]) == 98
    assert float(final.agent.prev_control[0, 2]) == 1.0
    assert float(final.ego.speed[0]) < 5.0
  if option == "seq_len":
    assert bool(final.agent.prev_lidar_valid[:, 1].any())

  # the option matters: the same ticks without it end elsewhere
  plain = _port_run(world_t, draws,
                    {"direct": True} if option == "waypoints" else {},
                    stop_x=stop_x)[-1]
  diff = max(float((a - b).abs().max())
             for (_, a), (_, b) in zip(tree_items(final.agent.pid_speed),
                                       tree_items(plain.agent.pid_speed)))
  diff = max(diff, float((final.ego.pos - plain.ego.pos).abs().max()),
             float((final.agent.prev_control -
                    plain.agent.prev_control).abs().max()))
  assert diff > 1e-4, (option, diff)


def test_waypoint_controller_runs_with_the_wp_gru_head():
  """direct=False with a real LidarCenterNet(use_wp_gru=True) in the port
  (the scripted stand-in above holds the controller against JAX)."""
  c = dataclasses.replace(_tick_config(), use_wp_gru=True)
  cam = camera_ray_grid(CFG, scale=8)
  lid_f = lidar_ray_grid(CFG, half=0, decimate=16)
  lid_r = lidar_ray_grid(CFG, half=1, decimate=16)
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  _, maps, lanes, scene, state = make_synthetic_batch(
      JCFG, batch=B, seed=3, n_vehicles=4, n_walkers=1)
  t_maps, t_lanes, t_scene, t_state = jax_batch_to_port(maps, lanes, scene,
                                                        state)
  torch.manual_seed(0)
  model = ttf.LidarCenterNet(ttf.TransfuserConfig(**dataclasses.asdict(c)))
  policy = make_transfuser_policy(model, None, c, cam, lid_f, lid_r,
                                  direct=False)
  st = t_state.replace(agent=sensor_agent_reset(CFG, B, n_lidar,
                                                device="cpu"))
  gen = torch.Generator().manual_seed(1)
  for _ in range(2):
    st = sim_step(CFG, t_maps, t_lanes, t_scene, st, policy, generator=gen)
  assert bool(torch.isfinite(st.agent.prev_control).all())
  assert int(st.tick.min()) == 2
