"""Port parity of the slice as a whole: the sensor-on closed-loop tick.

Three ticks of ``sim_step`` with the TransFuser++ policy at B=2 (micro
widths, 32x128 camera, 16x-decimated LiDAR) go through the JAX package and
the port from the same scene, the same weights and the same random draws:
the JAX side's GNSS, compass and LiDAR-dropoff draws are replayed into the
port. Every state leaf, ``done`` and the criteria counters are compared
after each tick. The JAX renderers are sent down their Pallas path (in
interpret mode), which is the path the port always takes.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import carla_garage_tpu.sensors.camera as j_camera
import carla_garage_tpu.sensors.lidar as j_lidar
from carla_garage_tpu.agents import sensor_agent as j_agent
from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG
from carla_garage_tpu.models import transfuser as jtf
from carla_garage_tpu.sensors import raycast as j_rc
from carla_garage_tpu.sim import episode as j_episode
from carla_garage_tpu.sim.scene_builder import make_synthetic_batch
from carla_garage_tpu_torch.agents.sensor_agent import (
    make_transfuser_policy, sensor_agent_reset)
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.convert import load_flax_params
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
from carla_garage_tpu_torch.sim.episode import rollout, sim_step
from carla_garage_tpu_torch.structs import SimState, tree_items
from test_torch_port_scene import jax_batch_to_port

B = 2
TICKS = 3


def _tick_config():
  return dataclasses.replace(jtf.micro_config(), img_h=32, img_w=128,
                             lidar_h=256, lidar_w=256, img_anchors=(1, 4),
                             lidar_anchors=(8, 8))


def _draws(rng, n_lidar):
  """The draws of one JAX tick (episode.py:51, sensor_agent.py:138-142,
  lidar.py:86) and the key the next tick starts from."""
  rng, rng_step, _ = jax.random.split(rng, 3)
  r_gps, r_cmp, r_lid = jax.random.split(rng_step, 3)
  t = lambda a: torch.from_numpy(np.array(a))
  return rng, {"gps": t(jax.random.normal(r_gps, (B, 2))),
               "compass": t(jax.random.normal(r_cmp, (B,))),
               "lidar": t(jax.random.uniform(r_lid, (B, n_lidar)))}


def _leaf(obj, path):
  for name in path.strip("/").split("/"):
    obj = getattr(obj, name)
  return np.asarray(obj)


@pytest.mark.parametrize("variant", ["single", "ensemble_argmax"])
def test_sensor_tick_matches_jax(monkeypatch, variant):
  """'single': the bench's operating point (one model, expected target
  speed with the brake-probability override). 'ensemble_argmax': two
  different weight sets averaged, argmax target speed, brake threshold
  0.3, over two ticks."""
  pallas = functools.partial(j_rc.cast_rays, use_pallas=True)
  monkeypatch.setattr(j_camera, "cast_rays", pallas)
  monkeypatch.setattr(j_lidar, "cast_rays", pallas)

  c = _tick_config()
  cam = camera_ray_grid(CFG, scale=8)
  lid_f = lidar_ray_grid(CFG, half=0, decimate=16)
  lid_r = lidar_ray_grid(CFG, half=1, decimate=16)
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  _, maps, lanes, scene, state = make_synthetic_batch(
      JCFG, batch=B, seed=0, n_vehicles=8, n_walkers=2)

  jm = jtf.LidarCenterNet(c)
  zeros = [np.zeros(s, np.float32) for s in
           ((B, c.img_h, c.img_w, 3), (B, c.lidar_h, c.lidar_w, 2),
            (B, 2), (B, 6), (B,))]
  init = jax.jit(jm.init)
  ensemble = variant == "ensemble_argmax"
  params = [init(jax.random.key(k), *zeros) for k in range(1 + ensemble)]
  kw = dict(uncertainty_weight=False, brake_threshold=0.3) if ensemble \
      else {}
  j_policy = j_agent.make_transfuser_policy(
      jm, params if ensemble else params[0], c, cam, lid_f, lid_r,
      direct=True, **kw)
  j_state = state.replace(agent=j_agent.sensor_agent_reset(JCFG, B, n_lidar))
  j_step = jax.jit(lambda st: j_episode.sim_step(JCFG, maps, lanes, scene,
                                                 st, j_policy))

  t_maps, t_lanes, t_scene, t_state = jax_batch_to_port(maps, lanes, scene,
                                                        state)
  tc = ttf.TransfuserConfig(**dataclasses.asdict(c))
  models = [load_flax_params(ttf.LidarCenterNet(tc),
                             jax.tree.map(np.asarray, p)) for p in params]
  t_policy = make_transfuser_policy(
      models[0], [m.state_dict() for m in models] if ensemble else None, c,
      cam, lid_f, lid_r, direct=True, **kw)
  t_state = t_state.replace(agent=sensor_agent_reset(CFG, B, n_lidar,
                                                     device="cpu"))

  rng = j_state.rng
  ticks = 2 if ensemble else TICKS
  for _ in range(ticks):
    rng, draws = _draws(rng, n_lidar)
    j_state = j_step(j_state)
    t_state = sim_step(CFG, t_maps, t_lanes, t_scene, t_state, t_policy,
                       draws=draws)
    n = 0
    for path, t in tree_items(t_state):
      want, got = _leaf(j_state, path), t.numpy()
      assert got.dtype == want.dtype and got.shape == want.shape, path
      if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=path)
      else:
        # the model's f32 outputs agree to ~1e-6 of their scale and
        # steer the ego; sin/cos and the UKF's 4x4 factorisations agree
        # to an ulp or so: 1e-4 of positions up to a few hundred metres
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=path)
      n += 1
    assert n > 80
  assert int(t_state.tick.min()) == ticks
  assert float(t_state.agent.prev_lidar_valid.float().mean()) > 0.05


def test_rollout_draws_from_the_generator():
  """rollout's ticks draw their noise from the caller's generator: two
  runs from one seed agree, and a tick advances every episode."""
  c = _tick_config()
  cam = camera_ray_grid(CFG, scale=8)
  lid_f = lidar_ray_grid(CFG, half=0, decimate=16)
  lid_r = lidar_ray_grid(CFG, half=1, decimate=16)
  _, maps, lanes, scene, state = make_synthetic_batch(
      JCFG, batch=B, seed=3, n_vehicles=4, n_walkers=1)
  t_maps, t_lanes, t_scene, t_state = jax_batch_to_port(maps, lanes, scene,
                                                        state)
  torch.manual_seed(0)
  model = ttf.LidarCenterNet(ttf.TransfuserConfig(**dataclasses.asdict(c)))
  policy = make_transfuser_policy(model, None, c, cam, lid_f, lid_r)
  start = t_state.replace(agent=sensor_agent_reset(
      CFG, B, lid_f.shape[0] * lid_f.shape[1], device="cpu"))
  runs = [rollout(CFG, t_maps, t_lanes, t_scene, start, 2, policy,
                  generator=torch.Generator().manual_seed(5))
          for _ in range(2)]
  for (path, a), (_, b) in zip(tree_items(runs[0]), tree_items(runs[1])):
    assert torch.equal(a, b), path
  assert torch.equal(runs[0].tick, torch.full((B,), 2, dtype=torch.int32))
  assert isinstance(runs[0], SimState)
