"""Port parity: the BEV box-fill kernel's plain version, the BEV semantic
renderer and the full LiDAR sweep, torch vs JAX on the CPU.

The kernel's plain version is what the card's kernel is held against
(``tests/test_torch_port_cuda.py``, ``tests/test_torch_port_card.py``);
here it is held against the JAX kernel (interpret mode on the CPU) and
the JAX reference, fed the reference's own cos and sin: the maps must be
equal, pixel for pixel.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG
from carla_garage_tpu.ops.pallas import bev_fill as j_bev_fill
from carla_garage_tpu.sensors import bev as j_bev
from carla_garage_tpu.sensors import lidar as j_lidar
from carla_garage_tpu.sim.scene_builder import make_synthetic_batch
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.ops import bev_fill
from carla_garage_tpu_torch.sensors import bev, lidar
from test_torch_port_scene import jax_batch_to_port

T = lambda a: torch.from_numpy(np.array(a))


def random_boxes(B, V, h, w, seed):
  """Boxes over a grid: random poses, some invalid, and two boxes of other
  classes laid over one another at the same center (the later must win)."""
  rng = np.random.default_rng(seed)
  f = lambda a: jnp.asarray(a, jnp.float32)
  cx = rng.uniform(-10, w + 10, (B, V))
  cy = rng.uniform(-10, h + 10, (B, V))
  cx[:, 1], cy[:, 1] = cx[:, 0], cy[:, 0]
  return dict(
      cx=f(cx), cy=f(cy), yaw=f(rng.uniform(-3.2, 3.2, (B, V))),
      ex=f(rng.uniform(2, 14, (B, V))), ey=f(rng.uniform(1, 7, (B, V))),
      cls=jnp.asarray(rng.integers(1, 11, (B, V)), jnp.int32),
      valid=jnp.asarray(rng.uniform(size=(B, V)) > 0.25).at[:, :2].set(True))


def port_boxes(b):
  """The port's packed boxes with the JAX side's cos and sin."""
  return bev_fill.pack_boxes(T(b["cx"]), T(b["cy"]), T(jnp.cos(b["yaw"])),
                             T(jnp.sin(b["yaw"])), T(b["ex"]), T(b["ey"]),
                             T(b["cls"]), T(b["valid"]))


@pytest.mark.parametrize("B,V", [(2, 9), (1, 40)])
def test_fill_plain_equals_jax_kernel_and_reference(B, V):
  b = random_boxes(B, V, 256, 256, seed=V)
  j_kernel = np.asarray(j_bev_fill.fill_boxes_bev(**b, h=256, w=256))
  j_ref = np.asarray(j_bev_fill.fill_boxes_bev_reference(**b, h=256, w=256))
  got = bev_fill.fill_boxes(port_boxes(b), 256, 256).numpy()
  assert got.dtype == np.uint8 and got.shape == (B, 256, 256)
  np.testing.assert_array_equal(got, j_kernel)
  np.testing.assert_array_equal(got, j_ref)
  assert (got > 0).mean() > 0.01


def test_fill_ragged_grid_equals_reference():
  """h, w not multiples of 128 (the JAX kernel needs them): the reference
  only."""
  b = random_boxes(3, 37, 200, 328, seed=5)
  j_ref = np.asarray(j_bev_fill.fill_boxes_bev_reference(**b, h=200, w=328))
  got = bev_fill.fill_boxes(port_boxes(b), 200, 328).numpy()
  np.testing.assert_array_equal(got, j_ref)
  # the overlapping pair: the later box's class at the shared center
  cx, cy = int(b["cx"][0, 1]), int(b["cy"][0, 1])
  if 0 <= cx < 328 and 0 <= cy < 200:
    assert got[0, cy, cx] == int(b["cls"][0, 1])


def test_fill_boxes_bev_keeps_the_jax_signature():
  b = random_boxes(2, 12, 256, 256, seed=2)
  got = bev_fill.fill_boxes_bev(*(T(b[k]) for k in ("cx", "cy", "yaw", "ex",
                                                    "ey", "cls", "valid")))
  want = np.asarray(j_bev_fill.fill_boxes_bev_reference(**b))
  # torch's and XLA's cos/sin may differ by an ulp: edge pixels only
  assert (got.numpy() != want).mean() < 1e-3


def test_fill_cost_counts_the_tests_this_data_needs():
  """The cost's test count equals a brute-force count of each valid box's
  footprint pixels in the grid; every pixel a box holds lies in its
  footprint, and a box off the grid costs nothing."""
  h, w = 24, 40
  b = random_boxes(2, 7, h, w, seed=1)
  boxes = port_boxes(b)
  boxes[1, 6, :2] = torch.tensor([500.0, -300.0])    # far off the grid
  n_bytes, flops, tests = bev_fill.fill_boxes_bev_cost(boxes, h, w)
  bx = boxes.numpy().astype(np.float64)
  ys, xs = np.mgrid[0:h, 0:w]
  want = 0
  for e in range(2):
    for v in range(7):
      cx, cy, c, s, ex, ey, _, ok = bx[e, v]
      ax = abs(c) * ex + abs(s) * ey
      ay = abs(s) * ex + abs(c) * ey
      foot = (xs >= np.floor(cx - ax)) & (xs <= np.ceil(cx + ax)) & \
          (ys >= np.floor(cy - ay)) & (ys <= np.ceil(cy + ay))
      one = boxes[e:e + 1, v:v + 1].clone()
      one[..., 6:] = 1.0                     # class 1, valid
      inside = bev_fill.fill_boxes_bev_plain(one, h, w)[0].numpy() > 0
      assert not (inside & ~foot).any(), (e, v)
      if ok > 0:
        want += int(foot.sum())
      if (e, v) == (1, 6):
        assert not foot.any()
  assert 0 < tests == want
  assert flops == tests * bev_fill.TEST_FLOPS == tests * 8
  assert n_bytes == 4 * 2 * 7 * 8 + 2 * h * w
  valid = int(np.asarray(b["valid"]).sum())
  assert tests <= valid * h * w


def test_fill_refuses_other_devices():
  with pytest.raises(ValueError, match="unsupported device"):
    bev_fill.fill_boxes(torch.zeros((1, 2, 8), device="meta"), 4, 4)


def test_full_lidar_grid_matches_jax():
  for dec in (1, 16):
    want = j_lidar.full_lidar_grid(JCFG, decimate=dec)
    got = lidar.full_lidar_grid(CFG, decimate=dec)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
  assert lidar.full_lidar_grid(CFG).shape == (64, 936, 3)


def test_render_bev_semantics_matches_jax():
  """B=2 synthetic episodes with traffic, walkers, lights and stop signs.
  JAX runs eagerly, op by op, so that no multiply-add is contracted; its
  fill kernel computes cos and sin under jit, torch its own: a pixel on a
  box edge may flip on a 1-ulp difference, so up to 1e-4 of the pixels may
  differ, and each that does lies on the edge of a box."""
  _, maps, lanes, scene, state = make_synthetic_batch(
      JCFG, batch=2, seed=3, n_vehicles=24, n_walkers=4)
  # vehicles and walkers around the ego, so boxes land in the grid
  rng = np.random.default_rng(3)
  ego = state.ego
  veh = state.vehicles
  near = ego.pos[:, None] + jnp.asarray(rng.uniform(-25, 25, (2, 12, 2)),
                                        jnp.float32)
  veh = veh.replace(pos=veh.pos.at[:, :12].set(near),
                    valid=veh.valid.at[:, :12].set(True))
  wlk = state.walkers
  wlk = wlk.replace(pos=wlk.pos.at[:, :2].set(ego.pos[:, None] + 4.0),
                    valid=wlk.valid.at[:, :2].set(True))
  state = state.replace(vehicles=veh, walkers=wlk,
                        tick=jnp.asarray([0, 170], jnp.int32))
  want = np.asarray(j_bev.render_bev_semantics(JCFG, maps, scene, state))
  t_maps, _, t_scene, t_state = jax_batch_to_port(maps, lanes, scene, state)
  got = bev.render_bev_semantics(CFG, t_maps, t_scene, t_state).numpy()
  assert got.dtype == np.uint8 and got.shape == want.shape == (2, 256, 256)
  diff = got != want
  print(f"BEV pixels that differ: {int(diff.sum())} of {diff.size}")
  assert diff.mean() < 1e-4, diff.mean()
  if diff.any():
    # every differing pixel borders a pixel of the other class
    for e, y, x in zip(*np.nonzero(diff)):
      nb = want[e, max(y - 1, 0):y + 2, max(x - 1, 0):x + 2]
      assert (nb == got[e, y, x]).any()
  for cls in (bev.BevClass.ROAD, bev.BevClass.VEHICLE, bev.BevClass.WALKER):
    assert (got == cls).any(), cls


def test_bev_grid_world_matches_jax():
  rng = np.random.default_rng(0)
  pos = rng.uniform(-100, 100, (3, 1, 1, 2)).astype(np.float32)
  yaw = rng.uniform(-3, 3, (3, 1, 1)).astype(np.float32)
  want = np.asarray(j_bev.bev_grid_world(JCFG, jnp.asarray(pos),
                                         jnp.asarray(yaw)))
  got = bev.bev_grid_world(CFG, T(pos), T(yaw)).numpy()
  # sin/cos of two libraries, positions up to ~150 m
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-5)


def test_bev_config_widths_follow_the_sensor_config():
  cfg = CFG.replace(sensor=dataclasses.replace(
      CFG.sensor, lidar_resolution_width=128, lidar_resolution_height=96))
  g = bev.bev_grid_world(cfg, torch.zeros(2), torch.zeros(()))
  assert g.shape == (96, 128, 2)
