"""Port parity: the ray-box kernel's plain version, box culling, camera and
LiDAR rendering, and voxelization, torch vs JAX on the CPU.

The JAX package casts rays on the CPU through its dense path, which does no
culling; the port always takes the culled kernel path. So the JAX side here
is forced onto ``use_pallas=True``, where its Pallas kernel runs in
interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carla_garage_tpu.sensors.camera as j_camera
import carla_garage_tpu.sensors.lidar as j_lidar
from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG
from carla_garage_tpu.ops.pallas.raycast import raycast_boxes as j_raycast
from carla_garage_tpu.sensors import raycast as j_rc
from carla_garage_tpu.sensors.voxelize import voxelize_matmul as j_voxelize
from carla_garage_tpu.sim.scene_builder import make_synthetic_batch
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.ops.raycast import raycast_boxes
from carla_garage_tpu_torch.sensors import raycast as t_rc
from carla_garage_tpu_torch.sensors.camera import (camera_ray_grid,
                                                   render_camera)
from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid, render_lidar
from carla_garage_tpu_torch.sensors.voxelize import voxelize
from test_torch_port_cuda import random_box_case
from test_torch_port_scene import jax_batch_to_port

TILE = 8192   # the JAX kernel's ray tile: N is padded to a multiple of it


def _jax_raycast(o, d, bx):
  """The JAX kernel (interpret mode on the CPU) on a ragged N, padded
  the way cast_rays pads it."""
  B, N, _ = d.shape
  Np = -(-N // TILE) * TILE
  pad = np.broadcast_to(np.array([1.0, 0.0, 1.0], np.float32),
                        (B, Np - N, 3))
  t, c = j_raycast(o, np.concatenate([d, pad], 1), bx)
  return np.asarray(t)[:, :N], np.asarray(c)[:, :N]


@pytest.mark.parametrize("B,N,K", [(2, 1000, 13), (1, 8192, 48),
                                   (3, 257, 5)])
def test_raycast_plain_matches_jax_kernel(B, N, K):
  # duplicated boxes of two classes (a tie the earlier box wins), an
  # origin inside a box, invalid boxes, and a ragged N
  o, d, bx = random_box_case(B, N, K, seed=K)
  t, c = raycast_boxes(o, d, bx)                  # CPU: the plain version
  t_j, c_j = _jax_raycast(o.numpy(), d.numpy(), bx.numpy())
  # the same fp32 operations in the same order, but XLA's CPU compiler
  # may fuse a*b + c into one multiply-add where the port rounds twice
  # (the CUDA kernel is built with -fmad=false to match the plain
  # version): a few ulps of the slab terms, which scale with the 30 m
  # scene, so atol 1e-5 beside rtol 1e-6; the classes are equal
  np.testing.assert_allclose(t.numpy(), t_j, rtol=1e-6, atol=1e-5)
  np.testing.assert_array_equal(c.numpy(), c_j)
  assert (t_j < 1e9).any()
  # the tie: where box 0 and its duplicate box 1 are nearest, class 1 wins
  assert (c_j == 1).any()


@pytest.fixture(scope="module")
def scene_batch():
  """Two episodes of the JAX synthetic town, with a vehicle parked 12 m
  ahead of each ego so that the renders see a box; the same batch in the
  port's structs."""
  _, maps, lanes, scene, state = make_synthetic_batch(
      JCFG, batch=2, seed=0, n_vehicles=8, n_walkers=2)
  ego = state.ego
  fwd = jnp.stack([jnp.cos(ego.yaw), jnp.sin(ego.yaw)], -1)
  veh = state.vehicles
  veh = veh.replace(pos=veh.pos.at[:, 0].set(ego.pos + 12.0 * fwd),
                    yaw=veh.yaw.at[:, 0].set(ego.yaw),
                    valid=veh.valid.at[:, 0].set(True))
  state = state.replace(vehicles=veh)
  return (maps, scene, state), jax_batch_to_port(maps, lanes, scene, state)


@pytest.fixture
def jax_kernel_path(monkeypatch):
  """Send the JAX renderers down their Pallas path, as on a TPU."""
  pallas = functools.partial(j_rc.cast_rays, use_pallas=True)
  monkeypatch.setattr(j_camera, "cast_rays", pallas)
  monkeypatch.setattr(j_lidar, "cast_rays", pallas)


def test_cull_boxes_matches_jax(scene_batch):
  (_, j_scene, j_state), (_, _, scene, state) = scene_batch
  want = np.asarray(j_rc.cull_boxes(
      j_rc._gather_boxes(JCFG, j_scene, j_state), j_state.ego.pos))
  boxes = t_rc._gather_boxes(CFG, scene, state)
  assert boxes.shape[1] > 48            # the default config does cull
  got = t_rc.cull_boxes(boxes, state.ego.pos).numpy()
  valid = want[..., 8] > 0
  # valid boxes are the nearest ones, in the same order (distances are
  # distinct); the invalid ones fill the rest at an infinite distance,
  # and top_k and topk may pick them in another order
  np.testing.assert_array_equal(got[..., 8] > 0, valid)
  np.testing.assert_array_equal(got[valid], want[valid])
  lights = (want[..., 7] == 3) | (want[..., 7] >= 7)
  assert (valid[:, 40:] & lights[:, 40:]).sum() == 16   # 8 light slots full


def test_render_camera_matches_jax(scene_batch, jax_kernel_path):
  (j_maps, j_scene, j_state), (maps, _, scene, state) = scene_batch
  grid = camera_ray_grid(CFG, scale=8)                      # 32 x 128
  want = j_camera.render_camera(JCFG, j_maps, j_scene, j_state, grid)
  got = render_camera(CFG, maps, scene, state, grid)
  sem_w = np.asarray(want["semantic"])
  assert (sem_w == 1).sum() > 20        # the parked vehicle is in view
  # sin/cos of the ego yaw come from two libraries and may differ by an
  # ulp, which moves a ray's hit distance by a few ulps: rtol 1e-5; the
  # classes (box hits and ground raster lookups) are equal
  np.testing.assert_array_equal(got["semantic"].numpy(), sem_w)
  np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]),
                             rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]),
                             rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("half", [0, 1])
def test_render_lidar_matches_jax(scene_batch, jax_kernel_path, half):
  (j_maps, j_scene, j_state), (maps, _, scene, state) = scene_batch
  grid = lidar_ray_grid(CFG, half=half, decimate=16)        # 64 x 29
  B, N = 2, grid.shape[0] * grid.shape[1]
  rng = jax.random.key(7)
  pts_w, val_w = j_lidar.render_lidar(JCFG, j_maps, j_scene, j_state, grid,
                                      rng)
  uniform = torch.from_numpy(np.array(jax.random.uniform(rng, (B, N))))
  pts, val = render_lidar(CFG, maps, scene, state, grid, uniform=uniform)
  np.testing.assert_array_equal(val.numpy(), np.asarray(val_w))
  assert np.asarray(val_w).sum() > 100
  # as for the camera: an ulp of sin/cos moves a return by a few ulps
  np.testing.assert_allclose(pts.numpy(), np.asarray(pts_w), rtol=1e-5,
                             atol=1e-5)


def test_render_lidar_per_episode_grid(scene_batch):
  """per_episode=True takes one direction set per episode, as the sensor
  agent passes it (front half for one episode, rear for the other)."""
  _, (maps, _, scene, state) = scene_batch
  front = torch.from_numpy(lidar_ray_grid(CFG, 0, 16)).reshape(-1, 3)
  rear = torch.from_numpy(lidar_ray_grid(CFG, 1, 16)).reshape(-1, 3)
  u = torch.rand((2, front.shape[0]),
                 generator=torch.Generator().manual_seed(0))
  pts, val = render_lidar(CFG, maps, scene, state,
                          torch.stack([front, rear]), uniform=u,
                          per_episode=True)
  for b, g in ((0, front), (1, rear)):
    pts_b, val_b = render_lidar(CFG, maps, scene, state, g.numpy(),
                                uniform=u)
    np.testing.assert_array_equal(val[b].numpy(), val_b[b].numpy())
    np.testing.assert_array_equal(pts[b].numpy(), pts_b[b].numpy())


def test_voxelize_counts_equal_jax():
  rng = np.random.default_rng(0)
  B, N = 2, 6000
  pts = np.stack([rng.uniform(-40, 40, (B, N)), rng.uniform(-40, 40, (B, N)),
                  rng.uniform(-1, 3, (B, N))], -1).astype(np.float32)
  # exact cell edges, points in the (-1, 0) cells just below the grid's
  # origin (truncation toward zero counts them in cell 0), and a cell
  # that overflows the 5-point cap
  pts[:, :200, :2] = rng.integers(-128, 129, (B, 200, 2)) * 0.25
  pts[:, 200:300, :2] = -32.0 - rng.uniform(0, 0.24, (B, 100, 2))
  pts[:, 300:320, :2] = 1.1
  pts[:, 320:330, 2] = CFG.sensor.lidar_split_height
  valid = rng.uniform(size=(B, N)) > 0.1
  want = np.stack([np.asarray(j_voxelize(pts[b], valid[b], JCFG))
                   for b in range(B)])
  got = voxelize(torch.from_numpy(pts), torch.from_numpy(valid), CFG)
  # integer counts clipped at 5 and divided by 5: exactly equal
  np.testing.assert_array_equal(got.numpy(), want)
  assert (want == 1.0).any() and (want[:, :, 0, 0] > 0).any()
