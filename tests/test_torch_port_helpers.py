"""Port parity: the four small public helpers of the JAX package that the
port's main paths do not call, against their JAX functions on seeded
numpy inputs: ``sim/route_planner.planner_reset``,
``sim/dynamics.forward_speed``, ``sim/geometry.rot2d`` and the
``utils/watchdog.watchdog`` context manager."""

import time

import numpy as np
import pytest
import torch

from carla_garage_tpu.sim import dynamics as j_dyn
from carla_garage_tpu.sim import geometry as j_geo
from carla_garage_tpu.sim import route_planner as j_rp
from carla_garage_tpu.utils import watchdog as j_wd
from carla_garage_tpu_torch.sim import dynamics, geometry, route_planner
from carla_garage_tpu_torch.utils import watchdog

RNG = np.random.default_rng(11)


@pytest.mark.parametrize("shape", [(), (3,), (2, 5)])
def test_planner_reset_matches_jax(shape):
  got = route_planner.planner_reset(shape, device="cpu")
  want = j_rp.planner_reset(shape)
  for name, dtype in (("idx", torch.int32), ("is_last", torch.bool)):
    g, w = getattr(got, name), np.asarray(getattr(want, name))
    assert g.dtype == dtype and g.device.type == "cpu"
    assert tuple(g.shape) == w.shape
    np.testing.assert_array_equal(g.numpy(), w)


def test_forward_speed_matches_jax():
  vel = RNG.normal(0, 8, (4, 7, 2)).astype(np.float32)
  yaw = RNG.uniform(-np.pi, np.pi, (4, 7)).astype(np.float32)
  got = dynamics.forward_speed(torch.from_numpy(vel), torch.from_numpy(yaw))
  np.testing.assert_allclose(got.numpy(), j_dyn.forward_speed(vel, yaw),
                             rtol=0, atol=1e-6)


def test_rot2d_matches_jax():
  yaw = RNG.uniform(-np.pi, np.pi, (3, 5)).astype(np.float32)
  got = geometry.rot2d(torch.from_numpy(yaw))
  assert tuple(got.shape) == (3, 5, 2, 2)
  np.testing.assert_allclose(got.numpy(), j_geo.rot2d(yaw), rtol=0,
                             atol=1e-6)


@pytest.mark.parametrize("port", [True, False], ids=["port", "jax"])
def test_watchdog_trips_on_a_short_timeout_only(port):
  """Both context managers: a long timeout stays quiet over the block; a
  short one interrupts the main thread inside it and reports tripped."""
  wd = watchdog.watchdog if port else j_wd.watchdog
  with wd(5.0) as w:
    time.sleep(0.1)
  time.sleep(0.1)
  assert not w.tripped
  with pytest.raises(KeyboardInterrupt):
    with wd(0.05) as w:
      time.sleep(2.0)
  assert w.tripped
