"""Port parity: the leaf math and world update of one tick, torch vs JAX on
the CPU: UKF, route planners, the direct PID controller, NPC traffic,
walkers and the infraction criteria."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_garage_tpu.agents import controllers as j_ctl
from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG
from carla_garage_tpu.sim import criteria as j_cr
from carla_garage_tpu.sim import expert as j_ex
from carla_garage_tpu.sim import route_planner as j_rp
from carla_garage_tpu.sim import traffic as j_tr
from carla_garage_tpu.sim import ukf as j_ukf
from carla_garage_tpu.sim.scene_builder import make_synthetic_batch
from carla_garage_tpu.structs import PIDState as JPIDState
from carla_garage_tpu_torch.agents.controllers import control_pid_direct
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.sim import criteria, expert, route_planner, ukf
from carla_garage_tpu_torch.sim.traffic import traffic_step, walker_step
from carla_garage_tpu_torch.structs import (CriteriaState, PIDState,
                                            VehicleStates, WalkerStates,
                                            tree_items)
from test_torch_port_scene import jax_batch_to_port, jax_leaves, to_port

T = lambda a: torch.from_numpy(np.array(a))


def assert_struct_close(j_obj, t_obj, cls, rtol, atol, skip=()):
  want = jax_leaves(j_obj, cls, "")
  got = dict(tree_items(t_obj, ""))
  assert set(want) == set(got)
  for key, w in want.items():
    if key in skip:
      continue
    g = got[key].numpy()
    assert g.dtype == w.dtype and g.shape == w.shape, key
    if w.dtype.kind in "biu":
      np.testing.assert_array_equal(g, w, err_msg=key)
    else:
      np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=key)


def test_ukf_matches_jax():
  rng = np.random.default_rng(0)
  B = 4
  js, ts = j_ukf.ukf_reset(B), ukf.ukf_reset(B, device="cpu")
  truth = np.zeros((B, 4), np.float32)
  truth[:, 3] = rng.uniform(0, 8, B)
  for _ in range(6):
    ctl = rng.uniform(0, 1, (3, B)).astype(np.float32)
    ctl[2] = ctl[2] > 0.8
    truth[:, :2] += rng.normal(0, 0.3, (B, 2))
    truth[:, 2] += rng.normal(0, 0.05, B)
    z = (truth + rng.normal(0, [0.5, 0.5, 1e-3, 0], (B, 4))
         ).astype(np.float32)
    js = j_ukf.ukf_update(j_ukf.ukf_predict(js, *ctl, JCFG.sim), z)
    ts = ukf.ukf_update(ukf.ukf_predict(ts, *map(T, ctl), CFG.sim), T(z))
    # a 4x4 Cholesky and solve in LAPACK and in XLA, in f32, carried
    # over six filter steps: agreement to ~1e-5 of the O(1) state
    assert_struct_close(js, ts, ukf.UKFState, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def batch():
  """Two episodes with moving traffic: random NPC and ego speeds, a
  vehicle on top of episode 0's ego (a collision), and episode 1's first
  walker 5 m from its ego (a crossing trigger)."""
  _, maps, lanes, scene, state = make_synthetic_batch(
      JCFG, batch=2, seed=1, n_vehicles=16, n_walkers=2)
  rng = np.random.default_rng(1)
  veh = state.vehicles
  veh = veh.replace(speed=jnp.asarray(rng.uniform(0, 7, veh.speed.shape),
                                      jnp.float32) * veh.valid)
  ego = state.ego
  veh = veh.replace(pos=veh.pos.at[0, 0].set(ego.pos[0] + 1.0),
                    valid=veh.valid.at[0, 0].set(True))
  wlk = state.walkers
  wlk = wlk.replace(pos=wlk.pos.at[1, 0].set(ego.pos[1] + 5.0),
                    valid=wlk.valid.at[1, 0].set(True))
  state = state.replace(vehicles=veh, walkers=wlk,
                        ego=ego.replace(speed=jnp.asarray([4.0, 6.0])))
  return (maps, lanes, scene, state), jax_batch_to_port(maps, lanes, scene,
                                                        state)


def test_route_planners_match_jax(batch):
  (_, _, j_scene, j_state), (_, _, scene, state) = batch
  rng = np.random.default_rng(2)
  r, jr = scene.route, j_scene.route
  jdense = jsparse = j_rp.planner_reset((2,))
  tdense = tsparse = route_planner.planner_reset((2,), device="cpu")
  for step in range(12):
    # drive along the dense route with some lateral noise
    k = np.minimum(6 * step, np.asarray(jr.num_valid) - 1)
    pos = np.asarray(jr.points)[np.arange(2), k] + rng.normal(0, 0.5, (2, 2))
    pos = pos.astype(np.float32)
    jdense = jax.vmap(lambda st, pts, sl, nv, p: j_rp.planner_step(
        st, pts, sl, nv, p, j_ex._dense_planner_params(JCFG)))(
        jdense, jr.points, jr.seg_len, jr.num_valid, pos)
    jsparse = jax.vmap(lambda st, pts, nv, p: j_rp.planner_step(
        st, pts, j_ex._sparse_seg_len(pts, nv), nv, p,
        j_ex._sparse_planner_params(JCFG)))(
        jsparse, jr.sparse_points, jr.sparse_num_valid, pos)
    tdense = route_planner.planner_step(
        tdense, r.points, r.seg_len, r.num_valid, T(pos),
        expert._dense_planner_params(CFG))
    tsparse = route_planner.planner_step(
        tsparse, r.sparse_points,
        expert._sparse_seg_len(r.sparse_points, r.sparse_num_valid),
        r.sparse_num_valid, T(pos), expert._sparse_planner_params(CFG))
    for j, t in ((jdense, tdense), (jsparse, tsparse)):
      np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
      np.testing.assert_array_equal(t.is_last.numpy(), np.asarray(j.is_last))
    j_tp, j_cmd = jax.vmap(lambda p, c, nv, i: j_rp.route_lookup(
        p, c, nv, i, 1))(jr.sparse_points, jr.sparse_cmd,
                         jr.sparse_num_valid, jsparse.idx)
    t_tp, t_cmd = route_planner.route_lookup(
        r.sparse_points, r.sparse_cmd, r.sparse_num_valid, tsparse.idx, 1)
    np.testing.assert_array_equal(t_tp.numpy(), np.asarray(j_tp))
    np.testing.assert_array_equal(t_cmd.numpy(), np.asarray(j_cmd))
  assert int(tdense.idx.min()) > 0


def test_control_pid_direct_matches_jax():
  rng = np.random.default_rng(3)
  B, n = 8, JCFG.expert.turn_n
  jt = JPIDState(window=jnp.zeros((B, n)))
  jsp = JPIDState(window=jnp.zeros((B, n)))
  tt = PIDState.create((B,), n, device="cpu")
  tsp = PIDState.create((B,), n, device="cpu")
  for _ in range(5):
    ts = rng.choice([0.0, 2.0, 5.0, 8.0, 3.3], B).astype(np.float32)
    angle = rng.uniform(-1, 1, B).astype(np.float32)
    speed = rng.uniform(0, 9, B).astype(np.float32)
    speed[0] = 0.0
    *jo, jt, jsp = j_ctl.control_pid_direct(jt, jsp, ts, angle, speed, JCFG)
    *to, tt, tsp = control_pid_direct(tt, tsp, T(ts), T(angle), T(speed),
                                      CFG)
    # the same f32 sums over a 20-entry window in another order
    for j, t in zip(list(jo) + [jt.window, jsp.window],
                    list(to) + [tt.window, tsp.window]):
      np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                 atol=1e-6)


def test_traffic_and_walkers_match_jax(batch):
  (_, j_lanes, j_scene, j_state), (_, lanes, scene, state) = batch
  j_traffic = jax.jit(j_tr.traffic_step, static_argnums=0)
  j_walkers = jax.jit(j_tr.walker_step, static_argnums=0)
  for _ in range(3):
    j_veh = j_traffic(JCFG, j_lanes, j_scene, j_state)
    j_wlk = j_walkers(JCFG, j_scene, j_state)
    veh = traffic_step(CFG, lanes, scene, state)
    wlk = walker_step(CFG, scene, state)
    # the same f32 arithmetic; sin/cos/atan2 of two libraries may differ
    # by an ulp: rtol 1e-5 of positions up to a few hundred metres
    assert_struct_close(j_veh, veh, VehicleStates, rtol=1e-5, atol=1e-4)
    assert_struct_close(j_wlk, wlk, WalkerStates, rtol=1e-5, atol=1e-5)
    j_state = j_state.replace(vehicles=j_veh, walkers=j_wlk,
                              tick=j_state.tick + 1)
    state = state.replace(vehicles=to_port(j_veh, VehicleStates),
                          walkers=to_port(j_wlk, WalkerStates),
                          tick=state.tick + 1)
  assert bool(jnp.any(j_state.walkers.active))
  assert float(jnp.max(j_state.vehicles.speed)) > 0


def test_criteria_match_jax(batch):
  (j_maps, _, j_scene, j_state), (maps, _, scene, state) = batch
  r = np.asarray(j_scene.route.points)
  j_criteria = jax.jit(j_cr.criteria_step, static_argnums=0)
  for step in range(4):
    # the ego moves along its route, 3 m a tick, then stops; episode 0's
    # vehicle 0 sits on it (one collision, deduplicated while it lasts)
    prev = j_state.ego.pos
    k = min(3 * (step + 1), 40)
    pos = jnp.asarray(r[:, k] + [[0.3, -0.2]], jnp.float32)
    speed = jnp.asarray([6.0, 0.0 if step == 3 else 6.0])
    veh = j_state.vehicles
    veh = veh.replace(pos=veh.pos.at[0, 0].set(pos[0] + 1.0))
    j_state = j_state.replace(ego=j_state.ego.replace(pos=pos, speed=speed),
                              vehicles=veh, tick=j_state.tick + 1)
    state = state.replace(ego=state.ego.replace(pos=T(pos), speed=T(speed)),
                          vehicles=to_port(veh, VehicleStates),
                          tick=state.tick + 1)
    j_c = j_criteria(JCFG, j_maps, j_scene, prev, j_state)
    t_c = criteria.criteria_step(CFG, maps, scene, T(prev), state)
    assert_struct_close(j_c, t_c, CriteriaState, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(
        criteria.episode_done(CFG, state.replace(criteria=t_c)).numpy(),
        np.asarray(j_cr.episode_done(JCFG, j_state.replace(criteria=j_c))))
    j_state = j_state.replace(criteria=j_c)
    state = state.replace(criteria=to_port(j_c, CriteriaState))
  assert int(j_state.criteria.n_collision_vehicle[0]) == 1
  assert int(j_state.criteria.event_count[0]) >= 1
  assert int(j_state.criteria.max_route_idx.min()) > 0


def test_criteria_reset_matches_jax():
  args = (3, 5, 2, 4, 6)
  assert_struct_close(j_cr.criteria_reset(*args),
                      criteria.criteria_reset(*args, device="cpu"),
                      CriteriaState, rtol=0, atol=0)


def test_map_queries_match_jax(batch):
  (j_maps, j_lanes, _, j_state), (maps, lanes, _, state) = batch
  rng = np.random.default_rng(4)
  from carla_garage_tpu.maps.town_map import Layer
  tid = np.zeros((2,), np.int32)
  ego = np.asarray(j_state.ego.pos)
  # points around each ego, some off the raster, some on exact half-pixel
  # boundaries (round half to even on both sides)
  xy = (ego[:, None] + rng.uniform(-300, 300, (2, 400, 2))).astype(np.float32)
  xy[:, :50] = np.round(xy[:, :50] * 8) / 8
  for ch in (Layer.ROAD, Layer.OBSTACLE, Layer.LANE_DIR):
    np.testing.assert_array_equal(
        maps.sample(T(tid[:, None]), ch, T(xy)).numpy(),
        np.asarray(j_maps.sample(tid[:, None], ch, xy)))
    np.testing.assert_array_equal(
        maps.sample_value(T(tid[:, None]), ch, T(xy)).numpy(),
        np.asarray(j_maps.sample_value(tid[:, None], ch, xy)))
  # windows near and beyond the raster edge clamp their start
  for center in (ego, ego + 5000.0, ego - 5000.0):
    center = center.astype(np.float32)
    jw, jo = j_maps.window(tid, Layer.GROUND_SEM, center, 512)
    tw, to = maps.window(T(tid), Layer.GROUND_SEM, T(center), 512)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    pix = np.asarray(j_maps.world_to_pixel(tid[:, None], xy))
    np.testing.assert_array_equal(
        type(maps).sample_window(tw, to, T(pix)).numpy(),
        np.asarray(type(j_maps).sample_window(jw, jo, pix)))
  # lane polylines: positions along random lanes, past both ends too
  lid = rng.integers(0, j_lanes.points.shape[0], (2, 30)).astype(np.int32)
  t = rng.uniform(-5, 150, (2, 30)).astype(np.float32)
  jp, jy = j_lanes.position_at(lid, t)
  tp, ty = lanes.position_at(T(lid), T(t))
  # an interpolation and atan2 in f32: equal to an ulp
  np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-4)
  np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_geometry_and_dynamics_match_jax(seed):
  from carla_garage_tpu.sim import dynamics as j_dyn
  from carla_garage_tpu.sim import geometry as j_geo
  from carla_garage_tpu_torch.sim import dynamics, geometry
  rng = np.random.default_rng(seed)
  f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
  c1, c2 = f(64, 2) * 4, f(64, 2) * 4
  y1, y2 = f(64) * 3, f(64) * 3
  e1, e2 = np.abs(f(64, 2)) + 0.5, np.abs(f(64, 2)) + 0.5
  # sin/cos of two libraries: an ulp; box tests exact away from contact
  close = dict(rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(geometry.normalize_angle(T(y1 * 5)).numpy(),
                             np.asarray(j_geo.normalize_angle(y1 * 5)),
                             **close)
  for fn, args in (("world_to_ego", (c1, c2, y1)),
                   ("ego_to_world", (c1, c2, y1)),
                   ("box_corners", (c1, y1, e1)),
                   ("angle_to_target_deg", (c1, y1, c2))):
    np.testing.assert_allclose(getattr(geometry, fn)(*map(T, args)).numpy(),
                               np.asarray(getattr(j_geo, fn)(*args)),
                               err_msg=fn, **close)
  for fn, args in (("obb_intersect", (c1, y1, e1, c2, y2, e2)),
                   ("point_in_obb", (c2, c1, y1, e1))):
    np.testing.assert_array_equal(
        getattr(geometry, fn)(*map(T, args)).numpy(),
        np.asarray(getattr(j_geo, fn)(*args)), err_msg=fn)
  speed = np.abs(f(64)) * 5
  ctl = (np.clip(f(64), -1, 1), np.abs(f(64)) % 1, (f(64) > 1).astype(
      np.float32))
  want = j_dyn.bicycle_step(c1, y1, speed, *ctl, JCFG.sim)
  got = dynamics.bicycle_step(*map(T, (c1, y1, speed) + ctl), CFG.sim)
  for w, g in zip(want, got):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), **close)


def test_control_pid_matches_jax():
  from carla_garage_tpu_torch.agents.controllers import control_pid
  rng = np.random.default_rng(5)
  B, n = 8, JCFG.expert.turn_n
  jt, jsp = (JPIDState(window=jnp.zeros((B, n))) for _ in range(2))
  tt, tsp = (PIDState.create((B,), n, device="cpu") for _ in range(2))
  for _ in range(4):
    wp = np.cumsum(rng.uniform(-0.5, 2.0, (B, 8, 2)), 1).astype(np.float32)
    wp[0] = 0.0                                    # a standing plan
    speed = rng.uniform(0, 9, B).astype(np.float32)
    *jo, jt, jsp = j_ctl.control_pid(jt, jsp, wp, speed, JCFG)
    *to, tt, tsp = control_pid(tt, tsp, T(wp), T(speed), CFG)
    for j, t in zip(list(jo) + [jt.window, jsp.window],
                    list(to) + [tt.window, tsp.window]):
      # f32 window means in another order
      np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                 atol=1e-6)
