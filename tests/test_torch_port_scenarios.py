"""Port parity: the scenario engine and the scene builder, torch vs JAX on
the CPU.

Triggers and ``scenario_step`` run on hand-made specs of every kind,
including the force-trigger failsafe; booleans and integers are equal,
floats agree to 1e-6. ``sim_step`` with scenarios runs 40 ticks of the
expert on a JAX-built scenario scene, with JAX's own draws replayed into
the port (``split(state.rng, 3)`` a tick: the expert's steer noise from
the second key, the control-loss noise from the third, episode.py:51);
floats agree to 1e-4, as slice 2's expert tests allow. The port's builder
(``make_synthetic_batch``, ``make_town_batch("synth", use_scenarios=True)``)
gives JAX's arrays bit for bit, scenario specs included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG
from carla_garage_tpu.maps import native_router as j_native
from carla_garage_tpu.maps import routing as j_routing
from carla_garage_tpu.sim import episode as j_episode
from carla_garage_tpu.sim import scenarios as j_scn
from carla_garage_tpu.sim import scene_builder as j_sb
from carla_garage_tpu.sim import triggers as j_trig
from carla_garage_tpu_torch.config import DEFAULT_CONFIG
from carla_garage_tpu_torch.maps import native_router, routing
from carla_garage_tpu_torch.maps.town_map import LaneGraph, Layer, MapStack
from carla_garage_tpu_torch.sim import scenarios, scene_builder, triggers
from carla_garage_tpu_torch.sim.episode import sim_step
from carla_garage_tpu_torch.structs import (ScenarioSpecs, ScenarioState,
                                            Scene, SimState, tree_items)
from test_torch_port_scene import jax_batch_to_port, jax_leaves, to_port

B, K, V = 2, 8, 16
T = lambda a: torch.from_numpy(np.array(a))
JC = JCFG.replace(sim=dataclasses.replace(JCFG.sim, max_vehicles=V))
CFG = DEFAULT_CONFIG.replace(sim=dataclasses.replace(DEFAULT_CONFIG.sim,
                                                     max_vehicles=V))
ST = j_scn.ScenarioType


def assert_leaves(want: dict, got: dict, rtol, atol, what=""):
  """Leaf dicts {path: array}: floats to the tolerance, ints and bools
  equal, dtypes and shapes equal."""
  assert set(want) == set(got), (what, set(want) ^ set(got))
  for key, w in want.items():
    g = np.asarray(got[key])
    assert g.dtype == w.dtype and g.shape == w.shape, (what, key)
    if w.dtype.kind in "biu":
      np.testing.assert_array_equal(g, w, err_msg=f"{what}{key}")
    else:
      np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                 err_msg=f"{what}{key}")


def test_triggers_match_jax():
  """Every predicate and the dispatch on random [B,K] rows, an unknown
  kind (9) included, which is False."""
  rng = np.random.default_rng(0)
  n = (4, 64)
  f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
  kind = rng.integers(0, 5, n).astype(np.int32)
  kind[0, :4] = 9
  pos, target = f(4, 1, 2) * 20, f(*n, 2) * 20
  speed = np.abs(f(4, 1)) * 5
  speed[0] = 0.0                                  # a stopped ego
  dist, param = np.abs(f(*n)) * 20, np.abs(f(*n)) * 4
  ext = np.abs(f(*n, 2)) * 15
  args = (kind, pos, speed, target, dist, param, ext)
  want = np.asarray(j_trig.evaluate(*args))
  got = triggers.evaluate(*map(T, args)).numpy()
  np.testing.assert_array_equal(got, want)
  assert 0 < want.mean() < 1 and not want[0, :4].any()
  for name, a in (("in_trigger_distance", (pos, target, dist)),
                  ("in_time_to_arrival", (pos, speed, target, param)),
                  ("in_trigger_region", (pos, target, ext)),
                  ("trigger_velocity", (speed, param))):
    np.testing.assert_array_equal(getattr(triggers, name)(*map(T, a)).numpy(),
                                  np.asarray(getattr(j_trig, name)(*a)),
                                  err_msg=name)


TOWN_ARGS = dict(batch=B, seed=1, n_vehicles=6, n_walkers=2,
                 use_scenarios=True)


@pytest.fixture(scope="module")
def built():
  """make_town_batch("synth", use_scenarios=True) of both packages:
  (town, maps, lanes, scene, state) each."""
  return (j_sb.make_town_batch(JC, "synth", **TOWN_ARGS),
          scene_builder.make_town_batch(CFG, "synth", device="cpu",
                                        **TOWN_ARGS))


@pytest.fixture(scope="module")
def scene_batch(built):
  """The JAX-built scenario scene (B=2, 16 vehicle slots) with its free
  spec rows 5-7 given rows that arm within the first ticks: CONTROL_LOSS
  on a distance trigger at the route's start, FOLLOW_LEADING on vehicle 0
  once the ego moves faster than 2 m/s, OTHER_LEADING on vehicle 1 in a
  region around the start. The ego starts at 4 m/s."""
  _, maps, lanes, scene, state = built[0]
  sp = scene.scenarios
  assert not bool(sp.valid[:, 5:].any())
  start = scene.route.points[:, 8]

  def row(sp, k, **kw):
    return sp.replace(**{n: getattr(sp, n).at[:, k].set(v)
                         for n, v in dict(valid=True, **kw).items()})

  sp = row(sp, 5, kind=ST.CONTROL_LOSS, trigger_pos=start,
           trigger_dist=15.0, magnitude=0.2, duration=30)
  sp = row(sp, 6, kind=ST.FOLLOW_LEADING, trigger_kind=j_trig.TriggerKind.
           VELOCITY, trigger_param=2.0, actor_slot=0, duration=25)
  sp = row(sp, 7, kind=ST.OTHER_LEADING, trigger_kind=j_trig.TriggerKind.
           REGION, trigger_pos=start, trigger_extent=jnp.asarray([30.0,
                                                                  30.0]),
           actor_slot=1, magnitude=1.0, duration=200)
  scene = scene.replace(scenarios=sp)
  state = state.replace(ego=state.ego.replace(speed=jnp.full((B,), 4.0)))
  return (maps, lanes, scene, state), jax_batch_to_port(maps, lanes, scene,
                                                        state)


def _hand_specs(ego_pos, ego_yaw):
  """Specs of every kind on B=2 episodes: an unreachable
  JUNCTION_CROSSING row whose actor (vehicle 0) waits dead ahead (the
  failsafe's case), CONTROL_LOSS, FOLLOW_LEADING and OTHER_LEADING rows
  near the ego, an OPPOSITE_DIRECTION row on a TTA trigger, a
  CROSSING_WALKER row on a velocity trigger, a FOLLOW_LEADING row without
  an actor (slot -1, which must not alias vehicle 0) and an invalid
  row."""
  fwd = np.stack([np.cos(ego_yaw), np.sin(ego_yaw)], -1)
  sp = j_scn.make_empty_specs(B, K)
  kinds = [ST.JUNCTION_CROSSING, ST.CONTROL_LOSS, ST.FOLLOW_LEADING,
           ST.OTHER_LEADING, ST.OPPOSITE_DIRECTION, ST.CROSSING_WALKER,
           ST.FOLLOW_LEADING, ST.OTHER_LEADING]
  tpos = ego_pos[:, None] + fwd[:, None] * np.array(
      [1000.0, 5.0, 10.0, 0.0, 30.0, 3.0, 0.0, 0.0])[None, :, None]
  return sp.replace(
      kind=jnp.asarray(np.tile(kinds, (B, 1)), jnp.int32),
      trigger_pos=jnp.asarray(tpos, jnp.float32),
      trigger_dist=jnp.full((B, K), 12.0),
      trigger_kind=jnp.asarray(np.tile([0, 0, 0, 2, 1, 3, 0, 0], (B, 1)),
                               jnp.int32),
      trigger_param=jnp.asarray(np.tile([0, 0, 0, 0, 6.0, 0.5, 0, 0],
                                        (B, 1)), jnp.float32),
      actor_slot=jnp.asarray(np.tile([0, -1, 2, 3, 4, -1, -1, 5], (B, 1)),
                             jnp.int32),
      duration=jnp.asarray(np.tile([60, 8, 40, 200, 50, 20, 20, 20],
                                   (B, 1)), jnp.int32),
      magnitude=jnp.asarray(np.tile([0, 0.3, 0, 2.5, 0, 0, 1.5, 0],
                                    (B, 1)), jnp.float32),
      valid=jnp.asarray(np.tile([1, 1, 1, 1, 1, 1, 1, 0], (B, 1)), bool))


def test_scenario_step_matches_jax(scene_batch):
  """63 steps from a stopped ego with vehicle 0 parked 7 m dead ahead: the
  waiting actor is held at speed 0 for 3 s, then the failsafe fires. The
  ego then drives off at 3 m/s, 8 m a step, arming the TTA and velocity
  rows."""
  (_, _, _, j_state), _ = scene_batch
  ego = j_state.ego
  fwd = jnp.stack([jnp.cos(ego.yaw), jnp.sin(ego.yaw)], -1)
  veh = j_state.vehicles
  st = j_state.replace(
      ego=ego.replace(speed=jnp.zeros((B,))),
      vehicles=veh.replace(pos=veh.pos.at[:, 0].set(ego.pos + 7.0 * fwd),
                           speed=veh.speed.at[:, 0].set(0.0),
                           valid=veh.valid.at[:, 0].set(True)))
  specs = _hand_specs(np.asarray(ego.pos), np.asarray(ego.yaw))
  t_specs = to_port(specs, ScenarioSpecs)
  j_step = jax.jit(lambda sst, s, r: j_scn.scenario_step(JC, specs, sst, s,
                                                         r))
  j_sst = j_scn.scenarios_reset(B, K)
  t_sst = scenarios.scenarios_reset(B, K, device="cpu")
  key = jax.random.key(11)
  fires = 3 * JC.sim.fps
  for t in range(fires + 3):
    if t > fires:                      # the ego drives off
      st = st.replace(ego=st.ego.replace(pos=st.ego.pos + 8.0 * fwd,
                                         speed=jnp.full((B,), 3.0)))
    key, sub = jax.random.split(key)
    j_sst, j_eff = j_step(j_sst, st, sub)
    t_sst, t_eff = scenarios.scenario_step(
        CFG, t_specs, t_sst, to_port(st, SimState),
        control_loss=T(jax.random.normal(sub, (B, K))))
    assert_leaves(jax_leaves(j_sst, ScenarioState, ""),
                  dict(tree_items(t_sst, "")), 0, 0, f"step {t}: ")
    assert_leaves({k: np.asarray(v) for k, v in j_eff.items()},
                  {k: v.numpy() for k, v in t_eff.items()}, 1e-6, 1e-6,
                  f"step {t}: effects/")
    held = float(t_eff["npc_speed_cap"][0, 0])
    assert (held == 0.0) == (t < fires - 1), (t, held)
  trig = t_sst.triggered.numpy()
  assert trig[:, :7].all() and not trig[:, 7].any()   # row 7 is invalid
  # the actorless FOLLOW_LEADING row (6) is active and brakes no vehicle
  assert t_sst.ticks_active.numpy()[:, 6].min() > 0
  assert not bool(t_eff["npc_brake_override"][:, 0].any())


def test_traffic_step_effects_match_jax(scene_batch):
  """traffic_step with scenario effects: forced braking, speed caps (0 for
  a held actor, +inf for none) and the deadlock exemption of held actors
  (standstill counters past 800 ticks)."""
  from carla_garage_tpu.sim import traffic as j_tr
  from carla_garage_tpu_torch.sim.traffic import traffic_step
  from carla_garage_tpu_torch.structs import VehicleStates
  (_, j_lanes, j_scene, j_state), (_, lanes, scene, state) = scene_batch
  rng = np.random.default_rng(5)
  veh = j_state.vehicles
  speed = rng.uniform(0, 6, veh.speed.shape).astype(np.float32)
  speed[:, ::3] = 0.0
  j_state = j_state.replace(vehicles=veh.replace(
      speed=jnp.asarray(speed),
      stand_ticks=jnp.asarray(rng.choice([0, 500, 801], veh.speed.shape),
                              jnp.int32)))
  cap = rng.choice([0.0, 1.5, np.inf], veh.speed.shape).astype(np.float32)
  effects = {"steer_noise": np.zeros((B,), np.float32),
             "npc_brake_override": rng.uniform(size=veh.speed.shape) < 0.3,
             "npc_speed_cap": cap}
  want = jax.jit(j_tr.traffic_step, static_argnums=0)(
      JC, j_lanes, j_scene, j_state, {k: jnp.asarray(v)
                                      for k, v in effects.items()})
  got = traffic_step(CFG, lanes, scene, to_port(j_state, SimState),
                     {k: T(v) for k, v in effects.items()})
  assert_leaves(jax_leaves(want, VehicleStates, ""),
                dict(tree_items(got, "")), 1e-5, 1e-4)
  # held actors brake, and one standing past 800 ticks is not despawned
  valid = np.asarray(veh.valid)
  held = (cap == 0.0) & valid & (speed > 0.5)
  assert held.any() and (got.speed.numpy()[held] < speed[held]).all()
  stuck = valid & (speed == 0.0) & (np.asarray(j_state.vehicles.stand_ticks)
                                    == 801)
  assert (stuck & (cap == 0.0)).any() and (stuck & (cap > 0.01)).any()
  np.testing.assert_array_equal(got.valid.numpy()[stuck], cap[stuck] == 0.0)


def test_sim_step_with_scenarios_matches_jax(scene_batch):
  """40 expert ticks through sim_step with scenarios, every state leaf
  compared after every tick."""
  (j_maps, j_lanes, j_scene, j_state), (maps, lanes, scene, state) = \
      scene_batch
  assert isinstance(scene.scenarios, ScenarioSpecs)
  j_step = jax.jit(lambda st: j_episode.sim_step(JC, j_maps, j_lanes,
                                                 j_scene, st))
  rng, st = j_state.rng, state
  for i in range(40):
    rng, r_step, r_scn = jax.random.split(rng, 3)
    draws = {"steer_noise": T(jax.random.normal(r_step, (B,))),
             "control_loss": T(jax.random.normal(r_scn, (B, K)))}
    j_state = j_step(j_state)
    st = sim_step(CFG, maps, lanes, scene, st, draws=draws)
    assert_leaves(jax_leaves(j_state, SimState, ""), dict(tree_items(st, "")),
                  1e-4, 1e-4, f"tick {i}: ")
  trig = st.scenario.triggered.numpy()
  assert trig[:, 5:].all(), trig                  # the hand-made rows armed
  assert int(st.scenario.ticks_active[:, 5].min()) == 30
  assert float(st.ego.speed.max()) > 1.0


def test_make_synthetic_batch_matches_jax_bit_for_bit(built):
  """Routes sampled on the packages' own (equal) towns."""
  (j_town, *_), (t_town, *_) = built
  kw = dict(batch=3, seed=3, n_vehicles=6, n_walkers=2)
  j = j_sb.make_synthetic_batch(JC, town=j_town, **kw)
  t = scene_builder.make_synthetic_batch(CFG, town=t_town, device="cpu",
                                         **kw)
  _compare_batches(j[1:], t[1:], expect_scenarios=False)


def test_make_town_batch_with_scenarios_matches_jax_bit_for_bit(built,
                                                               tmp_path,
                                                               monkeypatch):
  j, t = built
  _compare_batches(j[1:], t[1:], expect_scenarios=True)
  kinds = set(t[3].scenarios.kind[t[3].scenarios.valid].tolist())
  assert {ST.FOLLOW_LEADING, ST.OTHER_LEADING,
          ST.JUNCTION_CROSSING} <= kinds, kinds
  # an imported town name: built from an asset root, refused from none
  from test_torch_port_importer import write_asset_root
  monkeypatch.setenv("CGT_TOWN_CACHE", str(tmp_path / "cache"))
  root = str(tmp_path / "reference")
  write_asset_root(root)
  town, *_, scene, _ = scene_builder.make_town_batch(
      CFG, "Town02", batch=2, min_route_m=90.0, max_route_m=200.0,
      assets_root=root, use_scenarios=True, device="cpu")
  assert town.raster.shape == (9, 600, 360)
  assert scene.scenarios.valid.any()
  with pytest.raises(OSError):
    scene_builder.make_town_batch(CFG, "Town01", device="cpu",
                                  assets_root=str(tmp_path / "absent"))


@pytest.mark.parametrize("kw", [
    dict(pad_hw=(1800, 1760)),
    # a window smaller than the 1680x1680 town: routes that would overflow
    # it are drawn again, and the world offset moves with the crop
    dict(crop_hw=(1280, 1280), crop_margin_m=40.0, min_route_m=150.0)],
    ids=["pad", "crop"])
def test_make_town_batch_pad_and_crop_match_jax_bit_for_bit(kw):
  """The padded and the route-cropped rasters, as the training script's
  multi-town runs ask for them, at B=2 with scenarios."""
  args = dict(TOWN_ARGS, seed=2, **kw)
  j = j_sb.make_town_batch(JC, "synth", **args)
  t = scene_builder.make_town_batch(CFG, "synth", device="cpu", **args)
  np.testing.assert_array_equal(t[0].raster, j[0].raster)
  np.testing.assert_array_equal(t[0].world_offset, j[0].world_offset)
  want_hw = kw.get("pad_hw") or kw["crop_hw"]
  assert t[0].raster.shape[1:] == want_hw
  assert ("crop_hw" in kw) == bool(t[0].world_offset.any())
  _compare_batches(j[1:], t[1:], expect_scenarios=True)


def _compare_batches(j, t, expect_scenarios):
  n = 0
  for name, jx, cls, port in zip(("maps", "lanes", "scene", "state"), j,
                                 (MapStack, LaneGraph, Scene, SimState), t):
    want = jax_leaves(jx, cls, name)
    got = dict(tree_items(port, name))
    assert set(want) == set(got), (name, set(want) ^ set(got))
    for key, w in want.items():
      g = got[key].numpy()
      assert g.dtype == w.dtype and g.shape == w.shape, key
      np.testing.assert_array_equal(g, w, err_msg=key)
      n += 1
  assert n > 100
  assert any("/scenarios/" in k for k in dict(tree_items(t[2], "scene"))) \
      == expect_scenarios


def test_router_takes_the_jax_path(built):
  """Both packages load the same native router or both fall back to
  scipy, and route the same long gap to the same dense path."""
  assert native_router.available() == j_native.available()
  (j_town, *_), (t_town, *_) = built
  np.testing.assert_array_equal(t_town.raster, j_town.raster)
  road = lambda tw: tw.raster[Layer.ROAD] > 0
  j_r = j_routing.RoadRouter(road(j_town), j_town.ppm, j_town.world_offset)
  t_r = routing.RoadRouter(road(t_town), t_town.ppm, t_town.world_offset)
  a, b = np.float32([30.0, 31.75]), np.float32([272.0, 388.25])
  np.testing.assert_array_equal(t_r.route(a, b), j_r.route(a, b))
  xy = np.float32([[20.0, 31.75], [85.0, 31.75], [146.25, 60.0]])
  yaw = np.float32([0.0, 0.0, np.pi / 2])
  np.testing.assert_array_equal(
      routing.interpolate_keypoints_routed(xy, yaw, t_r),
      j_routing.interpolate_keypoints_routed(xy, yaw, j_r))
