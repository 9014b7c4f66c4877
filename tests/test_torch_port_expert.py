"""Port parity: the privileged expert and expert datagen, torch vs JAX on
the CPU.

The same scene (from the JAX builder, with traffic moved so that the
vehicle, walker and safety-box hazards fire) goes through the JAX package
and the port; the JAX side's steer-noise draws (``split(state.rng, 3)``
per tick, episode.py:51, expert.py:434) are replayed into the port.
Floats agree to 1e-4: sin/cos, atan and the forecast's cumulative sums
differ by an ulp or so between XLA and PyTorch, carried over the ticks;
ints and bools are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG
from carla_garage_tpu.sim import datagen as j_dg
from carla_garage_tpu.sim import episode as j_episode
from carla_garage_tpu.sim import expert as j_ex
from carla_garage_tpu.sim.scene_builder import make_synthetic_batch
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.sim import datagen, expert
from carla_garage_tpu_torch.sim.episode import rollout, sim_step
from carla_garage_tpu_torch.structs import ExpertState, SimState, tree_items
from test_torch_port_scene import jax_batch_to_port, jax_leaves

B = 2
T = lambda a: torch.from_numpy(np.array(a))


def assert_tree_close(want: dict, got: dict, what=""):
  """Leaf dicts {path: array}: floats to 1e-4, ints and bools equal."""
  assert set(want) == set(got), (what, set(want) ^ set(got))
  for key, w in want.items():
    g = np.asarray(got[key])
    assert g.dtype == w.dtype and g.shape == w.shape, (what, key)
    if w.dtype.kind in "biu":
      np.testing.assert_array_equal(g, w, err_msg=f"{what}{key}")
    else:
      np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                 err_msg=f"{what}{key}")


def steer_draws(rng):
  """The JAX tick's expert draw and the key the next tick starts from."""
  rng, rng_step, _ = jax.random.split(rng, 3)
  return rng, {"steer_noise": T(jax.random.normal(rng_step, (B,)))}


@pytest.fixture(scope="module")
def batch():
  """Two episodes in motion: episode 0 has a vehicle 9 m ahead on its
  lane and a second one across its path; episode 1 a walker 6 m ahead that
  the expert has seen; NPC speeds random."""
  _, maps, lanes, scene, state = make_synthetic_batch(
      JCFG, batch=B, seed=4, n_vehicles=12, n_walkers=2)
  rng = np.random.default_rng(4)
  ego = state.ego.replace(speed=jnp.asarray([6.0, 4.0]))
  fwd = jnp.stack([jnp.cos(ego.yaw), jnp.sin(ego.yaw)], -1)
  veh = state.vehicles
  veh = veh.replace(
      speed=jnp.asarray(rng.uniform(0, 6, veh.speed.shape),
                        jnp.float32) * veh.valid,
      pos=veh.pos.at[0, 0].set(ego.pos[0] + 9.0 * fwd[0])
      .at[0, 1].set(ego.pos[0] + 14.0 * fwd[0] + 3.0),
      yaw=veh.yaw.at[0, 0].set(ego.yaw[0]).at[0, 1].set(ego.yaw[0] + 1.5),
      valid=veh.valid.at[0, 0].set(True).at[0, 1].set(True))
  wlk = state.walkers
  wlk = wlk.replace(pos=wlk.pos.at[1, 0].set(ego.pos[1] + 6.0 * fwd[1]),
                    valid=wlk.valid.at[1, 0].set(True),
                    seen_frames=wlk.seen_frames.at[1, 0].set(3))
  ex = state.expert.replace(target_speed=jnp.asarray([8.0, 5.0]))
  state = state.replace(ego=ego, vehicles=veh, walkers=wlk, expert=ex)
  return (maps, lanes, scene, state), jax_batch_to_port(maps, lanes, scene,
                                                        state)


def test_expert_step_matches_jax(batch):
  (j_maps, _, j_scene, j_state), (maps, _, scene, state) = batch
  rng = jax.random.key(9)
  j_ctl, j_upd = jax.jit(lambda st, r: j_ex.expert_step(
      JCFG, j_maps, j_scene, st, r))(j_state, rng)
  noise = T(jax.random.normal(rng, (B,)))
  ctl, upd = expert.expert_step(CFG, maps, scene, state,
                                draws={"steer_noise": noise})
  assert_tree_close(jax_leaves(j_upd["expert"], ExpertState, ""),
                    dict(tree_items(upd["expert"], "")), "expert")
  for name in ("steer", "throttle", "brake"):
    assert_tree_close({name: np.asarray(getattr(j_ctl, name))},
                      {name: getattr(ctl, name).numpy()}, "control/")
  # the scene was set up so that hazards fire
  assert bool(upd["expert"].vehicle_hazard[0])
  assert bool(upd["expert"].walker_hazard[1])


def test_expert_step_draws_from_the_generator(batch):
  _, (maps, _, scene, state) = batch
  runs = [expert.expert_step(CFG, maps, scene, state,
                             generator=torch.Generator().manual_seed(3))
          for _ in range(2)]
  assert torch.equal(runs[0][0].steer, runs[1][0].steer)
  with pytest.raises(KeyError, match="unknown draws"):
    expert.expert_step(CFG, maps, scene, state, draws={"gps": None})


def test_expert_rollout_matches_jax(batch):
  """12 ticks of the expert through sim_step, state compared leaf for leaf
  after every tick; then rollout, whose default policy is the expert,
  against sim_step fed the same generator's draws."""
  (j_maps, j_lanes, j_scene, j_state), (maps, lanes, scene, state) = batch
  j_step = jax.jit(lambda st: j_episode.sim_step(JCFG, j_maps, j_lanes,
                                                 j_scene, st))
  rng, draws = j_state.rng, []
  for _ in range(12):
    rng, d = steer_draws(rng)
    draws.append(d)
  st = state
  for i in range(12):
    j_state = j_step(j_state)
    st = sim_step(CFG, maps, lanes, scene, st, draws=draws[i])
    assert_tree_close(jax_leaves(j_state, SimState, ""),
                      dict(tree_items(st, "")), f"tick {i}: ")
  assert int(st.tick.min()) == 12
  final = rollout(CFG, maps, lanes, scene, state, 3,
                  generator=torch.Generator().manual_seed(6))
  gen, stepped = torch.Generator().manual_seed(6), state
  for _ in range(3):
    stepped = sim_step(CFG, maps, lanes, scene, stepped, draws={
        "steer_noise": torch.randn((B,), generator=gen)})
  for (path, a), (_, b) in zip(tree_items(final), tree_items(stepped)):
    assert torch.equal(a, b), path
  assert float(st.ego.speed.max()) > 0.5


def test_collect_expert_frames_matches_jax(batch):
  (j_maps, j_lanes, j_scene, j_state), (maps, lanes, scene, state) = batch
  n_frames = 3
  j_final, j_frames = jax.jit(lambda st: j_dg.collect_expert_frames(
      JCFG, j_maps, j_lanes, j_scene, st, n_frames=n_frames))(j_state)
  rng, draws = j_state.rng, []
  for _ in range(n_frames * datagen.SAVE_FREQ):
    rng, d = steer_draws(rng)
    draws.append(d)
  final, frames = datagen.collect_expert_frames(
      CFG, maps, lanes, scene, state, n_frames, draws=draws)
  assert_tree_close(jax_leaves(j_frames, datagen.Frames, ""),
                    dict(tree_items(frames, "")), "frames")
  assert_tree_close(jax_leaves(j_final, SimState, ""),
                    dict(tree_items(final, "")), "final")
  assert frames.ego_pos.shape == (n_frames, B, 2)

  # the label functions on these frames
  j_wp, j_valid = j_dg.waypoint_labels(j_frames)
  wp, valid = datagen.waypoint_labels(frames)
  assert_tree_close({"wp": np.asarray(j_wp), "valid": np.asarray(j_valid)},
                    {"wp": wp.numpy(), "valid": valid.numpy()}, "wp/")
  for look in (0, 2):
    np.testing.assert_array_equal(
        datagen.target_speed_labels(frames, CFG, look).numpy(),
        np.asarray(j_dg.target_speed_labels(j_frames, JCFG, look)))
  assert_tree_close(
      {"ckpt": np.asarray(j_dg.checkpoint_labels(j_frames, j_scene, 10))},
      {"ckpt": datagen.checkpoint_labels(frames, scene, 10).numpy()},
      "ckpt/")
