"""Port parity: PlanT's model and closed-loop agent, torch vs JAX on the CPU.

  * ``BertEncoder`` and ``PlanT`` (micro widths) against flax from
    ``load_flax_params``, every output, the 7 forecast heads included:
    1e-5 absolute (float32; flax's LayerNorm takes the variance as
    E[x^2] - E[x]^2 and ``F.layer_norm`` as E[(x - E[x])^2], which
    differ by rounding: measured about 1e-6);
  * the ``checkpoints/plant_r5/meta.json`` configuration built in the
    port, with JAX's parameter count;
  * ``privileged_flags``, ``extract_objects`` and ``extract_route`` after
    expert ticks on a scenario scene, with vehicles parked at equal
    distances from the ego (a tie that the stable sort must keep in slot
    order) and one in the ego's creep box: ints and bools equal, floats to
    1e-5;
  * 20 ticks of ``sim_step`` with the PlanT policy (direct and waypoint
    controllers, creep on, episodes stuck for a while so that the creep
    fires), JAX's control-loss draws replayed: every state leaf, ints and
    bools equal, floats to the tick tests' 1e-4. The policy draws nothing.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_garage_tpu.agents import plant_agent as j_pa
from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG0
from carla_garage_tpu.models import bert as j_bert
from carla_garage_tpu.models import plant as j_plant
from carla_garage_tpu.sim import episode as j_episode
from carla_garage_tpu.sim.scene_builder import make_town_batch
from carla_garage_tpu_torch.agents import plant_agent as pa
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG0
from carla_garage_tpu_torch.convert import load_flax_params
from carla_garage_tpu_torch.models.bert import BertEncoder
from carla_garage_tpu_torch.models.plant import PlanT, PlanTConfig, micro_plant
from carla_garage_tpu_torch.sim.episode import sim_step
from carla_garage_tpu_torch.structs import SimState, tree_items
from test_torch_port_eval import _random_params
from test_torch_port_scene import jax_batch_to_port, jax_leaves, to_port

B, V = 2, 16
T = lambda a: torch.from_numpy(np.array(a))
JCFG = JCFG0.replace(sim=dataclasses.replace(JCFG0.sim, max_vehicles=V))
CFG = CFG0.replace(sim=dataclasses.replace(CFG0.sim, max_vehicles=V))
META = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "checkpoints", "plant_r5", "meta.json")


def close(got, want, atol, what):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else \
      np.asarray(got)
  want = np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  if want.dtype.kind in "biu":
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)
  else:
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def plant_inputs(pcfg, B, seed):
  rng = np.random.default_rng(seed)
  O, R = pcfg.max_objects, pcfg.num_route_points
  return (rng.normal(0, 5, (B, O, 7)).astype(np.float32),
          rng.integers(0, 4, (B, O)).astype(np.int32),
          rng.normal(0, 10, (B, R, 2)).astype(np.float32),
          rng.integers(0, 2, B).astype(np.float32),
          rng.integers(0, 2, B).astype(np.float32),
          rng.integers(0, 2, B).astype(np.float32),
          rng.uniform(0, 8, B).astype(np.float32))


def test_bert_encoder_matches_flax():
  jm = j_bert.BertEncoder(hidden=32, n_layers=2, n_heads=4, intermediate=64,
                          max_positions=16)
  x = np.random.default_rng(0).normal(size=(3, 11, 32)).astype(np.float32)
  params = _random_params(jax.eval_shape(jm.init, jax.random.key(0), x),
                          seed=1)
  want = jax.jit(jm.apply)(params, x)
  tm = load_flax_params(BertEncoder(32, 2, 4, 64, 16),
                        jax.tree.map(np.asarray, params))
  with torch.no_grad():
    close(tm(T(x)), want, 1e-5, "bert")


@pytest.fixture(scope="module")
def micro():
  """The micro PlanT with seeded weights, in JAX and in the port."""
  pcfg = micro_plant()
  jm = j_plant.PlanT(pcfg)
  x = plant_inputs(pcfg, B, 0)
  params = _random_params(jax.eval_shape(jm.init, jax.random.key(0), *x),
                          seed=3)
  tm = load_flax_params(PlanT(pcfg), jax.tree.map(np.asarray, params))
  return pcfg, jm, params, tm


def test_plant_forward_matches_flax(micro):
  pcfg, jm, params, tm = micro
  x = plant_inputs(pcfg, 3, 5)
  want = jax.jit(jm.apply)(params, *x)
  with torch.no_grad():
    got = tm(*(T(a) for a in x))
  assert set(got) == set(want)
  for k in ("pred_wp", "pred_target_speed", "pred_checkpoint"):
    close(got[k], want[k], 1e-5, k)
  assert len(got["pred_forecast"]) == 7
  for i, (g, w) in enumerate(zip(got["pred_forecast"],
                                 want["pred_forecast"])):
    assert g.shape[-1] == pcfg.vocab_sizes[i]
    close(g, w, 1e-5, f"forecast {i}")


def test_r5_config_parameter_count_matches_jax():
  with open(META) as f:
    conf = json.load(f)["config"]
  jc = j_plant.PlanTConfig(**conf)
  x = plant_inputs(jc, 1, 0)
  shapes = jax.eval_shape(j_plant.PlanT(jc).init, jax.random.key(0), *x)
  n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
  model = PlanT(PlanTConfig(**conf))
  assert sum(p.numel() for p in model.parameters()) == n_jax
  # and the full bert-medium default
  full = j_plant.PlanTConfig()
  shapes = jax.eval_shape(j_plant.PlanT(full).init, jax.random.key(0),
                          *plant_inputs(full, 1, 0))
  assert sum(p.numel() for p in PlanT(PlanTConfig()).parameters()) == \
      sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


@pytest.fixture(scope="module")
def world():
  """A scenario scene at B=2 after 6 expert ticks, with vehicles 0 and 1
  parked at the same spot 7 m ahead of episode 0's ego (equal distances;
  different yaws and speeds, so the tie order shows) and vehicle 2 in
  episode 1's creep box."""
  _, maps, lanes, scene, state = make_town_batch(
      JCFG, "synth", batch=B, seed=5, n_vehicles=6, n_walkers=2,
      use_scenarios=True)
  state = jax.jit(lambda st: j_episode.rollout(JCFG, maps, lanes, scene, st,
                                               6))(state)
  ego = state.ego
  fwd = jnp.stack([jnp.cos(ego.yaw), jnp.sin(ego.yaw)], -1)
  veh = state.vehicles
  spot = ego.pos[0] + 7.0 * fwd[0]
  pos = veh.pos.at[0, 0].set(spot).at[0, 1].set(spot)
  pos = pos.at[1, 2].set(ego.pos[1] + (JCFG.sim.ego_extent_x + 1.25) *
                         fwd[1])
  yaw = veh.yaw.at[0, 0].set(ego.yaw[0]).at[0, 1].set(ego.yaw[0] + 1.0)
  yaw = yaw.at[1, 2].set(ego.yaw[1])
  speed = veh.speed.at[0, 0].set(0.0).at[0, 1].set(3.0)
  valid = veh.valid.at[0, :2].set(True).at[1, 2].set(True)
  state = state.replace(vehicles=veh.replace(pos=pos, yaw=yaw, speed=speed,
                                             valid=valid))
  return (maps, lanes, scene, state), jax_batch_to_port(maps, lanes, scene,
                                                        state)


def test_tokens_and_flags_match_jax(world, micro):
  (maps, lanes, scene, state), (t_maps, _, t_scene, t_state) = world
  pcfg = micro[0]
  jboxes, jtypes = j_pa.extract_objects(JCFG, pcfg, scene, state)
  boxes, types = pa.extract_objects(CFG, pcfg, t_scene, t_state)
  close(boxes, jboxes, 1e-5, "boxes")
  close(types, jtypes, 0, "types")
  # the tie: the two parked vehicles lead episode 0's tokens in slot order
  assert float(boxes[0, 0, 0]) == float(boxes[0, 1, 0]) > 6.0
  assert float(boxes[0, 0, 5]) == 0.0 and float(boxes[0, 1, 5]) == 3.0
  idx = jnp.asarray([3, 17])
  for i in (idx, jnp.asarray([0, 10_000])):
    close(pa.extract_route(pcfg, t_scene, t_state, T(i).to(torch.int32)),
          j_pa.extract_route(pcfg, scene, state, i), 1e-5, "route")
  cleared = np.zeros((B, JCFG.sim.max_stop_signs), bool)
  cleared[0, :3] = True
  want = j_pa.privileged_flags(JCFG, maps, scene, state, cleared, idx)
  got = pa.privileged_flags(CFG, t_maps, t_scene, t_state, T(cleared),
                            T(idx).to(torch.int32))
  for k, (g, w) in enumerate(zip(got, want)):
    close(g, w, 0, f"flag {k}")


def _plant_state_leaves(j_state) -> dict:
  out = jax_leaves(j_state.replace(agent=()), SimState, "")
  out.update(jax_leaves(j_state.agent, pa.PlanTAgentState, "/agent"))
  return out


@pytest.mark.parametrize("direct", [True, False])
def test_plant_ticks_match_jax(world, micro, direct):
  (maps, lanes, scene, state), (t_maps, t_lanes, t_scene, t_state) = world
  pcfg, jm, params, tm = micro
  # episode 0 stands, stuck long enough that the creep starts at once
  stuck = jnp.asarray([JCFG.expert.stuck_threshold - 2, 0], jnp.int32)
  ego0 = state.ego.replace(speed=state.ego.speed.at[0].set(0.0))
  j_state = state.replace(ego=ego0, agent=j_pa.plant_agent_reset(
      JCFG, B).replace(stuck_count=stuck))
  st = t_state.replace(ego=to_port(ego0, type(t_state.ego)),
                       agent=pa.plant_agent_reset(CFG, B, device="cpu")
                       .replace(stuck_count=T(stuck)))
  j_policy = j_pa.make_plant_policy(jm, params, pcfg, direct=direct,
                                    brake_threshold=0.33, creep=True)
  policy = pa.make_plant_policy(tm, None, pcfg, direct=direct,
                                brake_threshold=0.33, creep=True)
  j_step = jax.jit(lambda s: j_episode.sim_step(JCFG, maps, lanes, scene, s,
                                                j_policy))
  K = scene.scenarios.kind.shape[1]
  rng = j_state.rng
  gen = torch.Generator().manual_seed(0)
  creeps = 0
  for _ in range(20):
    rng, _, r_scn = jax.random.split(rng, 3)
    j_state = j_step(j_state)
    st = sim_step(CFG, t_maps, t_lanes, t_scene, st, policy, generator=gen,
                  draws={"control_loss": T(jax.random.normal(r_scn,
                                                             (B, K)))})
    creeps += int((st.agent.force_move > 0).sum())
    want = _plant_state_leaves(j_state)
    got = dict(tree_items(st, ""))
    assert set(want) == set(got)
    for key, w in want.items():
      g = got[key].numpy()
      assert g.dtype == w.dtype and g.shape == w.shape, key
      if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=key)
      else:
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=key)
  assert creeps > 0
  # the policy drew nothing from the generator
  assert torch.equal(gen.get_state(),
                     torch.Generator().manual_seed(0).get_state())
  assert int(st.agent.planner_dense.idx.max()) > 0
  with pytest.raises(KeyError):
    policy(CFG, t_maps, t_scene, st, draws={"gps": torch.zeros(B, 2)})
