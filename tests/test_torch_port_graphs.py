"""The forward's CUDA graph (``utils/cuda_graph.py``) where there is no
card: ``GraphedForward`` calls the module eagerly.

* Its outputs equal ``module.forward``'s bit for bit, and it constructs
  no CUDA graph, stream or event (all three patched to raise).
* A forward hook on the module fires once per call with that call's
  inputs and outputs.
* Under ``torch.enable_grad()`` it stays eager and autograd reaches the
  parameters.
* The sensor policy (float32, bf16 and a two-member ensemble) and the
  PlanT policy, which call their models through it, step the micro scene
  bit-equal to the same policies with the models called directly.
* The signature keys pytrees (structure, shapes, strides, dtypes, plain
  scalars), refuses what it cannot key, and holds no tensor once dropped.
* ``sim_step``, whose layers after the policy are ``GraphedStages`` on the
  card, runs them eagerly on the CPU, bit-equal to the tick as it was
  written before (``_tick_before``) with the expert, PlanT and
  TransFuser++, and its spans hold no ``graph.*`` span.

The replays themselves run only on a card: ``tests/test_torch_port_cuda.py``.
"""

import dataclasses
import gc
import weakref

import pytest
import torch

from carla_garage_tpu_torch.agents import plant_agent as pa
from carla_garage_tpu_torch.agents import sensor_agent as sa
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.models.plant import PlanT, PlanTConfig
from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
from carla_garage_tpu_torch.sim import episode
from carla_garage_tpu_torch.sim.criteria import criteria_step, episode_done
from carla_garage_tpu_torch.sim.dynamics import bicycle_step
from carla_garage_tpu_torch.sim.episode import freeze_done, sim_step
from carla_garage_tpu_torch.sim.expert import expert_step
from carla_garage_tpu_torch.sim.geometry import normalize_angle
from carla_garage_tpu_torch.sim.scenarios import scenario_step
from carla_garage_tpu_torch.sim.scene_builder import make_town_batch
from carla_garage_tpu_torch.sim.traffic import traffic_step, walker_step
from carla_garage_tpu_torch.structs import (ScenarioSpecs, ScenarioState,
                                            tree_items, tree_map)
from carla_garage_tpu_torch.utils import cuda_graph, profiling
from carla_garage_tpu_torch.utils.cuda_graph import GraphedForward

B = 2
PCFG = PlanTConfig(hidden=64, n_layers=2, n_heads=2, intermediate=256,
                   max_positions=64, max_objects=10, num_route_points=6)


@pytest.fixture(autouse=True)
def _one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture
def no_cuda(monkeypatch):
  """Constructing a CUDA graph, stream or event raises."""
  def refuse(*a, **kw):
    raise AssertionError("CUDA graph machinery used on the CPU")
  for name in ("CUDAGraph", "graph", "Stream", "Event"):
    monkeypatch.setattr(torch.cuda, name, refuse)


def _equal_trees(a, b):
  la, lb = list(tree_items(a)), list(tree_items(b))
  assert la and [k for k, _ in la] == [k for k, _ in lb]
  for (k, x), (_, y) in zip(la, lb):
    assert x.dtype == y.dtype and torch.equal(x, y), k


def _model(kind: str):
  """(module, a function of a seed that makes its inputs)."""
  torch.manual_seed(0)
  if kind == "plant":
    def inputs(seed):
      g = torch.Generator().manual_seed(seed)
      O, R = PCFG.max_objects, PCFG.num_route_points
      return (torch.randn(B, O, 7, generator=g),
              torch.randint(0, 4, (B, O), generator=g, dtype=torch.int32),
              torch.randn(B, R, 2, generator=g),
              torch.randint(0, 2, (B,), generator=g).float(),
              torch.zeros(B), torch.ones(B),
              torch.rand(B, generator=g) * 8)
    return PlanT(PCFG).eval(), inputs
  c = ttf.micro_config()

  def inputs(seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(B, c.img_h, c.img_w, 3, generator=g) * 255,
            torch.rand(B, c.lidar_h, c.lidar_w, c.lidar_channels,
                       generator=g),
            torch.randn(B, 2, generator=g) * 10,
            torch.eye(6)[torch.randint(0, 6, (B,), generator=g)],
            torch.rand(B, generator=g) * 8)
  return ttf.LidarCenterNet(c).eval(), inputs


@pytest.mark.parametrize("kind", ["plant", "tfpp"])
def test_eager_on_the_cpu_bit_equal_to_forward(kind, no_cuda):
  m, inputs = _model(kind)
  g = GraphedForward(m)
  with torch.no_grad():
    for seed in range(2):
      x = inputs(seed)
      _equal_trees(g(*x), m.forward(*x))
  assert g.graphs == {}
  assert "forward" not in m.__dict__


@pytest.mark.parametrize("kind", ["plant", "tfpp"])
def test_a_forward_hook_fires_once_a_call(kind, no_cuda):
  m, inputs = _model(kind)
  seen = []
  m.register_forward_hook(lambda mod, args, out: seen.append((args, out)))
  g = GraphedForward(m)
  with torch.no_grad():
    for seed in range(3):
      x = inputs(seed)
      out = g(*x)
      assert len(seen) == seed + 1
      args, hooked = seen[-1]
      assert len(args) == len(x)
      assert all(a is b for a, b in zip(args, x))
      assert hooked is out
  assert g.graphs == {}


def test_grad_mode_stays_eager_with_autograd(no_cuda):
  m, inputs = _model("plant")
  x = inputs(0)
  with torch.enable_grad():
    out = GraphedForward(m)(*x)
    loss = out["pred_wp"].square().sum()
    loss.backward()
  got = [p.grad.clone() for p in m.parameters() if p.grad is not None]
  m.zero_grad()
  with torch.enable_grad():
    m.forward(*x)["pred_wp"].square().sum().backward()
  want = [p.grad for p in m.parameters() if p.grad is not None]
  assert got and len(got) == len(want)
  assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_signature_refuses_what_it_cannot_key():
  """Tensors on the CPU, at the top or nested, and leaves that are neither
  tensors, plain scalars nor containers of them leave the call eager (no
  signature); plain scalars are keyed by type and value."""
  assert cuda_graph._signature(((torch.zeros(2),), {})) is None
  assert cuda_graph._signature(((1, object()), {})) is None
  assert cuda_graph._signature(((), {"x": (torch.zeros(1),)})) is None
  key, tensors = cuda_graph._signature(((1, None), {"a": "s", "b": 2.0}))
  assert tensors == []
  assert key[:7] == ((tuple, 2), (tuple, 2), (int, 1), (type(None), None),
                     (dict, ("a", "b")), (str, "s"), (float, 2.0))


@pytest.fixture(scope="module")
def scene():
  _, maps, lanes, scene, state = make_town_batch(
      CFG, "synth", batch=B, seed=0, n_vehicles=8, n_walkers=2,
      use_scenarios=True, device="cpu")
  return maps, lanes, scene, state


def _policy(kind: str, state):
  """(policy, state with its agent) at the tests' small sizes."""
  torch.manual_seed(0)
  if kind == "plant":
    policy = pa.make_plant_policy(PlanT(PCFG), None, PCFG, direct=True)
    return policy, state.replace(agent=pa.plant_agent_reset(CFG, B,
                                                            device="cpu"))
  c = dataclasses.replace(ttf.micro_config(), img_h=32, img_w=128,
                          lidar_h=256, lidar_w=256, img_anchors=(1, 4),
                          lidar_anchors=(8, 8))
  lid_f = lidar_ray_grid(CFG, half=0, decimate=16)
  lid_r = lidar_ray_grid(CFG, half=1, decimate=16)
  model = ttf.LidarCenterNet(c)
  params = None
  if kind == "tfpp_ensemble":
    params = [model.state_dict(), ttf.LidarCenterNet(c).state_dict()]
  policy = sa.make_transfuser_policy(
      model, params, c, camera_ray_grid(CFG, scale=8), lid_f, lid_r,
      direct=True, bf16=kind == "tfpp_bf16")
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  return policy, state.replace(agent=sa.sensor_agent_reset(
      CFG, B, n_lidar, device="cpu"))


def _ticks(scene, kind: str, n: int = 2):
  maps, lanes, scn, state = scene
  policy, st = _policy(kind, state)
  gen = torch.Generator().manual_seed(7)
  for _ in range(n):
    st = sim_step(CFG, maps, lanes, scn, st, policy, generator=gen)
  return st


@pytest.mark.parametrize("kind", ["plant", "tfpp", "tfpp_bf16",
                                  "tfpp_ensemble"])
def test_policies_unchanged_by_the_wrapper(scene, kind, monkeypatch,
                                           no_cuda):
  wrapped = _ticks(scene, kind)
  with monkeypatch.context() as mp:
    for mod in (pa, sa):
      mp.setattr(mod, "GraphedForward", lambda m, copy_outputs=True: m)
    direct = _ticks(scene, kind)
  _equal_trees(wrapped, direct)


class _OnCard(torch.Tensor):
  """A CPU tensor that reports itself on the card, so that trees of them
  can be keyed here."""

  @property
  def is_cuda(self):
    return True


def _card(t):
  return torch.Tensor._make_subclass(_OnCard, t)


def test_signature_keys_pytrees(scene):
  """The key holds the tree's structure, each tensor's shape, strides and
  dtype and each scalar's value, not the tensors' values; the tensors come
  in the order ``tree_map`` visits them."""
  state = scene[3]
  tree = {"state": tree_map(_card, state), "n": 3, "c": [None, 1.5]}
  key, tensors = cuda_graph._signature(tree)
  assert [id(t) for t in tensors] == [id(t) for _, t in tree_items(tree)]
  again = {"state": tree_map(lambda t: _card(torch.ones_like(t)), state),
           "n": 3, "c": [None, 1.5]}
  assert cuda_graph._signature(again)[0] == key
  ego = tree["state"].ego
  changed = [
      dict(tree, n=4),
      dict(tree, c=[None, 1.5, 2]),
      dict(tree, c=(None, 1.5)),
      {"state": tree["state"], "m": 3, "c": [None, 1.5]},
      dict(tree, state=tree["state"].replace(
          ego=ego.replace(pos=_card(ego.pos.double())))),
      dict(tree, state=tree["state"].replace(
          ego=ego.replace(pos=_card(ego.pos[:1])))),
      dict(tree, state=tree["state"].replace(
          ego=ego.replace(pos=_card(ego.pos.t().contiguous().t())))),
      dict(tree, state=tree["state"].replace(ego=(ego.pos,))),
  ]
  keys = [cuda_graph._signature(t)[0] for t in changed]
  assert all(k != key for k in keys)
  assert len(set(keys)) == len(keys)
  assert cuda_graph._signature(dict(tree, g=torch.Generator())) is None
  assert cuda_graph._signature(dict(tree, state=tree["state"].replace(
      ego=ego.replace(speed=state.ego.speed)))) is None


def test_signature_lets_its_tensors_go():
  """Keying a tree makes no reference cycle: once the caller drops the
  signature, its tensors are freed at once, not when the garbage collector
  next runs (a tick's inputs would pile up on the card until then)."""
  t = _card(torch.zeros(8))
  ref = weakref.ref(t)
  was = gc.isenabled()
  gc.disable()
  try:
    sig = cuda_graph._signature({"a": [t, (1, {"b": t})]})
    assert sig is not None and len(sig[1]) == 2
    del sig, t
    assert ref() is None
  finally:
    if was:
      gc.enable()


def _tick_before(cfg, maps, lanes, scene, state, policy, generator=None,
                 draws=None):
  """``sim_step`` as it was written before its layers after the policy
  became graph stages (its spans left out, and scenario_step's draw, which
  it made itself then, made here)."""
  draws = dict(draws or {})
  control_loss = draws.pop("control_loss", None)
  control, updates = policy(cfg, maps, scene, state, generator=generator,
                            draws=draws)
  effects = None
  if isinstance(scene.scenarios, ScenarioSpecs) and \
      isinstance(state.scenario, ScenarioState):
    if control_loss is None:      # the draw scenario_step made itself
      control_loss = torch.randn(tuple(scene.scenarios.kind.shape),
                                 generator=generator,
                                 device=state.ego.pos.device)
    new_scn, effects = scenario_step(cfg, scene.scenarios, state.scenario,
                                     state, control_loss=control_loss)
    control = control.replace(steer=control.steer + effects["steer_noise"])
    updates = dict(updates, scenario=new_scn)
  pos, yaw, speed = bicycle_step(state.ego.pos, state.ego.yaw,
                                 state.ego.speed, control.steer,
                                 control.throttle, control.brake, cfg.sim)
  new_ego = state.ego.replace(pos=pos, yaw=normalize_angle(yaw), speed=speed)
  new_veh = traffic_step(cfg, lanes, scene, state, effects)
  new_wlk = walker_step(cfg, scene, state)
  moved = state.replace(ego=new_ego, vehicles=new_veh, walkers=new_wlk,
                        tick=state.tick + 1, **updates)
  moved = moved.replace(criteria=criteria_step(cfg, maps, scene,
                                               state.ego.pos, moved))
  done = state.done | episode_done(cfg, moved)
  return freeze_done(state.done, state, moved).replace(done=done)


@pytest.mark.parametrize("kind", ["expert", "plant", "tfpp"])
@pytest.mark.parametrize("drawn", [False, True])
def test_sim_step_on_the_cpu_is_the_eager_tick(scene, kind, drawn, no_cuda):
  """Four ticks from the generator (or with the scenario draws given) equal
  the tick as written before, leaf for leaf and bit for bit, and nothing is
  captured."""
  maps, lanes, scn, state = scene
  policy, st0 = ((expert_step, state) if kind == "expert" else
                 _policy(kind, state))
  K = scn.scenarios.kind.shape[1]
  runs = []
  for step in (sim_step, _tick_before):
    gen = torch.Generator().manual_seed(7)
    loss = torch.Generator().manual_seed(11)
    st, states = st0, []
    with torch.no_grad():
      for _ in range(4):
        draws = {"control_loss": torch.randn(B, K, generator=loss)} \
            if drawn else None
        st = step(CFG, maps, lanes, scn, st, policy, generator=gen,
                  draws=draws)
        states.append(st)
    runs.append(states)
  for a, b in zip(*runs):
    _equal_trees(a, b)
  assert episode._GRAPHS.graphs == {}


def test_sim_step_spans_on_the_cpu(scene, no_cuda):
  """One tick: ``sim.tick`` around the policy's span and one span each for
  the scenarios, dynamics, traffic and criteria, in that order, and no
  ``graph.*`` span."""
  maps, lanes, scn, state = scene
  profiling.record(True)
  try:
    sim_step(CFG, maps, lanes, scn, state,
             generator=torch.Generator().manual_seed(7))
    spans = profiling.recorded()
  finally:
    profiling.record(False)
    profiling.clear()
  tick = [s for s in spans if s.name == "sim.tick"]
  assert len(tick) == 1
  layers = [s.name for s in spans if s.parent == tick[0].id]
  assert layers == ["sim.policy", "sim.scenarios", "sim.dynamics",
                    "sim.traffic", "sim.criteria"]
  assert not any(s.name.startswith("graph.") for s in spans)


def _plant_policy_before(model, pcfg, direct, brake_threshold=0.5,
                         creep=True):
  """``make_plant_policy``'s policy as it was written before its spans
  became graph stages (one eager function of the tick)."""
  from carla_garage_tpu_torch.agents.controllers import (control_pid,
                                                         control_pid_direct)
  from carla_garage_tpu_torch.device import const
  from carla_garage_tpu_torch.sim import geometry as geo
  from carla_garage_tpu_torch.sim.expert import (Control,
                                                 _dense_planner_params,
                                                 _sparse_planner_params,
                                                 _sparse_seg_len)
  from carla_garage_tpu_torch.sim.route_planner import planner_step
  model = model.eval()
  forward = GraphedForward(model)
  target_speeds = const(pa.TARGET_SPEEDS, next(model.parameters()).device)

  @torch.no_grad()
  def policy(cfg, maps, scene, state, generator=None, draws=None):
    ag = state.agent
    ego = state.ego
    route = scene.route
    pl_dense = planner_step(ag.planner_dense, route.points, route.seg_len,
                            route.num_valid, ego.pos,
                            _dense_planner_params(cfg))
    pl_sparse = planner_step(
        ag.planner_sparse, route.sparse_points,
        _sparse_seg_len(route.sparse_points, route.sparse_num_valid),
        route.sparse_num_valid, ego.pos, _sparse_planner_params(cfg))
    boxes, box_types = pa.extract_objects(cfg, pcfg, scene, state)
    route_tok = pa.extract_route(pcfg, scene, state, pl_dense.idx)
    light, stop, junction, cleared = pa.privileged_flags(
        cfg, maps, scene, state, ag.cleared_stop_signs, pl_dense.idx)
    out = forward(boxes, box_types, route_tok, light, stop, junction,
                  ego.speed)
    if direct:
      probs = torch.softmax(out["pred_target_speed"], -1)
      ts = torch.sum(probs * target_speeds, -1)
      ts = torch.where(probs[:, 0] > brake_threshold, 0.0, ts)
      aim = out["pred_checkpoint"][:, 2]
      angle = torch.rad2deg(torch.atan2(aim[:, 1], aim[:, 0])) / 90.0
      steer, throttle, brake, pt2, ps2 = control_pid_direct(
          ag.pid_turn, ag.pid_speed, ts, angle, ego.speed, cfg)
    else:
      steer, throttle, brake, pt2, ps2 = control_pid(
          ag.pid_turn, ag.pid_speed, out["pred_wp"], ego.speed, cfg)
    stuck, force = ag.stuck_count, ag.force_move
    if creep:
      e, s = cfg.expert, cfg.sim
      stuck = torch.where(ego.speed < 0.1, ag.stuck_count + 1, 0)
      start_creep = stuck > e.stuck_threshold
      force = torch.where(start_creep, e.creep_duration,
                          torch.clamp(ag.force_move - 1, min=0))
      fwd = torch.stack([torch.cos(ego.yaw), torch.sin(ego.yaw)], -1)
      box_c = ego.pos + fwd * (s.ego_extent_x + 1.25)
      box_e = torch.stack([torch.full_like(ego.yaw, 1.25),
                           torch.full_like(ego.yaw, s.ego_extent_y * 0.8)],
                          -1)
      veh, wlk = state.vehicles, state.walkers
      hit_v = geo.obb_intersect(box_c[:, None], ego.yaw[:, None],
                                box_e[:, None], veh.pos, veh.yaw,
                                veh.extent) & veh.valid
      hit_w = geo.obb_intersect(box_c[:, None], ego.yaw[:, None],
                                box_e[:, None], wlk.pos, wlk.yaw,
                                wlk.extent) & wlk.valid
      obstructed = torch.any(hit_v, -1) | torch.any(hit_w, -1)
      creeping = (force > 0) & ~obstructed
      force = torch.where((force > 0) & obstructed, e.creep_duration, force)
      throttle = torch.where(creeping, e.creep_throttle, throttle)
      brake = torch.where(creeping, 0.0,
                          torch.where((force > 0) & obstructed, 1.0, brake))
      stuck = torch.where(creeping, 0, stuck)
    new_ag = pa.PlanTAgentState(
        planner_dense=pl_dense, planner_sparse=pl_sparse,
        pid_turn=pt2, pid_speed=ps2, cleared_stop_signs=cleared,
        stuck_count=stuck.to(torch.int32), force_move=force.to(torch.int32))
    return Control(steer=steer, throttle=throttle, brake=brake), \
        {"agent": new_ag}

  return policy


@pytest.mark.parametrize("direct,creep", [(True, True), (False, True),
                                          (True, False)])
def test_plant_policy_on_the_cpu_is_the_eager_policy(scene, direct, creep,
                                                     no_cuda):
  """The PlanT policy's graph stages run eagerly on the CPU: over four
  ticks, its control and next agent state equal the policy as written
  before, leaf for leaf and bit for bit, from the same states (episode 0
  starts stuck, so a creep begins), and it captures nothing."""
  maps, lanes, scn, state = scene
  torch.manual_seed(0)
  model = PlanT(PCFG)
  policy = pa.make_plant_policy(model, None, PCFG, direct=direct,
                                creep=creep)
  before = _plant_policy_before(model, PCFG, direct, creep=creep)
  ag = pa.plant_agent_reset(CFG, B, device="cpu")
  stuck = torch.tensor([CFG.expert.stuck_threshold, 0], dtype=torch.int32)
  st = state.replace(agent=ag.replace(stuck_count=stuck))
  gen = torch.Generator().manual_seed(7)
  for _ in range(4):
    got = policy(CFG, maps, scn, st)
    want = before(CFG, maps, scn, st)
    _equal_trees(got, want)
    st = sim_step(CFG, maps, lanes, scn, st, policy, generator=gen)
  assert int(st.tick.min()) == 4
  if creep:
    assert int(st.agent.force_move[0]) > 0 or \
        int(st.agent.stuck_count[0]) == CFG.expert.stuck_threshold + 4


def test_plant_policy_spans_on_the_cpu(scene, no_cuda):
  """One tick: ``agent.localize``, ``agent.inputs``, ``agent.model`` and
  ``agent.control`` in that order, side by side, and no ``graph.*``
  span."""
  maps, _, scn, state = scene
  policy, st = _policy("plant", state)
  profiling.record(True)
  try:
    policy(CFG, maps, scn, st)
    spans = profiling.recorded()
  finally:
    profiling.record(False)
    profiling.clear()
  assert [s.name for s in spans if s.parent is None] == [
      "agent.localize", "agent.inputs", "agent.model", "agent.control"]
  assert not any(s.name.startswith("graph.") for s in spans)
