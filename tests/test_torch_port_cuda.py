"""On-card tests of the port's CUDA kernels against their plain versions,
of the models' forwards replayed as CUDA graphs
(``utils/cuda_graph.GraphedForward``) against their eager forwards, and of
the simulator's tick after the policy replayed as CUDA graphs
(``GraphedStages`` in ``sim/episode.sim_step``) against its eager tick.

They need an NVIDIA card with nvcc (Hopper, sm_90a) and skip elsewhere.
This file imports no JAX, so it runs on a machine without it:

  python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py

(--noconftest because tests/conftest.py configures JAX.)
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from carla_garage_tpu_torch.agents import plant_agent as pa
from carla_garage_tpu_torch.agents import sensor_agent as sa
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.models.plant import PlanT, PlanTConfig
from carla_garage_tpu_torch.ops import kernel_cases
from carla_garage_tpu_torch.ops.bev_fill import (fill_boxes,
                                                 fill_boxes_bev_plain,
                                                 pack_boxes)
from carla_garage_tpu_torch.ops.raycast import (raycast_boxes,
                                                raycast_boxes_plain)
from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
from carla_garage_tpu_torch.sim import episode
from carla_garage_tpu_torch.sim.expert import expert_step
from carla_garage_tpu_torch.sim.scene_builder import make_town_batch
from carla_garage_tpu_torch.structs import tree_items, tree_map
from carla_garage_tpu_torch.utils import cuda_graph, profiling


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
  # the plain version is elementwise fp32 on the card: no TF32 anywhere
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device("cuda")


def random_box_case(B, N, K, seed):
  """Rays from one origin per episode against boxes around it, with a
  duplicated box (a tie the earlier box must win), an origin inside a box,
  and invalid boxes."""
  rng = np.random.default_rng(seed)
  origins = np.concatenate([rng.uniform(-5, 5, (B, 2)),
                            rng.uniform(0.5, 2.5, (B, 1))], -1)
  d = rng.normal(size=(B, N, 3))
  d[..., 2] = -np.abs(d[..., 2]) * 0.3
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  yaw = rng.uniform(-np.pi, np.pi, (B, K))
  boxes = np.stack([
      origins[:, :1] + rng.uniform(-30, 30, (B, K)),
      origins[:, 1:2] + rng.uniform(-30, 30, (B, K)),
      np.cos(yaw), np.sin(yaw),
      rng.uniform(0.3, 3.0, (B, K)), rng.uniform(0.3, 1.5, (B, K)),
      rng.uniform(0.5, 2.5, (B, K)),
      rng.integers(1, 9, (B, K)).astype(np.float64),
      (rng.uniform(size=(B, K)) > 0.2).astype(np.float64)], -1)
  if K >= 3:
    boxes[:, 1] = boxes[:, 0]               # exact duplicate ...
    boxes[:, 1, 7] = 5.0                    # ... of another class: a tie
    boxes[:, 0, 7] = 1.0
    boxes[:, 0, 8] = boxes[:, 1, 8] = 1.0
    boxes[0, 2, :2] = origins[0, :2]        # episode 0 starts inside box 2
    boxes[0, 2, 8] = 1.0
  f = lambda a: torch.tensor(a, dtype=torch.float32)
  return f(origins), f(d), f(boxes)


RAY_CASES = kernel_cases.raycast_cases()
FILL_CASES = kernel_cases.fill_cases()


@pytest.mark.parametrize("B,N,K", [(3, 1000, 13), (2, 257, 48), (1, 5, 0),
                                   (16, 262144, 48), (16, 29952, 48),
                                   (16, 59904, 48), (2, 3000, 1000)])
def test_raycast_kernel_matches_plain(cuda, B, N, K):
  """Random cases, the full-width shapes of the main paths with the
  scene's 48 box slots (16 x 262,144 camera rays, 16 x 29,952 rays of a
  LiDAR half sweep, 16 x 59,904 of the training sweep), and 1,000 boxes:
  64 KB of staged records, past the 48 KB that needs no opt-in."""
  o, d, bx = (x.to(cuda) for x in random_box_case(B, N, K, seed=N))
  _raycast_equals_plain(o, d, bx)


@pytest.mark.parametrize("name", list(RAY_CASES))
def test_raycast_kernel_matches_plain_adversarial(cuda, name):
  """The cull's adversarial cases: grazing corners, edges, axis-parallel
  and vertical rays, origins inside boxes, boxes 1,000 m away, zero
  extents, rising rays against poles."""
  _raycast_equals_plain(*(x.to(cuda) for x in RAY_CASES[name]))


def _raycast_equals_plain(o, d, bx):
  before = raycast_boxes.launches
  t, cls = raycast_boxes(o, d, bx)
  torch.cuda.synchronize()
  assert raycast_boxes.launches == before + 1
  t_ref, cls_ref = raycast_boxes_plain(o, d, bx)
  # built with -fmad=false and IEEE division, the kernel repeats the plain
  # version's fp32 operations in its order: equal bit for bit
  assert torch.equal(t, t_ref)
  assert torch.equal(cls, cls_ref)
  if bx.shape[1]:
    assert bool((t < 1e9).any())


def test_raycast_kernel_rejects_bad_input(cuda):
  o, d, bx = (x.to(cuda) for x in random_box_case(1, 16, 4, seed=0))
  with pytest.raises(TypeError):
    raycast_boxes(o, d.double(), bx)
  with pytest.raises(ValueError):
    raycast_boxes(o, d.transpose(0, 1), bx)
  with pytest.raises(ValueError):
    raycast_boxes(o, d, bx[..., :8].contiguous())


def random_bev_boxes(B, V, h, w, seed):
  """Boxes over an h x w grid: random poses, a quarter invalid, and pairs
  of boxes of other classes at one center (the later one must win)."""
  rng = np.random.default_rng(seed)
  cx = rng.uniform(-10, w + 10, (B, V))
  cy = rng.uniform(-10, h + 10, (B, V))
  k = cx[:, 1::4].shape[1]              # boxes 4i+1 sit on boxes 4i
  cx[:, 1::4], cy[:, 1::4] = cx[:, 0:4 * k:4], cy[:, 0:4 * k:4]
  yaw = rng.uniform(-np.pi, np.pi, (B, V))
  f = lambda a: torch.tensor(a, dtype=torch.float32)
  return pack_boxes(f(cx), f(cy), torch.cos(f(yaw)), torch.sin(f(yaw)),
                    f(rng.uniform(2, 14, (B, V))), f(rng.uniform(1, 7, (B, V))),
                    torch.tensor(rng.integers(1, 11, (B, V))),
                    torch.tensor(rng.uniform(size=(B, V)) > 0.25))


@pytest.mark.parametrize("B,V,h,w", [(16, 172, 256, 256), (3, 37, 200, 328),
                                     (2, 0, 64, 64), (1, 2000, 130, 7)])
def test_fill_kernel_matches_plain(cuda, B, V, h, w):
  """The training shape (16 episodes, 172 boxes, 256x256), a ragged grid,
  no boxes, and 2,000 boxes: 64 KB of staged survivors where a tile keeps
  them all, past the 48 KB that needs no opt-in."""
  bx = random_bev_boxes(B, V, h, w, seed=V).to(cuda)
  out = _fill_equals_plain(bx, h, w)
  if V:
    assert bool((out > 0).any())


@pytest.mark.parametrize("name", list(FILL_CASES))
def test_fill_kernel_matches_plain_adversarial(cuda, name):
  """Boxes on tile corners, narrower than a pixel, at 45 degrees, partly
  off a ragged grid (width not a multiple of 4), and a grid where no tile
  keeps a box."""
  boxes, h, w = FILL_CASES[name]
  out = _fill_equals_plain(boxes.to(cuda), h, w)
  assert bool((out > 0).any()) == (name != "no survivor")


def _fill_equals_plain(bx, h, w):
  B = bx.shape[0]
  before = fill_boxes.launches
  out = fill_boxes(bx, h, w)
  torch.cuda.synchronize()
  assert fill_boxes.launches == before + 1
  ref = fill_boxes_bev_plain(bx, h, w)
  # built with -fmad=false, the kernel repeats the plain version's fp32
  # operations in order: the maps are equal pixel for pixel
  assert out.dtype == torch.uint8 and out.shape == (B, h, w)
  assert torch.equal(out, ref)
  return out


def test_fill_kernel_rejects_bad_input(cuda):
  bx = random_bev_boxes(2, 4, 8, 8, seed=0).to(cuda)
  with pytest.raises(TypeError):
    fill_boxes(bx.double(), 8, 8)
  with pytest.raises(ValueError):
    fill_boxes(bx[..., :7].contiguous(), 8, 8)
  with pytest.raises(ValueError):
    fill_boxes(bx.transpose(0, 1).contiguous().transpose(0, 1), 8, 8)
  with pytest.raises(ValueError):
    fill_boxes(bx, 0, 8)


# --- the forward as a CUDA graph ------------------------------------------

GRAPH_B = 2
GRAPH_PCFG = PlanTConfig(hidden=64, n_layers=2, n_heads=2, intermediate=256,
                         max_positions=64, max_objects=10,
                         num_route_points=6)


def graph_model(kind, dev):
  """(module on the card in eval mode, inputs(seed, batch)): the micro
  TransFuser++ in float32 ("tfpp"), in bfloat16 ("tfpp_bf16"), with the
  ImageNet normalisation ("tfpp_imagenet"), or the micro PlanT."""
  torch.manual_seed(0)
  if kind == "plant":
    c = GRAPH_PCFG

    def inputs(seed, b=GRAPH_B):
      g = torch.Generator().manual_seed(seed)
      O, R = c.max_objects, c.num_route_points
      x = (torch.randn(b, O, 7, generator=g),
           torch.randint(0, 4, (b, O), generator=g, dtype=torch.int32),
           torch.randn(b, R, 2, generator=g),
           torch.randint(0, 2, (b,), generator=g).float(), torch.zeros(b),
           torch.ones(b), torch.rand(b, generator=g) * 8)
      return tuple(t.to(dev) for t in x)
    return PlanT(c).to(dev).eval(), inputs
  c = dataclasses.replace(ttf.micro_config(),
                          normalize_imagenet=kind == "tfpp_imagenet")
  dt = torch.bfloat16 if kind == "tfpp_bf16" else torch.float32

  def inputs(seed, b=GRAPH_B):
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand(b, c.img_h, c.img_w, 3, generator=g) * 255,
         torch.rand(b, c.lidar_h, c.lidar_w, c.lidar_channels, generator=g),
         torch.randn(b, 2, generator=g) * 10,
         torch.eye(6)[torch.randint(0, 6, (b,), generator=g)],
         torch.rand(b, generator=g) * 8)
    return tuple(t.to(dev, dt) for t in x)
  return ttf.LidarCenterNet(c).to(dev, dt).eval(), inputs


def rel_gap(a, b):
  """The largest relative difference over the outputs' tensors (each: the
  largest difference over the largest value)."""
  la, lb = list(tree_items(a)), list(tree_items(b))
  assert la and [k for k, _ in la] == [k for k, _ in lb]
  worst = 0.0
  for (k, x), (_, y) in zip(la, lb):
    assert x.dtype == y.dtype and x.shape == y.shape, k
    x, y = x.float(), y.float()
    worst = max(worst, float((x - y).abs().max() /
                             y.abs().max().clamp(min=1e-30)))
  return worst


def count_captures(monkeypatch):
  n = [0]
  real = cuda_graph._Graph

  def counted(*a, **kw):
    n[0] += 1
    return real(*a, **kw)
  monkeypatch.setattr(cuda_graph, "_Graph", counted)
  return n


@pytest.mark.parametrize("kind", ["tfpp", "tfpp_bf16", "tfpp_imagenet",
                                  "plant"])
def test_graph_replays_the_eager_forward(cuda, kind, monkeypatch):
  """Three calls with fresh inputs: one capture; the outputs equal the
  eager forward's (float32 within 1e-6 relative, bf16 within the eager
  forward's own run-to-run spread); the hook fires once a call, never in
  warm-up or capture, with the call's inputs and outputs; and a call's
  outputs survive the next replay."""
  m, inputs = graph_model(kind, cuda)
  seen = []
  clone = lambda t: tree_map(torch.clone, t)
  m.register_forward_hook(
      lambda mod, args, out: seen.append((clone(args), clone(out))))
  captures = count_captures(monkeypatch)
  g = cuda_graph.GraphedForward(m)
  with torch.no_grad():
    eager = [m.forward(*inputs(k)) for k in range(3)]
    again = [m.forward(*inputs(k)) for k in range(3)]
    outs, kept = [], []
    for k in range(3):
      outs.append(g(*inputs(k)))
      kept.append(clone(outs[-1]))
      assert len(seen) == k + 1
  torch.cuda.synchronize()
  assert captures[0] == 1 and len(g.graphs) == 1
  spread = max(rel_gap(a, b) for a, b in zip(again, eager))
  tol = 1e-6 if kind != "tfpp_bf16" else spread
  for k in range(3):
    assert rel_gap(outs[k], eager[k]) <= tol, (k, spread)
    assert rel_gap(outs[k], kept[k]) == 0.0          # untouched since
    args, out = seen[k]
    assert all(torch.equal(a, b) for a, b in zip(args, inputs(k)))
    assert rel_gap(out, outs[k]) == 0.0
  assert "forward" not in m.__dict__


def test_graph_follows_weights_shapes_and_storage(cuda, monkeypatch):
  """An in-place weight update shows in the next replay without a new
  capture; a new batch size captures once more; a parameter whose storage
  was replaced drops the graphs and captures again."""
  m, inputs = graph_model("plant", cuda)
  captures = count_captures(monkeypatch)
  g = cuda_graph.GraphedForward(m)
  x = inputs(0)
  with torch.no_grad():
    g(*x)
    m.target_speed_head.weight.mul_(1.5)
    assert rel_gap(g(*x), m.forward(*x)) <= 1e-6
    assert captures[0] == 1
    y = inputs(1, b=GRAPH_B + 1)
    assert rel_gap(g(*y), m.forward(*y)) <= 1e-6
    assert captures[0] == 2 and len(g.graphs) == 2
    assert rel_gap(g(*x), m.forward(*x)) <= 1e-6
    assert captures[0] == 2
    w = m.target_speed_head.weight
    w.data = w.data * -2.0
    assert rel_gap(g(*x), m.forward(*x)) <= 1e-6
    assert captures[0] == 3 and len(g.graphs) == 1
  with torch.enable_grad():
    out = g(*x)
  assert out["pred_wp"].requires_grad and captures[0] == 3


def test_graph_spans(cuda):
  """``graph.capture`` once, outside the replay; ``graph.replay`` once a
  call; both timed by CUDA events outside the capture."""
  m, inputs = graph_model("plant", cuda)
  g = cuda_graph.GraphedForward(m)
  profiling.record(True)
  try:
    with torch.no_grad():
      for k in range(3):
        with profiling.span("agent.model"):
          g(*inputs(k))
    torch.cuda.synchronize()
    spans = profiling.recorded()
  finally:
    profiling.record(False)
    profiling.clear()
  names = [s.name for s in spans]
  assert names.count("graph.capture") == 1
  assert names.count("graph.replay") == 3
  models = {s.id for s in spans if s.name == "agent.model"}
  assert all(s.parent in models for s in spans if s.name.startswith("graph."))
  assert all(s.elapsed_ms() >= 0 for s in spans)


class _SpanInside(torch.nn.Module):
  """A forward that opens a span around part of its work."""

  def __init__(self):
    super().__init__()
    self.lin = torch.nn.Linear(8, 8)

  def forward(self, x):
    with profiling.span("test.inside"):
      x = torch.relu(self.lin(x))
    return x * 2


def test_graph_span_markers(cuda):
  """A span opened inside a captured forward is a pair of marker kernels
  in every replay, and the replay still equals the eager forward; a
  forward that opens no span gets no marker."""
  marked = _SpanInside().to(cuda).eval()
  plain = torch.nn.Linear(8, 8).to(cuda).eval()
  x = torch.randn(4, 8, device=cuda)
  gm = cuda_graph.GraphedForward(marked)
  gp = cuda_graph.GraphedForward(plain)
  profiling.record(True)
  try:
    with torch.no_grad():
      gm(x), gp(x)                      # the captures
      torch.cuda.synchronize()
      acts = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]
      with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
          got = gm(x)
          gp(x)
        torch.cuda.synchronize()
      want = marked.forward(x)
  finally:
    profiling.record(False)
    profiling.clear()
  assert torch.equal(got, want)
  mid = profiling.marker_ids()["test.inside"]
  names = [e.name for e in prof.events() if "cgt_span_" in e.name]
  assert sum(f"cgt_span_begin<{mid}>" in n for n in names) == 3, names
  assert sum(f"cgt_span_end<{mid}>" in n for n in names) == 3, names
  assert len(names) == 6, names



# --- the simulator's tick after the policy as CUDA graphs ------------------

SIM_TICKS = 16
SIM_LAYERS = ("sim.scenarios", "sim.dynamics", "sim.traffic", "sim.criteria")


@pytest.fixture
def fresh_sim_graphs(monkeypatch):
  """sim_step with a cache of graphs of its own (the test's captures are
  counted from none)."""
  monkeypatch.setattr(episode, "_GRAPHS", cuda_graph.GraphedStages())
  return episode._GRAPHS


def sim_scene(dev, batch=GRAPH_B):
  _, maps, lanes, scene, state = make_town_batch(
      CFG, "synth", batch=batch, seed=0, n_vehicles=8, n_walkers=2,
      use_scenarios=True, device=dev)
  return maps, lanes, scene, state


def sim_policy(kind, state, dev):
  """(policy, state with its agent) at the tests' small sizes: the
  expert, the micro PlanT, or the micro TransFuser++ with B1's sensors."""
  torch.manual_seed(0)
  B = state.tick.shape[0]
  if kind == "expert":
    return expert_step, state
  if kind == "plant":
    policy = pa.make_plant_policy(PlanT(GRAPH_PCFG).to(dev), None,
                                  GRAPH_PCFG, direct=True)
    return policy, state.replace(agent=pa.plant_agent_reset(CFG, B,
                                                            device=dev))
  c = dataclasses.replace(ttf.micro_config(), img_h=32, img_w=128,
                          lidar_h=256, lidar_w=256, img_anchors=(1, 4),
                          lidar_anchors=(8, 8))
  lid_f = lidar_ray_grid(CFG, half=0, decimate=16)
  lid_r = lidar_ray_grid(CFG, half=1, decimate=16)
  policy = sa.make_transfuser_policy(
      ttf.LidarCenterNet(c).to(dev), None, c, camera_ray_grid(CFG, scale=8),
      lid_f, lid_r, direct=True)
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  return policy, state.replace(agent=sa.sensor_agent_reset(
      CFG, B, n_lidar, device=dev))


def sim_run(sim, policy, state, ticks=SIM_TICKS, drawn=False, kept=None):
  """The states after each of `ticks` ticks, from fixed seeds: the
  scenario engine's draws from the generator, or given (`drawn`); a copy
  of each, taken before the next tick runs, is appended to `kept`."""
  maps, lanes, scene, _ = sim
  gen = torch.Generator(device=state.tick.device).manual_seed(7)
  loss = torch.Generator(device=state.tick.device).manual_seed(11)
  K = scene.scenarios.kind.shape[1]
  out = []
  for _ in range(ticks):
    draws = {"control_loss": torch.randn(
        (state.tick.shape[0], K), generator=loss,
        device=state.tick.device)} if drawn else None
    state = episode.sim_step(CFG, maps, lanes, scene, state, policy,
                             generator=gen, draws=draws)
    out.append(state)
    if kept is not None:
      kept.append(tree_map(torch.clone, state))
  return out


def equal_states(a, b):
  la, lb = list(tree_items(a)), list(tree_items(b))
  assert la and [k for k, _ in la] == [k for k, _ in lb]
  for (k, x), (_, y) in zip(la, lb):
    assert x.dtype == y.dtype and x.shape == y.shape, k
    assert torch.equal(x, y), k


@contextlib.contextmanager
def sim_eager(monkeypatch):
  """sim_step runs its layers eagerly inside (the policy's forward stays a
  graph)."""
  with monkeypatch.context() as mp:
    mp.setattr(cuda_graph, "_eager_mode", lambda: True)
    yield


@pytest.mark.parametrize("kind,drawn", [("expert", False), ("expert", True),
                                        ("plant", False), ("tfpp", False)])
def test_sim_graphs_replay_the_eager_tick(cuda, kind, drawn, monkeypatch,
                                          fresh_sim_graphs):
  """16 ticks with the graphs and 16 eager from the same state and seeds
  are bit-equal at every tick; the graphs are captured in the first two
  ticks at most (the reset state's strides, then the tick's own) and
  replayed after; a state returned at a tick is untouched by every later
  tick."""
  graphs = fresh_sim_graphs
  sim = sim_scene(cuda)
  policy, state = sim_policy(kind, sim[3], cuda)
  held = []

  def call(*a, **kw):
    out = graphs(*a, **kw)
    held.append(len(graphs.graphs))
    return out
  monkeypatch.setattr(episode, "_GRAPHS", call)
  with torch.no_grad():
    kept = []
    graphed = sim_run(sim, policy, state, drawn=drawn, kept=kept)
    with sim_eager(monkeypatch):
      eager = sim_run(sim, policy, state, drawn=drawn)
  torch.cuda.synchronize()
  assert 1 <= held[0] and held[1] <= 2
  assert held == held[:2] + [held[1]] * (2 * SIM_TICKS - 2)
  for g, e, k in zip(graphed, eager, kept):
    equal_states(g, e)
    equal_states(g, k)
  assert int(graphed[-1].tick.min()) == SIM_TICKS
  if kind == "tfpp":
    # the policy's LiDAR history is frozen outside the graphs: no buffer
    # of theirs holds it
    history = tuple(state.agent.prev_lidar.shape)
    for g in graphs.graphs.values():
      assert all(tuple(t.shape) != history for t in g.inputs + g._outs)


def test_sim_graphs_follow_shapes_and_storage(cuda, monkeypatch,
                                              fresh_sim_graphs):
  """Another run on the same scene only replays; a new batch size (a new
  scene) captures again, as does a scene whose storage was replaced, each
  dropping the graphs before; every run is bit-equal to the eager tick."""
  graphs = fresh_sim_graphs
  captures = count_captures(monkeypatch)

  def both(sim, ticks=3):
    with torch.no_grad():
      got = sim_run(sim, expert_step, sim[3], ticks)
      with sim_eager(monkeypatch):
        want = sim_run(sim, expert_step, sim[3], ticks)
    for g, e in zip(got, want):
      equal_states(g, e)

  a = sim_scene(cuda)
  both(a)
  n = captures[0]
  assert 1 <= n <= 2 and len(graphs.graphs) == n
  both(a)
  assert captures[0] == n
  b = sim_scene(cuda, batch=GRAPH_B + 1)
  both(b)
  assert 1 <= captures[0] - n <= 2
  assert len(graphs.graphs) == captures[0] - n
  n = captures[0]
  maps, lanes, scene, state = b
  both((maps, lanes, tree_map(torch.clone, scene), state))
  assert 1 <= captures[0] - n <= 2
  assert len(graphs.graphs) == captures[0] - n


def test_sim_graph_spans(cuda, fresh_sim_graphs):
  """Each layer's span holds one ``graph.replay`` a tick, timed by CUDA
  events outside the capture; ``graph.capture`` opens inside ``sim.tick``
  in the capturing ticks only."""
  sim = sim_scene(cuda)
  profiling.record(True)
  try:
    with torch.no_grad():
      sim_run(sim, expert_step, sim[3], ticks=4)
    torch.cuda.synchronize()
    spans = profiling.recorded()
  finally:
    profiling.record(False)
    profiling.clear()
  by_id = {s.id: s for s in spans}
  ticks = [s for s in spans if s.name == "sim.tick"]
  assert len(ticks) == 4
  for name in SIM_LAYERS:
    layer = [s for s in spans if s.name == name]
    assert len(layer) == 4, name
    for s in layer:
      inside = [r for r in spans if r.parent == s.id]
      assert [r.name for r in inside] == ["graph.replay"], name
      assert by_id[s.parent].name == "sim.tick"
  caps = [s for s in spans if s.name == "graph.capture"]
  assert 1 <= len(caps) <= 2
  assert all(by_id[s.parent].name == "sim.tick" for s in caps)
  assert all(s.elapsed_ms() >= 0 for s in spans)
