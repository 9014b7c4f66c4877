"""The port's own spans (``utils/profiling.py``) on the CPU at the port
tests' small sizes.

* Off (the default), ``sim_step`` and a PlanT training step record
  nothing, construct no CUDA event and open no ``record_function`` (both
  patched to raise), and their outputs equal a recorded run's bit for
  bit.
* Recorded, each tick of either policy is one ``sim.tick`` around the
  spans of its layers, each inside its parent's host interval and
  carrying the tick's id.
* Under ``torch.profiler`` every span is a ``cgt.*`` range of the Chrome
  trace, nested as recorded, with the tick's aten ops inside; its host
  interval is the range's once the trace's ``baseTimeNanoseconds`` is
  added: the spans and the device trace share one clock.
* ``rollout_chunked`` records one ``rollout.done_check`` per chunk.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from carla_garage_tpu_torch.agents import plant_agent as pa
from carla_garage_tpu_torch.agents import sensor_agent as sa
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.models.plant import PlanT, PlanTConfig
from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
from carla_garage_tpu_torch.sim.episode import rollout_chunked, sim_step
from carla_garage_tpu_torch.sim.scene_builder import make_town_batch
from carla_garage_tpu_torch.structs import tree_items
from carla_garage_tpu_torch.train import plant_train as pt
from carla_garage_tpu_torch.train.transfuser_train import make_optimizer
from carla_garage_tpu_torch.utils import profiling

B = 2
PCFG = PlanTConfig(hidden=64, n_layers=2, n_heads=2, intermediate=256,
                   max_positions=64, max_objects=10, num_route_points=6)
SIM = ("sim.policy", "sim.scenarios", "sim.dynamics", "sim.traffic",
       "sim.criteria")
AGENT = ("agent.localize", "agent.inputs", "agent.model", "agent.control")


@pytest.fixture(autouse=True)
def _fresh_recorder():
  """Each test starts with the recorder off and empty, and leaves it so;
  one torch thread (the tests run beside other test processes)."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  profiling.record(False)
  profiling.clear()
  yield
  profiling.record(False)
  profiling.clear()
  torch.set_num_threads(n)


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
  policy = sa.make_transfuser_policy(
      ttf.LidarCenterNet(c).eval(), None, c, camera_ray_grid(CFG, scale=8),
      lid_f, lid_r, direct=True)
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


def _train_steps(n: int = 2):
  """n PlanT training steps on a random batch: (aux of each, weights)."""
  rng = np.random.default_rng(0)
  m, O, R = 16, PCFG.max_objects, PCFG.num_route_points
  f32 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
  i32 = lambda lo, hi, *s: torch.from_numpy(
      rng.integers(lo, hi, s).astype(np.int32))
  ds = pt.PlantDataset(
      boxes=f32(m, O, 7), box_types=i32(0, 4, m, O), route=f32(m, R, 2),
      light=i32(0, 2, m).float(), stop=torch.zeros(m),
      junction=torch.zeros(m), velocity=f32(m).abs(),
      target_point=f32(m, 2), wp_label=f32(m, 8, 2),
      speed_label=i32(0, 4, m), ckpt_label=f32(m, R, 2),
      forecast_label=i32(-1, 4, m, O, 7))
  torch.manual_seed(0)
  model = PlanT(PCFG)
  opt, sched = make_optimizer(model, 3e-4, 100, schedule=None)
  step = pt.make_train_step(model, opt, sched)
  batches = pt.iterate_minibatches(ds, 8, np.random.default_rng(1),
                                   epochs=n)
  auxes = [step(next(batches)) for _ in range(n)]
  return auxes, [p.detach().clone() for p in model.parameters()]


def _forbid(monkeypatch):
  def refuse(*a, **kw):
    raise AssertionError("constructed while the spans are off")
  monkeypatch.setattr(torch.cuda, "Event", refuse)
  monkeypatch.setattr(torch.profiler, "record_function", refuse)


def _equal_trees(a, b):
  la, lb = list(tree_items(a)), list(tree_items(b))
  assert la and [k for k, _ in la] == [k for k, _ in lb]
  for (k, x), (_, y) in zip(la, lb):
    assert torch.equal(x, y), k


@pytest.mark.parametrize("kind", ["plant", "tfpp"])
def test_off_spans_cost_nothing_and_change_nothing(scene, kind,
                                                   monkeypatch):
  with monkeypatch.context() as mp:
    _forbid(mp)
    off = _ticks(scene, kind)
    off_aux, off_w = _train_steps()
  assert profiling.recorded() == []
  profiling.record(True)
  on = _ticks(scene, kind)
  on_aux, on_w = _train_steps()
  assert profiling.recorded()
  _equal_trees(off, on)
  for a, b in zip(off_aux, on_aux):
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
  assert all(torch.equal(x, y) for x, y in zip(off_w, on_w))


def _children(spans, parent):
  return [s for s in spans if s.parent == parent.id]


def _inside(child, parent):
  return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


@pytest.mark.parametrize("kind", ["plant", "tfpp"])
def test_each_tick_is_one_tree_of_spans(scene, kind):
  profiling.record(True)
  profiling.record(True)                    # idempotent
  _ticks(scene, kind)
  spans = profiling.recorded()
  ticks = [s for s in spans if s.name == "sim.tick"]
  assert len(ticks) == 2
  assert len({t.id for t in ticks}) == 2
  for tick in ticks:
    assert tick.parent is None and tick.root == tick.id
    mine = [s for s in spans if s.root == tick.id]
    assert [s.name for s in _children(spans, tick)] == list(SIM)
    policy = next(s for s in mine if s.name == "sim.policy")
    assert [s.name for s in _children(spans, policy)] == list(AGENT)
    for s in mine[1:]:
      parent = next(p for p in mine if p.id == s.parent)
      assert _inside(s, parent), (s.name, parent.name)
      assert s.elapsed_ms() >= 0
    rays = [s for s in mine if s.name == "ops.raycast_boxes"]
    if kind == "tfpp":                       # the camera and the LiDAR half
      inputs = next(s for s in mine if s.name == "agent.inputs")
      assert len(rays) == 2 and all(r.parent == inputs.id for r in rays)
    else:
      assert not rays
  # the spans of both ticks are all the recorder holds, in opening order
  assert {s.root for s in spans} == {t.id for t in ticks}
  assert [s.id for s in spans] == sorted(s.id for s in spans)
  profiling.record(True)
  assert len(profiling.recorded()) == len(spans)   # turning on clears none
  profiling.clear()
  assert profiling.recorded() == []


def test_spans_share_the_profilers_clock(scene, tmp_path):
  from torch.profiler import ProfilerActivity, profile
  profiling.record(True)
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    _ticks(scene, "plant")
  prof.export_chrome_trace(str(tmp_path / "trace.json"))
  trace = json.loads((tmp_path / "trace.json").read_text())
  base = trace["baseTimeNanoseconds"]
  events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
  ranges = sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith(profiling.PREFIX)),
                  key=lambda e: e["ts"])
  spans = profiling.recorded()
  assert len(ranges) == len(spans)
  got = {}
  for s in spans:
    same = [r for r in ranges if r["name"] == profiling.PREFIX + s.name
            and id(r) not in got.values()]
    got[s.id] = id(same[0])
    r = same[0]
    start_ns, end_ns = r["ts"] * 1e3 + base, (r["ts"] + r["dur"]) * 1e3 + base
    assert abs(start_ns - s.start_ns) < 0.5e6, s.name
    assert abs(end_ns - s.end_ns) < 0.5e6, s.name
  by_id = {id(r): r for r in ranges}
  holds = lambda p, c: p["ts"] <= c["ts"] and \
      c["ts"] + c["dur"] <= p["ts"] + p["dur"]
  for s in spans:
    if s.parent is not None:
      assert holds(by_id[got[s.parent]], by_id[got[s.id]]), s.name
  ops = [e for e in events if e.get("cat") == "cpu_op"
         and e["name"].startswith("aten::")]
  for t in (s for s in spans if s.name == "sim.tick"):
    r = by_id[got[t.id]]
    assert sum(holds(r, o) for o in ops) > 50


def test_spans_inside_a_capture_record_nothing():
  """``opened()`` counts the live spans; inside ``capturing`` a span
  records nothing, and with marks=False (the warm-up opened no span) no
  marker kernel is loaded."""
  n = profiling.opened()
  with profiling.span("off"):
    pass
  assert profiling.opened() == n
  profiling.record(True)
  with profiling.span("a"):
    pass
  assert profiling.opened() == n + 1
  with profiling.capturing(marks=False):
    with profiling.span("b"):
      pass
  assert profiling.opened() == n + 1
  assert [s.name for s in profiling.recorded()] == ["a"]
  assert profiling._markers is None and "b" not in profiling.marker_ids()


def test_rollout_records_one_done_check_per_chunk(scene):
  maps, lanes, scn, state = scene
  policy, st = _policy("plant", state)
  profiling.record(True)
  rollout_chunked(CFG, maps, lanes, scn, st, 4, chunk=2, policy=policy,
                  watchdog_s=None)
  names = [s.name for s in profiling.recorded() if s.parent is None]
  assert names == ["sim.tick"] * 2 + ["rollout.done_check"] + \
      ["sim.tick"] * 2 + ["rollout.done_check"]
