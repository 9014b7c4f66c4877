"""The reader of ``graph_share.eval``: the share of the window's
``agent.model`` spans that hold a ``graph.replay`` span, from synthetic
spans; left out where the program recorded no ``graph.*`` span (a
program without the graphs, or the CPU)."""

import time
import types

import pytest

from portbench import harness, program_spans
from portbench.tests.helpers import tiny_run

METRIC = "graph_share.eval"


class FakeSpan(types.SimpleNamespace):
  def elapsed_ms(self):
    return 1.0


def ticks(starts_ns: list, replayed: list, nested: bool = False) -> list:
  """A ``sim.tick`` at each start around ``sim.policy`` > ``agent.model``,
  which holds a ``graph.replay`` (under a span of its own with `nested`)
  where replayed[i]; a ``graph.capture`` in the first tick."""
  out, k = [], 0

  def add(name, parent, root, t):
    nonlocal k
    k += 1
    out.append(FakeSpan(name=name, id=k, parent=parent, root=root,
                        start_ns=t, end_ns=t + 1000))
    return k

  for i, (t, rep) in enumerate(zip(starts_ns, replayed)):
    rid = add("sim.tick", None, None, t)
    out[-1].root = rid
    pol = add("sim.policy", rid, rid, t + 1)
    model = add("agent.model", pol, rid, t + 2)
    if i == 0:
      add("graph.capture", model, rid, t + 3)
    if rep:
      inner = add("graph.inner", model, rid, t + 4) if nested else model
      add("graph.replay", inner, rid, t + 5)
  return out


def reader():
  return harness.load_reader(METRIC)


@pytest.mark.parametrize("nested", [False, True])
def test_share_of_the_window_ticks(monkeypatch, nested):
  now_perf, now_unix = time.perf_counter(), time.time_ns()
  # one tick before the window, six in it (the third traced, so the
  # fourth is left out too), one after
  starts = [now_unix - 2_000_000_000] + \
      [now_unix + i * 20_000_000 for i in range(6)] + \
      [now_unix + 5_000_000_000]
  replayed = [False, True, False, False, False, True, True, False]
  monkeypatch.setattr(program_spans, "recorded",
                      lambda: ticks(starts, replayed, nested))
  rec = {"kind": "eval", "window_start": now_perf, "window_s": 1.0,
         "traced": {2}}
  # window ticks 0, 1, 4, 5 count: replayed, not, replayed, replayed
  assert reader().read(rec) == pytest.approx(75.0)
  assert reader().read(dict(rec, kind="train")) is None
  monkeypatch.setattr(program_spans, "recorded",
                      lambda: ticks(starts, [True] * len(starts)))
  assert reader().read(rec) == pytest.approx(100.0)


def test_left_out_without_graph_spans(monkeypatch):
  now_perf, now_unix = time.perf_counter(), time.time_ns()
  spans = [s for s in ticks([now_unix + 1_000_000], [False])
           if not s.name.startswith("graph.")]
  monkeypatch.setattr(program_spans, "recorded", lambda: spans)
  rec = {"kind": "eval", "window_start": now_perf, "window_s": 1.0,
         "traced": set()}
  assert reader().read(rec) is None
  monkeypatch.setattr(program_spans, "recorded", lambda: [])
  assert reader().read(rec) is None


def test_a_cpu_run_leaves_it_out():
  """On the CPU the forward runs eagerly: no graph span, no value."""
  result = tiny_run("plant.eval", trace=True)
  assert result["correct"]
  assert METRIC not in result["metrics"]
  assert "model_ms.eval" in result["metrics"]
