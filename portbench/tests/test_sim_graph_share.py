"""The reader of ``sim_graph_share.eval``: the share of the window's
``sim.criteria`` spans that hold a ``graph.replay`` span, from synthetic
spans; a replay under the policy's model does not count; left out where
the program recorded no ``graph.*`` span (a program without graphs, or
the CPU)."""

import time
import types

import pytest

from portbench import harness, program_spans
from portbench.tests.helpers import tiny_run

METRIC = "sim_graph_share.eval"


class FakeSpan(types.SimpleNamespace):
  def elapsed_ms(self):
    return 1.0


def ticks(starts_ns: list, replayed: list, model_graph: bool = True) -> list:
  """A ``sim.tick`` at each start around ``sim.policy`` > ``agent.model``
  (holding a ``graph.replay`` with `model_graph`) and ``sim.criteria``,
  which holds a ``graph.replay`` where replayed[i]; a ``graph.capture``
  in the first tick."""
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
    if model_graph:
      add("graph.replay", model, rid, t + 3)
    if i == 0:
      add("graph.capture", rid, rid, t + 4)
    crit = add("sim.criteria", rid, rid, t + 5)
    if rep:
      add("graph.replay", crit, rid, t + 6)
  return out


def reader():
  return harness.load_reader(METRIC)


def record(now_perf, traced=frozenset({2})):
  return {"kind": "eval", "window_start": now_perf, "window_s": 1.0,
          "traced": set(traced)}


def window_starts(now_unix):
  # one tick before the window, six in it (the third traced, so the
  # fourth is left out too), one after
  return [now_unix - 2_000_000_000] + \
      [now_unix + i * 20_000_000 for i in range(6)] + \
      [now_unix + 5_000_000_000]


@pytest.mark.parametrize("model_graph", [True, False])
def test_share_of_the_window_ticks(monkeypatch, model_graph):
  now_perf, now_unix = time.perf_counter(), time.time_ns()
  starts = window_starts(now_unix)
  replayed = [True, True, False, True, False, True, False, True]
  monkeypatch.setattr(program_spans, "recorded",
                      lambda: ticks(starts, replayed, model_graph))
  rec = record(now_perf)
  # window ticks 0, 1, 4, 5 count: replayed, not, replayed, not
  assert reader().read(rec) == pytest.approx(50.0)
  assert reader().read(dict(rec, kind="train")) is None
  monkeypatch.setattr(program_spans, "recorded",
                      lambda: ticks(starts, [True] * len(starts),
                                    model_graph))
  assert reader().read(rec) == pytest.approx(100.0)


def test_the_model_graph_alone_reads_zero(monkeypatch):
  """A program whose forward replays and whose simulator runs eagerly."""
  now_perf, now_unix = time.perf_counter(), time.time_ns()
  starts = window_starts(now_unix)
  monkeypatch.setattr(program_spans, "recorded",
                      lambda: ticks(starts, [False] * len(starts)))
  assert reader().read(record(now_perf)) == pytest.approx(0.0)


def test_left_out_without_graph_spans(monkeypatch):
  now_perf, now_unix = time.perf_counter(), time.time_ns()
  spans = [s for s in ticks([now_unix + 1_000_000], [False], False)
           if not s.name.startswith("graph.")]
  monkeypatch.setattr(program_spans, "recorded", lambda: spans)
  rec = record(now_perf, ())
  assert reader().read(rec) is None
  monkeypatch.setattr(program_spans, "recorded", lambda: [])
  assert reader().read(rec) is None


def test_a_cpu_run_leaves_it_out():
  """On the CPU every layer runs eagerly: no graph span, no value."""
  result = tiny_run("plant.eval", trace=True)
  assert result["correct"]
  assert METRIC not in result["metrics"]
  assert "criteria_ms.eval" in result["metrics"]
