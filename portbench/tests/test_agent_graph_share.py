"""The reader of ``agent_graph_share.eval``: the share of the window's
``agent.inputs`` spans that hold a ``graph.replay`` span, from synthetic
spans; a replay under the policy's model or under the simulator's layers
does not count; left out where the program recorded no ``graph.*`` span
(a program without graphs, or the CPU)."""

import time
import types

import pytest

from portbench import harness, program_spans
from portbench.tests.helpers import tiny_run

METRIC = "agent_graph_share.eval"


class FakeSpan(types.SimpleNamespace):
  def elapsed_ms(self):
    return 1.0


def ticks(starts_ns: list, replayed: list, others: bool = True) -> list:
  """A ``sim.tick`` at each start around ``sim.policy`` >
  ``agent.localize``, ``agent.inputs``, ``agent.model``, ``agent.control``
  and ``sim.criteria``. ``agent.localize``, ``agent.inputs`` and
  ``agent.control`` hold a ``graph.replay`` where replayed[i];
  ``agent.model`` and ``sim.criteria`` hold one with `others`; a
  ``graph.capture`` in the first tick."""
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
    if i == 0:
      add("graph.capture", pol, rid, t + 2)
    for j, name in enumerate(("agent.localize", "agent.inputs",
                              "agent.model", "agent.control")):
      span = add(name, pol, rid, t + 3 + 2 * j)
      if (others if name == "agent.model" else rep):
        add("graph.replay", span, rid, t + 4 + 2 * j)
    crit = add("sim.criteria", rid, rid, t + 20)
    if others:
      add("graph.replay", crit, rid, t + 21)
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


@pytest.mark.parametrize("others", [True, False])
def test_share_of_the_window_ticks(monkeypatch, others):
  now_perf, now_unix = time.perf_counter(), time.time_ns()
  starts = window_starts(now_unix)
  replayed = [True, True, False, True, False, True, False, True]
  monkeypatch.setattr(program_spans, "recorded",
                      lambda: ticks(starts, replayed, others))
  rec = record(now_perf)
  # window ticks 0, 1, 4, 5 count: replayed, not, replayed, not
  assert reader().read(rec) == pytest.approx(50.0)
  assert reader().read(dict(rec, kind="train")) is None
  monkeypatch.setattr(program_spans, "recorded",
                      lambda: ticks(starts, [True] * len(starts), others))
  assert reader().read(rec) == pytest.approx(100.0)


def test_the_forward_and_sim_graphs_alone_read_zero(monkeypatch):
  """A program whose forward and simulator replay and whose agent runs
  eagerly around the forward."""
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
  """On the CPU every stage runs eagerly: no graph span, no value."""
  result = tiny_run("plant.eval", trace=True)
  assert result["correct"]
  assert METRIC not in result["metrics"]
  assert "inputs_ms.eval" in result["metrics"]
