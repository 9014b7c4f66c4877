"""The readers of the program's spans (``program_spans``): times from
synthetic spans, launches from a small Chrome trace, and tiny traced CPU
runs in which the new metrics appear, or, with a program that has no
recorder, are left out."""

import json
import time
import types

import pytest

from portbench import harness, program_spans
from portbench.tests.helpers import tiny_run
from portbench.trace import Trace

TIME_READERS = {
    "inputs_ms.eval": ("eval", "agent.inputs"),
    "model_ms.eval": ("eval", "agent.model"),
    "scenarios_ms.eval": ("eval", "sim.scenarios"),
    "traffic_ms.eval": ("eval", "sim.traffic"),
    "criteria_ms.eval": ("eval", "sim.criteria"),
    "backward_ms.train": ("train", "train.backward"),
}


def reader(name):
  return harness.load_reader(name)


class FakeSpan(types.SimpleNamespace):
  def elapsed_ms(self):
    return self.ms


def fake_spans(root: str, name: str, starts_ns: list, ms: list) -> list:
  """A root span at each start with one child `name` of ms[i] (two
  halves, so that a tick's time is their sum)."""
  out, k = [], 0
  for t, m in zip(starts_ns, ms):
    k += 1
    rid = k
    out.append(FakeSpan(name=root, id=rid, parent=None, root=rid,
                        start_ns=t, end_ns=t + 10_000_000, ms=100.0))
    for half in range(2):
      k += 1
      out.append(FakeSpan(name=name, id=k, parent=rid, root=rid,
                          start_ns=t + 1000 * (half + 1),
                          end_ns=t + 2000 * (half + 1), ms=m / 2))
  return out


@pytest.mark.parametrize("metric", sorted(TIME_READERS))
def test_time_reader_takes_the_median_of_the_window(metric, monkeypatch):
  kind, name = TIME_READERS[metric]
  root = program_spans.ROOTS[kind]
  now_perf, now_unix = time.perf_counter(), time.time_ns()
  # two ticks before the window, six in it (the third traced; in closed
  # loop the profiler's stop falls in the fourth), one after
  starts = [now_unix - 3_000_000_000, now_unix - 2_000_000_000] + \
      [now_unix + i * 20_000_000 for i in range(6)] + \
      [now_unix + 5_000_000_000]
  ms = [900.0, 900.0, 1.0, 2.0, 500.0, 600.0, 3.0, 4.0, 700.0]
  spans = fake_spans(root, name, starts, ms)
  monkeypatch.setattr(program_spans, "recorded", lambda: spans)
  rec = {"kind": kind, "window_start": now_perf, "window_s": 1.0,
         "traced": {2}}
  # the median of 1, 2, 3, 4, and of 600 too in training, where the
  # profiler starts and stops between steps
  want = 2.5 if kind == "eval" else 3.0
  assert reader(metric).read(rec) == pytest.approx(want)
  other = "train" if kind == "eval" else "eval"
  assert reader(metric).read(dict(rec, kind=other)) is None
  monkeypatch.setattr(program_spans, "recorded",
                      lambda: fake_spans(root, "other.span", starts, ms))
  assert reader(metric).read(rec) is None          # its span is absent
  monkeypatch.setattr(program_spans, "recorded", lambda: [])
  assert reader(metric).read(rec) is None


def x(name, cat, ts, dur, tid=7, **args):
  return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "pid": 1, "tid": tid, "args": args}


def write_trace(path, root: str):
  """A stretch of 1000 us holding a cut root range (its start before the
  profiler's, so absent), two whole roots with nested spans, and a root
  cut at the profiler's stop; kernels, a copy back to the host and a
  runtime call that launched nothing."""
  ev = [x("portbench.stretch", "user_annotation", 100.0, 800.0)]
  leaf = "agent.model" if root == "sim.tick" else "train.backward"
  mid = "sim.policy" if root == "sim.tick" else "train.forward"
  launch, corr = [], 0

  def k(t, dur=5.0, name="kern", cat="kernel", tid=7):
    nonlocal corr
    corr += 1
    launch.append(x("cudaLaunchKernel", "cuda_runtime", t, 2.0, tid=tid,
                    correlation=corr))
    launch.append(x(name, cat, t + 10.0, dur, tid=1000, correlation=corr))

  k(110.0)                                 # before the first whole root
  for base in (200.0, 500.0):
    ev.append(x("cgt." + root, "user_annotation", base, 200.0))
    ev.append(x("cgt." + mid, "user_annotation", base + 10.0, 100.0))
    ev.append(x("cgt." + leaf, "user_annotation", base + 20.0, 50.0))
    k(base + 5.0)                          # in the root alone
    k(base + 15.0)                         # in mid
    k(base + 30.0, dur=40.0)               # in the leaf
    k(base + 40.0, tid=9)                  # in the leaf, from a thread
                                           # that opens no range
    k(base + 150.0, name="Memcpy DtoH (Device -> Pageable)",
      cat="gpu_memcpy")                    # in the root after mid
  corr += 1
  launch.append(x("cudaEventRecord", "cuda_runtime", 230.0, 1.0,
                  correlation=corr))       # no device operation
  ev.append(x("cgt." + root, "user_annotation", 850.0, 100.0))  # cut
  k(860.0)
  path.parent.mkdir(parents=True, exist_ok=True)
  path.write_text(json.dumps({"traceEvents": ev + launch}))


@pytest.mark.parametrize("metric,kind,root", [
    ("launches_per_tick.eval", "eval", "sim.tick"),
    ("launches_per_step.train", "train", "train.step")])
def test_launch_reader_counts_whole_ranges(metric, kind, root, tmp_path,
                                           monkeypatch, capsys):
  monkeypatch.setattr(harness, "BUILD", tmp_path)
  path = tmp_path / "traces" / "cell.json"
  write_trace(path, root)
  rec = {"kind": kind, "trace": Trace.load(path)}
  assert reader(metric).read(rec) == 5.0     # 10 launches in 2 whole roots
  rows = {r[0]: r[1:] for r in program_spans.table(
      rec, program_spans.program_ranges(rec))}
  leaf = "agent.model" if root == "sim.tick" else "train.backward"
  mid = "sim.policy" if root == "sim.tick" else "train.forward"
  # each launch in its innermost range: calls, launches, their device ms,
  # the idle ms whose gap closed on one of them, copies to the host; the
  # root cut at the profiler's stop is left out
  approx = lambda *r: [pytest.approx(v) for v in r]
  assert rows[root] == approx(2, 4, 0.020, 0.400, 2)
  assert rows[mid] == approx(2, 2, 0.010, 0.010, 0)
  assert rows[leaf] == approx(2, 4, 0.090, 0.020, 0)
  assert rows["(no span)"] == approx(0, 2, 0.010, 0.225, 0)
  assert len(rows) == 4
  assert "spans: " + leaf in capsys.readouterr().err
  other = "train" if kind == "eval" else "eval"
  assert reader(metric).read(dict(rec, kind=other)) is None
  # a program without spans: no cgt.* range, no value
  write_trace(path, "another.root")
  assert reader(metric).read(rec) is None
  assert reader(metric).read({"kind": kind, "trace": None}) is None


def test_innermost_follows_nesting_and_threads():
  ranges = [("a", 0.0, 100.0, 1), ("b", 10.0, 20.0, 1),
            ("c", 40.0, 10.0, 1), ("d", 200.0, 100.0, 2)]
  pts = [(5.0, 1, "p"), (15.0, 1, "q"), (35.0, 1, "r"), (45.0, 1, "s"),
         (120.0, 1, "t"), (15.0, 2, "u"), (250.0, 2, "w")]
  got = program_spans.innermost(ranges, pts)
  assert got == {"p": 0, "q": 1, "r": 0, "s": 2, "t": None, "u": None,
                 "w": 3}
  # a thread that opens no range (autograd's backward thread) by time
  got = program_spans.innermost(ranges, [(15.0, 3, "v"), (45.0, 3, "x"),
                                         (250.0, 3, "y"), (150.0, 3, "z")])
  assert got == {"v": 1, "x": 2, "y": 3, "z": None}


NEW = {"plant.eval": ["inputs_ms.eval", "model_ms.eval",
                      "scenarios_ms.eval", "traffic_ms.eval",
                      "criteria_ms.eval", "launches_per_tick.eval"],
       "plant.train": ["backward_ms.train", "launches_per_step.train"]}


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_tiny_run_reports_them(cell):
  result = tiny_run(cell, trace=True)
  assert result["correct"]
  for m in NEW[cell]:
    assert m in result["metrics"], m
    assert result["metrics"][m]["value"] >= 0
  # on the CPU no kernel is launched
  launch = NEW[cell][-1]
  assert result["metrics"][launch]["value"] == 0.0


def test_a_program_without_the_recorder_leaves_them_out(monkeypatch):
  from carla_garage_tpu_torch.utils import profiling
  profiling.record(False)
  for name in ("record", "recorded", "recording", "clear", "span"):
    monkeypatch.delattr(profiling, name)
  monkeypatch.setattr(profiling, "_live", False)
  result = tiny_run("plant.eval", trace=True)
  assert result["correct"]
  assert not set(NEW["plant.eval"]) & set(result["metrics"])
