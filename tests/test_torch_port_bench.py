"""The port's bench (carla_garage_tpu_torch/bench.py) against bench.py.

The payload has bench.py's keys (plus ``device``), with the measure
functions of both replaced by stubs; a failed sensor point is reported as
bench.py reports it and then fails the process. The stage names are
``profile_sensor_stages``' own. On the CPU, at B=2 and 2 ticks, each
measure function returns a finite rate above 0 and the stage profile its
stages; ``utils/profiling.trace`` writes a Chrome trace that holds the
program's spans.
"""

import ast
import importlib.util
import json
import math
import pathlib

import pytest
import torch

from carla_garage_tpu_torch import bench
from carla_garage_tpu_torch.utils.profiling import span, trace

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core): a torch
  thread pool of its own per process would oversubscribe the cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_bench():
  spec = importlib.util.spec_from_file_location("jax_bench",
                                                ROOT / "bench.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _stub_sensor(fail_full):
  def measure(full_spec, *a, **kw):
    if full_spec and fail_full:
      raise RuntimeError("sensor point failed")
    return 123.4 if not full_spec else 45.6
  return measure


@pytest.mark.parametrize("fail_full", [False, True],
                         ids=["ok", "full_point_fails"])
def test_payload_keys_match_bench_py(jax_bench, monkeypatch, capsys,
                                     fail_full):
  monkeypatch.setattr(jax_bench, "measure_object_level", lambda: 2000.0)
  monkeypatch.setattr(jax_bench, "measure_sensor_on", _stub_sensor(fail_full))
  monkeypatch.setattr("sys.argv", ["bench.py"])
  jax_bench.main()
  want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

  monkeypatch.setattr(bench, "measure_object_level",
                      lambda **kw: (2000.0, None))
  sensor = _stub_sensor(fail_full)
  monkeypatch.setattr(bench, "measure_sensor_on",
                      lambda full, **kw: (sensor(full), None))
  rc = bench.main([], device="cpu")
  got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert set(got) == set(want) | {"device"}
  assert got["device"] == "cpu"
  for k, v in want.items():
    if k.endswith("_error"):
      assert "sensor point failed" in got[k]
    else:
      assert got[k] == v, k
  # bench.py exits 0 after a failed point; the port reports it the same
  # way and then fails the process
  assert rc == (1 if fail_full else 0)
  assert ("sensor_on_full_error" in got) == fail_full


def test_stage_names_match_profile_sensor_stages():
  """The stage keys of bench.py's profile_sensor_stages, read from its
  source (running it compiles the full model), against the port's at
  B=2 on the CPU."""
  tree = ast.parse((ROOT / "bench.py").read_text())
  fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
            and n.name == "profile_sensor_stages")
  stages = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "stages")
  want = [k.value for k in stages.keys] + ["B", "config", "other_ms"]
  got = bench.profile_sensor_stages(False, reps=1, batch=2, device="cpu")
  assert list(got) == want
  assert got["B"] == 2 and got["config"] == "reduced"
  assert all(math.isfinite(got[k]) and got[k] > 0 for k in want[:6])
  assert got["other_ms"] == pytest.approx(
      got["full_policy_step"] - sum(got[k] for k in want[:5]), abs=2e-3)


@pytest.mark.parametrize("point", ["object", "reduced"])
def test_measure_functions_run_on_the_cpu(point):
  """The full sensor point differs from the reduced one only in its sizes
  (TransfuserConfig() in bf16 is slow on the CPU); the card runs it."""
  if point == "object":
    rate, state = bench.measure_object_level(batch=2, ticks=2, rounds=1,
                                             device="cpu")
  else:
    rate, state = bench.measure_sensor_on(False, ticks=2, rounds=1, batch=2,
                                          device="cpu")
    # the reduced point's LiDAR half sweep, decimated 4x
    assert state.agent.prev_lidar.shape[2] == 64 * 117
  assert math.isfinite(rate) and rate > 0
  assert state.tick.tolist() == [4, 4] or bool(state.done.any())


def test_measure_functions_refuse_a_missing_card():
  if torch.cuda.is_available():
    pytest.skip("a card is present")
  with pytest.raises(RuntimeError, match="is_available"):
    bench.measure_object_level(batch=2, ticks=1, rounds=1)


def test_throughput_and_trace(tmp_path):
  with trace(str(tmp_path / "t")) as prof:
    with span("sim.tick"):
      torch.ones(8).add_(1)
  assert prof is not None
  events = json.loads((tmp_path / "t" / "trace.json").read_text())
  assert events["traceEvents"]
  assert [e["name"] for e in events["traceEvents"]
          if e.get("cat") == "user_annotation"] == ["cgt.sim.tick"]
