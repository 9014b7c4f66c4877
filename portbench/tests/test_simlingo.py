"""The cell ``simlingo.eval`` (SimLingo on InternVL2-1B, camera only) at
the tests' sizes on the CPU, with tiny traffic of its own: a sound run is
correct, the control and the planted faults are not, and a traced run
reads the two spans; the three new readers on synthetic records; and
``reference/simlingo.vlm_cost`` against a count by hand."""

import time

import pytest

from portbench import faults, harness
from portbench.reference import peaks, simlingo
from portbench.trace import Trace
from portbench.tests.test_tfpp_vswin import BEGIN, END, op

CELL = "simlingo.eval"
SEED = 12345678901            # larger than 32 signed bits
TINY = {"batch": 2, "chunk": 4, "check_within": 8, "check_ticks": 2,
        "profile_at": 2, "profile_ticks": 2}
READERS = ("vision_ms.eval", "language_ms.eval", "roofline.vlm.eval")


def tiny_run(trace: bool = False) -> dict:
  return harness.run_cell(CELL, SEED, 0.5, trace, time.perf_counter(),
                          device="cpu", small=True, traffic_override=TINY,
                          check_cards=False)


def tiny_values(mutate_ctx=None, control: bool = False) -> dict:
  """The compared numbers of a tiny run (no limits), with `mutate_ctx`
  applied to the context before set-up; with `control` the control's
  too."""
  ctx = harness.make_context(CELL, SEED, False, device="cpu", small=True,
                             traffic_override=TINY)[0]
  undo = mutate_ctx(ctx) if mutate_ctx is not None else None
  harness.point_caches()
  drv = harness.load_driver(ctx.traffic["driver"]).Driver(ctx)
  drv.setup()
  drv.window(0.3)
  drv.release()
  if undo is not None:
    undo()
  return drv.check(control=control)


def verdict(values: dict, prefix: str = "") -> bool:
  return harness.judge([{"name": k, "value": values[prefix + k],
                         "limit": v}
                        for k, v in harness.load_limits(CELL).items()])[0]


def test_tiny_run_is_correct():
  result = tiny_run()
  assert result["correct"], result["checks"]
  assert {"setup_s", "env_steps_per_s"} <= set(result["metrics"])
  # the tiles and the tick's arithmetic are the reference's
  assert result["checks"]["sensors_gap"]["value"] == 0.0
  assert result["checks"]["step_gap"]["value"] == 0.0


def test_control_is_not_correct():
  values = tiny_values(control=True)
  assert verdict(values)
  assert not verdict(values, "control_"), values


@pytest.mark.parametrize("fault", ["eval_state_unchanged", "eval_half_batch",
                                   "eval_control_altered",
                                   "eval_sensor_altered"])
def test_fault_is_not_correct(fault):
  values = tiny_values(lambda ctx: faults.FAULTS[fault](ctx))
  assert not verdict(values), values


def test_traced_tiny_run_reads_the_spans(capsys):
  result = tiny_run(trace=True)
  assert result["correct"]
  # on the CPU the forward runs eagerly: the spans are ordinary ones, and
  # no marker kernel, so no roofline
  assert result["metrics"]["vision_ms.eval"]["value"] > 0
  assert result["metrics"]["language_ms.eval"]["value"] > 0
  assert "roofline.vlm.eval" not in result["metrics"]
  err = capsys.readouterr().err
  c = harness.load_config("simlingo").CONFIG["test_small"]["model"]
  tokens = 2 * (c["template_len"] + 3 * 4 + 3 + c["path_points"]
                + c["speed_points"])
  assert "vision_ms: model.vision counts [6]" in err       # 2 x 3 tiles
  assert f"language_ms: model.language counts [{tokens}]" in err


def synthetic_ops() -> list:
  """Two replays of a forward with the vision span (marker 0) and the
  language span (marker 1)."""
  ops = []
  for corr, t0 in ((7, 0.0), (8, 1000.0)):
    ops += [op(t0, 5, "inputs", corr),
            op(t0 + 10, 1, BEGIN.format(0), corr),
            op(t0 + 12, 300, "vit", corr),
            op(t0 + 320, 1, END.format(0), corr),
            op(t0 + 330, 1, BEGIN.format(1), corr),
            op(t0 + 332, 100 + corr, "decoder", corr),
            op(t0 + 500, 1, END.format(1), corr)]
  return ops


def test_readers_on_a_synthetic_trace(monkeypatch):
  from carla_garage_tpu_torch.utils import profiling
  monkeypatch.setattr(profiling, "_marker_ids",
                      {"model.vision": 0, "model.language": 1})
  cfg = harness.load_config("simlingo").CONFIG
  rec = {"kind": "eval", "trace": Trace(synthetic_ops(), {}, [], []),
         "batch": 16, "precision": "bf16",
         "flops_per_sample": cfg["forward_flops_per_sample"]}
  assert harness.load_reader("vision_ms.eval").read(rec) == \
      pytest.approx(0.3)
  assert harness.load_reader("language_ms.eval").read(rec) == \
      pytest.approx(0.1075)
  bound = peaks.bound_s(*simlingo.vlm_cost(16), "bf16")
  roof = harness.load_reader("roofline.vlm.eval").read(rec)
  assert roof == pytest.approx(100.0 * bound * 2 / 0.815e-3)


@pytest.mark.parametrize("config", ["tfpp", "tfpp_vswin"])
def test_readers_read_nothing_in_other_configurations(config, monkeypatch):
  from carla_garage_tpu_torch.utils import profiling
  monkeypatch.setattr(profiling, "_marker_ids",
                      {"model.vision": 0, "model.language": 1})
  flops = harness.load_config(config).CONFIG["forward_flops_per_sample"]
  rec = {"kind": "eval", "trace": Trace(synthetic_ops(), {}, [], []),
         "batch": 16, "precision": "bf16", "flops_per_sample": flops,
         "window_start": 0.0, "window_s": 1.0, "traced": set()}
  for name in READERS:
    assert harness.load_reader(name).read(rec) is None, name


def test_vlm_cost_counts_by_hand():
  """At the published widths and B = 1: 3 tiles of 1,025 tokens, 768
  image tokens, a sequence of 839."""
  n_bytes, flops = simlingo.vlm_cost(1)
  T, N, n, C, M = 3, 1025, 1024, 1024, 4096
  h, kv, m, L = 896, 128, 4864, 839
  vit = T * 2 * n * 588 * C + 24 * T * (
      2 * N * (4 * C * C + 2 * C * M) + 4 * N * N * C)
  proj = 2 * T * 256 * (4 * C * h + h * h)
  dec = 24 * (2 * L * (2 * h * h + 2 * h * kv + 3 * h * m)
              + 2 * h * L * (L + 1))
  assert flops == vit + proj + dec
  assert flops == 2_808_392_663_040
  assert n_bytes == 7_972_767_744
