"""The cell ``tfpp_vswin.eval`` (TransFuser++ with a Video Swin-T LiDAR
branch) at the tests' sizes on the CPU, with tiny traffic of its own: a
sound run is correct; the control and the planted faults are not; a
traced run reports the LiDAR history's time. And the reader of spans
inside a replayed CUDA graph (``markers``) on a synthetic trace."""

import time

import pytest

from portbench import faults, harness, markers
from portbench.reference import peaks, vswin
from portbench.trace import Trace

CELL = "tfpp_vswin.eval"
SEED = 12345678901            # larger than 32 signed bits
TINY = {"batch": 2, "chunk": 4, "check_within": 8, "check_ticks": 2,
        "profile_at": 2, "profile_ticks": 2}


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
  assert result["failed"] == 0
  # tick_ms.p95 reads CUDA events: none on the CPU
  assert {"setup_s", "env_steps_per_s"} <= set(result["metrics"])
  # the older sweeps' voxelization in one call is bit-equal to the
  # reference's call a sweep, and the tick's arithmetic is the same
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


def test_traced_tiny_run_reports_the_lidar_history(capsys):
  result = tiny_run(trace=True)
  assert result["correct"]
  assert result["metrics"]["lidar_history_ms.eval"]["value"] > 0
  # on the CPU the forward runs eagerly: the branch is an ordinary span,
  # and no marker kernel, so no roofline
  assert result["metrics"]["lidar_video_ms.eval"]["value"] > 0
  assert "roofline.lidar_video.eval" not in result["metrics"]
  # 2 episodes x 3 older half sweeps a tick
  assert "lidar_history: frames a tick [6]" in capsys.readouterr().err


# --- spans inside a replayed graph -------------------------------------------

def op(ts, dur, name, corr):
  return (float(ts), float(dur), name, corr)


BEGIN, END = "void (anonymous namespace)::cgt_span_begin<{}>()", \
    "void (anonymous namespace)::cgt_span_end<{}>()"


def synthetic_ops() -> list:
  """Two replays (correlations 7 and 8) of a graph with span 0 marked
  twice in each and span 1 once inside the first pair, and an eager
  kernel (correlation 9) between the replays; out of time order."""
  ops = []
  for corr, t0 in ((7, 0.0), (8, 1000.0)):
    ops += [op(t0, 5, "gemm", corr),                  # before: no
            op(t0 + 10, 1, BEGIN.format(0), corr),
            op(t0 + 12, 20, "sdpa", corr),            # yes
            op(t0 + 40, 1, BEGIN.format(1), corr),
            op(t0 + 42, 30, "layer_norm", corr),      # yes
            op(t0 + 80, 1, END.format(1), corr),
            op(t0 + 90, 1, END.format(0), corr),
            op(t0 + 95, 7, "fusion", corr),           # between: no
            op(t0 + 110, 1, BEGIN.format(0), corr),
            op(t0 + 112, 100 + corr, "mlp", corr),    # yes
            op(t0 + 300, 1, END.format(0), corr),
            op(t0 + 310, 9, "heads", corr)]           # after: no
  ops.append(op(600, 50, "eager", 9))
  return ops[::-1]


def test_marker_reader_sums_exactly_the_kernels_between_markers():
  ops = synthetic_ops()
  assert markers.replays_ms(ops, 0) == pytest.approx([0.157, 0.158])
  assert markers.replays_ms(ops, 1) == pytest.approx([0.030, 0.030])
  assert markers.replays_ms(ops, 2) == []


def test_marker_readers_on_a_synthetic_trace(monkeypatch, capsys):
  from carla_garage_tpu_torch.utils import profiling
  monkeypatch.setattr(profiling, "_marker_ids", {"model.lidar_video": 0})
  config = harness.load_config("tfpp_vswin")
  cfg = config.CONFIG
  rec = {"kind": "eval", "trace": Trace(synthetic_ops(), {}, [], []),
         "batch": 16, "precision": "bf16",
         "flops_per_sample": cfg["forward_flops_per_sample"]}
  ms = harness.load_reader("lidar_video_ms.eval").read(rec)
  assert ms == pytest.approx(0.1575)
  assert "lidar_video_ms: 2 replays" in capsys.readouterr().err
  # the frozen bound at the cell's sizes over the replays' time
  v = config.reference_configs(cfg["model"])[1]
  assert v == vswin.VSwinConfig()       # Video Swin-T, 16 frames of 2
  bound = peaks.bound_s(*vswin.lidar_video_cost(v, 16, (256, 256)), "bf16")
  roof = harness.load_reader("roofline.lidar_video.eval").read(rec)
  assert roof == pytest.approx(100.0 * bound * 2 / (0.315e-3))
  # another configuration's run, or a program without the markers
  other = dict(rec, flops_per_sample=1.0)
  assert harness.load_reader("roofline.lidar_video.eval").read(other) is None
  monkeypatch.setattr(profiling, "_marker_ids", {})
  assert harness.load_reader("lidar_video_ms.eval").read(
      dict(rec, window_start=0.0, window_s=1.0, traced=set())) is None
  assert harness.load_reader("roofline.lidar_video.eval").read(rec) is None


def test_branch_cost_counts_the_published_sizes():
  """The frozen count at the cell's sizes: the patch embedding, the linear
  layers on the padded tokens and two matmuls a window and head."""
  n_bytes, flops = vswin.lidar_video_cost(vswin.VSwinConfig(), 16,
                                          (256, 256))
  assert flops == 2_360_983_683_072
  assert n_bytes == 18_844_439_052
