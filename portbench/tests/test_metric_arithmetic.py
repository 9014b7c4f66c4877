"""The metrics' arithmetic on synthetic inputs: percentiles with their
counts, idle share from intervals, roofline and MFU from frozen counts."""

import math

import pytest
import torch

from portbench import harness
from portbench.common import percentile, rel_gap, tree_gap
from portbench.reference import peaks
from portbench.trace import Trace, merge


def reader(name):
  return harness.load_reader(name)


def test_percentile_and_count():
  xs = list(range(1, 201))                      # 200 ticks
  p95 = percentile(xs, 95)
  assert p95 == pytest.approx(190.05)
  assert sum(x > p95 for x in xs) == 10         # ten samples beyond it
  assert percentile([5.0], 95) == 5.0


def test_tick_p95_reads_every_tick():
  rec = {"kind": "eval", "tick_ms": [10.0] * 190 + [100.0] * 10}
  # rank 189.05 of 0..199: 10 + 0.05 * (100 - 10)
  assert reader("tick_ms.p95").read(rec) == pytest.approx(14.5)
  assert reader("tick_ms.p95").read({"kind": "train"}) is None


def test_rates():
  ev = {"kind": "eval", "episode_ticks": 3200, "alive_ticks": 3000,
        "window_s": 32.0}
  assert reader("env_steps_per_s").read(ev) == 100.0
  tr = {"kind": "train", "samples": 640, "window_s": 20.0}
  assert reader("samples_per_s").read(tr) == 32.0
  assert reader("env_steps_per_s").read(tr) is None


def toy_trace():
  # a stretch of 100 us; device busy 10-30, 20-40 (overlapping), 60-70
  ops = [(10.0, 20.0, "k_a", 1), (20.0, 20.0, "k_b", 2),
         (60.0, 10.0, "k_a", 3)]
  launches = {1: (5.0, 7), 2: (15.0, 7), 3: (55.0, 7)}
  ranges = [("portbench.stretch", 0.0, 100.0, 7),
            ("portbench.raycast_boxes", 4.0, 12.0, 7),
            ("portbench.policy", 50.0, 10.0, 7)]
  cpu_ops = [("aten::conv2d", 52.0, 5.0, 7)]
  return Trace(ops, launches, ranges, cpu_ops)


def test_idle_share_from_intervals():
  assert merge([(3, 4), (0, 2), (1, 3)]) == [[0, 4]]
  tr = toy_trace()
  assert tr.window_s == pytest.approx(100e-6)
  assert tr.busy_s == pytest.approx(40e-6)      # 10-40 and 60-70
  assert tr.idle_share() == pytest.approx(0.6)
  rec = {"kind": "eval", "trace": tr}
  assert reader("idle_share.eval").read(rec) == pytest.approx(60.0)
  assert reader("idle_share.train").read(rec) is None


def test_idle_gaps_by_host():
  gaps = dict(toy_trace().idle_by_host(10))
  # 0-10 closes with the launch at 5 in the raycast range, 40-60 with the
  # launch at 55 inside policy/aten::conv2d, 70-100 at the stretch's end
  assert gaps["raycast_boxes"] == pytest.approx(10e-6)
  assert gaps["policy/aten::conv2d"] == pytest.approx(20e-6)
  assert gaps["stretch"] == pytest.approx(30e-6)


def test_range_device_time():
  s, n = toy_trace().range_device_s("portbench.raycast_boxes")
  assert (s, n) == (pytest.approx(40e-6), 2)    # launched at 5 and 15


def test_roofline_from_frozen_counts():
  from portbench.reference.cgt.ops.raycast import raycast_boxes_cost
  g = torch.Generator().manual_seed(0)
  B, N, K = 2, 64, 3
  origins = torch.zeros(B, 3)
  dirs = torch.nn.functional.normalize(torch.randn(B, N, 3, generator=g),
                                       dim=-1)
  boxes = torch.zeros(B, K, 9)
  boxes[..., 0] = 5.0
  boxes[..., 2] = 1.0
  boxes[..., 4:7] = 1.0
  boxes[..., 8] = 1.0
  n_bytes, flops, _, _ = raycast_boxes_cost(origins, dirs, boxes)
  assert n_bytes == 4 * (B * 3 + B * N * 3 + B * K * 9 + 2 * B * N)
  bound = peaks.bound_s(n_bytes, flops, "fp32")
  tr = toy_trace()
  rec = {"kind": "eval", "trace": tr,
         "calls": {"raycast_boxes": [((origins, dirs, boxes), {})]}}
  share = reader("roofline.raycast_boxes.eval").read(rec)
  assert share == pytest.approx(100 * bound / 40e-6)
  rec["calls"] = {}
  assert reader("roofline.raycast_boxes.eval").read(rec) is None


def test_mfu_from_frozen_counts():
  rec = {"kind": "eval", "flops_per_sample": 1e9, "batch": 16,
         "precision": "bf16", "tick_ms": [100.0, 500.0, 100.0],
         "traced": {1}}
  want = 100 * 1e9 * 16 * 2 / 0.2 / 989e12
  assert reader("mfu.eval").read(rec) == pytest.approx(want)
  tr = {"kind": "train", "flops_per_sample": 1e9, "samples_per_step": 64,
        "precision": "fp32", "step_ms": [1000.0, 2000.0], "traced": set()}
  want = 100 * 3 * 1e9 * 64 * 2 / 3.0 / 67e12
  assert reader("mfu.train").read(tr) == pytest.approx(want)


def test_spans_of_eval_and_sim():
  rec = {"kind": "eval", "tick_ms": [10.0, 20.0, 30.0],
         "policy_ms": [4.0, 5.0, 6.0], "traced": {2}}
  assert reader("policy_ms.eval").read(rec) == pytest.approx(4.5)
  assert reader("sim_ms.eval").read(rec) == pytest.approx(10.5)


def test_gaps():
  a = torch.tensor([1.0, 2.0, 4.0])
  assert rel_gap(a, a) == 0.0
  assert rel_gap(a, torch.tensor([1.0, 2.0, 2.0])) == pytest.approx(1.0)
  assert rel_gap(a, torch.ones(2)) == math.inf
  assert rel_gap(torch.tensor([math.nan]), torch.tensor([1.0])) == math.inf
  g, where = tree_gap({"x": a, "y": a}, {"x": a, "y": a * 2}, 1.0)
  assert (g, where) == (pytest.approx(0.5), ".y")
  assert tree_gap({"x": a}, {"z": a})[0] == math.inf


def test_norm_gap():
  from portbench.common import norm_gap
  a = torch.tensor([3.0, 4.0])
  assert norm_gap({"x": a}, {"x": a}) == (0.0, ".x")
  g, where = norm_gap({"x": a + torch.tensor([0.0, 0.5])}, {"x": a})
  assert (g, where) == (pytest.approx(0.1), ".x")
  # every output as one vector: |(0, 0.5, 0)| / |(3, 4, 12)|
  g, where = norm_gap({"x": a + torch.tensor([0.0, 0.5]),
                       "y": torch.tensor([12.0])},
                      {"x": a, "y": torch.tensor([12.0])})
  assert (g, where) == (pytest.approx(0.5 / 13), ".x")
  assert norm_gap({"x": a}, {"x": a[:1]})[0] == math.inf
