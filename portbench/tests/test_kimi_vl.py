"""The cell ``kimi_vl.eval`` (Kimi-VL-A3B in SimLingo's driving mode) at
the tests' sizes on the CPU, with tiny traffic of its own: a sound run is
correct, the control and the planted faults are not, and a traced run
reads the new spans; the four new readers on synthetic records and their
silence in other configurations; ``reference/kimi_vl.moe_cost`` and
``vlm_cost`` against counts by hand and ``FlopCounterMode``; the weights
drawn in pieces, the same on both sides and with the reference's routed
experts left empty until their layer runs."""

import time

import pytest
import torch

from portbench import faults, harness, weights
from portbench.reference import kimi_vl, peaks
from portbench.trace import Trace
from portbench.tests.test_tfpp_vswin import BEGIN, END, op

CELL = "kimi_vl.eval"
SEED = 12345678901            # larger than 32 signed bits
TINY = {"batch": 2, "chunk": 4, "check_within": 8, "check_ticks": 2,
        "profile_at": 2, "profile_ticks": 2}
READERS = ("moe_ms.eval", "mla_ms.eval", "moonvit_ms.eval",
           "roofline.moe.eval")


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


def test_tiny_run_is_correct(capsys):
  result = tiny_run()
  assert result["correct"], result["checks"]
  assert {"setup_s", "env_steps_per_s"} <= set(result["metrics"])
  assert result["checks"]["sensors_gap"]["value"] == 0.0
  assert result["checks"]["step_gap"]["value"] == 0.0
  # the reference saw the program's choice of experts at each checked tick
  assert "kimi_vl routes: tick 0," in capsys.readouterr().err


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


def plant_router_fault(kind: str):
  """A context mutation that makes the program's router pick other
  experts: "no_bias" ranks by the scores without
  ``e_score_correction_bias``, "shifted_ids" names each chosen expert by
  the next one's id (the experts run are the named ones)."""
  from carla_garage_tpu_torch.models import moe

  def plant(ctx):
    sound = moe.Router.forward

    def forward(self, x):
      if kind == "no_bias":
        scores = torch.nn.functional.linear(x.float(),
                                            self.weight.float()).sigmoid()
        ids = torch.topk(scores, self.top_k, dim=-1).indices
        w = scores.gather(1, ids)
        return ids, w / w.sum(-1, keepdim=True) * self.scale
      ids, w = sound(self, x)
      return (ids + 1) % self.weight.shape[0], w
    moe.Router.forward = forward
    return lambda: setattr(moe.Router, "forward", sound)
  return plant


@pytest.mark.parametrize("kind", ["no_bias", "shifted_ids"])
def test_router_fault_is_not_correct(kind, capsys):
  """The reference takes the program's choice of experts only where it is
  a near-tie of its own: a router that picks others is caught."""
  values = tiny_values(plant_router_fault(kind))
  assert not verdict(values), values
  assert "refused beyond the tie" in capsys.readouterr().err


def test_near_tie_takes_only_near_ties():
  choice = torch.tensor([[0.9, 0.5, 0.49, 0.1],
                         [0.9, 0.5, 0.49, 0.1],
                         [0.9, 0.5, 0.49, 0.1],
                         [0.9, 0.5, 0.49, 0.1]])
  own = torch.topk(choice, 2, dim=-1).indices
  prog = torch.tensor([[1, 0], [0, 2], [0, 3], [0, 0]])
  ids, margin = kimi_vl.near_tie(choice, own, prog, 0.02)
  # the same set in another order; a near-tie; a miss by 0.4; not two
  # distinct experts
  assert torch.equal(ids, torch.stack([prog[0], prog[1], own[2], own[3]]))
  assert margin[0] < 0 and margin[1] == pytest.approx(0.01)
  assert margin[2] == pytest.approx(0.4) and margin[3] == float("inf")


def test_traced_tiny_run_reads_the_spans(capsys):
  result = tiny_run(trace=True)
  assert result["correct"]
  # on the CPU the forward runs eagerly: ordinary spans, no marker kernel,
  # so no roofline
  for name in ("moe_ms.eval", "mla_ms.eval", "moonvit_ms.eval"):
    assert result["metrics"][name]["value"] > 0, name
  assert "roofline.moe.eval" not in result["metrics"]
  err = capsys.readouterr().err
  c = harness.load_config("kimi_vl").CONFIG["test_small"]["model"]
  L = c["template_len"] + 8 + 3 + c["path_points"] + c["speed_points"]
  assert f"moe_ms.eval: model.moe counts [{2 * L * 2}]" in err
  assert f"mla_ms.eval: model.mla counts [{2 * L}]" in err
  assert "moonvit_ms.eval: model.vision counts [2]" in err
  assert "kimi_vl expert load:" in err


def synthetic_ops() -> list:
  """Two replays of a forward: the vision span (marker 0) once, the MLA
  span (marker 1) and the MoE span (marker 2) twice each."""
  ops = []
  for corr, t0 in ((7, 0.0), (8, 1000.0)):
    ops += [op(t0, 5, "inputs", corr),
            op(t0 + 10, 1, BEGIN.format(0), corr),
            op(t0 + 12, 300, "vit", corr),
            op(t0 + 320, 1, END.format(0), corr)]
    for k in range(2):
      t = t0 + 330 + 200 * k
      ops += [op(t, 1, BEGIN.format(1), corr),
              op(t + 2, 20, "mla", corr),
              op(t + 30, 1, END.format(1), corr),
              op(t + 40, 1, BEGIN.format(2), corr),
              op(t + 42, 50 + corr, "experts", corr),
              op(t + 150, 1, END.format(2), corr)]
  return ops


MARKERS = {"model.vision": 0, "model.mla": 1, "model.moe": 2}


def test_readers_on_a_synthetic_trace(monkeypatch):
  from carla_garage_tpu_torch.utils import profiling
  monkeypatch.setattr(profiling, "_marker_ids", MARKERS)
  cfg = harness.load_config("kimi_vl").CONFIG
  rec = {"kind": "eval", "trace": Trace(synthetic_ops(), {}, [], []),
         "batch": 16, "precision": "bf16",
         "flops_per_sample": cfg["forward_flops_per_sample"]}
  assert harness.load_reader("moonvit_ms.eval").read(rec) == \
      pytest.approx(0.3)
  assert harness.load_reader("mla_ms.eval").read(rec) == pytest.approx(0.04)
  # the two MoE spans of a replay summed: 2 x 57 us, 2 x 58 us
  assert harness.load_reader("moe_ms.eval").read(rec) == \
      pytest.approx(0.115)
  bound = peaks.bound_s(*kimi_vl.moe_cost(16), "bf16")
  roof = harness.load_reader("roofline.moe.eval").read(rec)
  assert roof == pytest.approx(100.0 * bound * 2 / 0.230e-3)


@pytest.mark.parametrize("config", ["tfpp", "simlingo"])
def test_readers_read_nothing_in_other_configurations(config, monkeypatch):
  from carla_garage_tpu_torch.utils import profiling
  monkeypatch.setattr(profiling, "_marker_ids", MARKERS)
  flops = harness.load_config(config).CONFIG["forward_flops_per_sample"]
  rec = {"kind": "eval", "trace": Trace(synthetic_ops(), {}, [], []),
         "batch": 16, "precision": "bf16", "flops_per_sample": flops,
         "window_start": 0.0, "window_s": 1.0, "traced": set()}
  for name in READERS:
    assert harness.load_reader(name).read(rec) is None, name


def test_moe_cost_counts_by_hand():
  """At the published widths and B = 1: 583 tokens, each through 6
  routed experts of 1,408 and the shared SwiGLU of 2,816, over 26
  layers; every expert's weights read once a layer."""
  n_bytes, flops = kimi_vl.moe_cost(1)
  L, h, E, W = 583, 2048, 64, 1408
  per_tok = 2 * (h * E + 6 * 3 * h * W + 3 * h * 2 * W)
  assert flops == 26 * L * per_tok
  weights_bytes = 2 * (E * 3 * h * W + 3 * h * 2 * W) + 4 * E * h + 4 * E
  assert n_bytes == 26 * (weights_bytes + L * 6 * h)
  # at B = 16 the layers are bound by their operations: about 34 ms
  assert peaks.bound_s(*kimi_vl.moe_cost(16), "bf16") == pytest.approx(
      kimi_vl.moe_cost(16)[1] / peaks.FLOPS["bf16"])
  assert 0.033 < kimi_vl.moe_cost(16)[1] / peaks.FLOPS["bf16"] < 0.035


def test_vlm_cost_is_the_counted_forward():
  """``vlm_cost``'s operations against ``FlopCounterMode`` on the meta
  device (which sees every expert pair of the reference's loop): equal
  but for the glue's MLPs and read-outs."""
  from portbench.reference.flops import forward_flops
  config = harness.load_config("kimi_vl")
  c = config.CONFIG
  with torch.device("meta"):
    model = config.reference_model(c["model"])
    inputs = config.meta_inputs(c["model"], 1)
  counted = forward_flops(model, inputs)
  _, flops = kimi_vl.vlm_cost(1)
  assert flops == c["forward_flops_per_sample"]
  h = c["model"]["hidden_size"]
  # two target points through 2 -> h -> h, the speed through 1 -> h -> h,
  # 28 queries read out by h -> 2
  glue = 2 * (2 * 2 * h + 2 * h * h) + (2 * h + 2 * h * h) + 28 * 2 * h * 2
  assert counted - flops == glue
  assert 4.94e12 < flops < 4.96e12


def test_weights_drawn_in_pieces_agree():
  """The program's bf16 model and the reference hold the same draws; the
  reference's routed experts stay empty and are drawn as their layer
  runs, the same numbers as the program's stacked experts."""
  ctx = harness.make_context(CELL, SEED, False, device="cpu", small=True,
                             traffic_override=TINY)[0]
  config = ctx.config
  prog = config.build_model(ctx, "program")
  ref = config.build_model(ctx, "reference")
  spec = dict(weights.spec_of(ref))
  assert sum(p.numel() for p in ref.parameters()) < \
      sum(p.numel() for p in prog.parameters())
  name = "language_model.layers.1.mlp.experts.3.down_proj.weight"
  assert spec[name] == (0,)
  drawn = ref.draw(name)
  assert torch.equal(drawn.to(torch.bfloat16),
                     prog.language_model.layers[1].mlp.experts.down[3])
  assert prog.language_model.layers[1].mlp.gate.weight.dtype == \
      torch.float32
  assert torch.equal(prog.language_model.layers[1].mlp.gate.weight,
                     ref.language_model.layers[1].mlp.gate.weight)
  with ref.language_model.layers[1].mlp.experts[3].weights(ref.draw) as ex:
    assert torch.equal(ex.down_proj.weight, drawn)
  assert ref.language_model.layers[1].mlp.experts[3].down_proj.weight \
      .numel() == 0
