"""Training steps: the configuration's own training step, driven with its
feed until the window is over; the steps make no host sync, and the
window ends in one.

Traffic parameters (``traffic/<name>.json``) are the configuration's
(its ``train_build`` reads them), plus follow_steps (the first steps,
run in set-up through the window's own call and feed, that the reference
follows), profile_at and profile_steps (the traced stretch, in steps from
the window's start).

The record it leaves for the metrics' readers: kind "train",
window_start, window_s, samples (steps x samples_per_step over the
window), step_ms (the gaps between CUDA events at consecutive step
entries, the last closed by an event after the window's sync),
samples_per_step, traced (window step indices that the profiler's start
and stop touch), flops_per_sample, precision, trace and calls.

``correct``: the reference, in float32 with TF32 off, takes the same
weights and follows the same first steps on the same inputs. The gaps
(``compare``) are of each followed step's total loss; of the norm of
each parameter's first gradient as the optimizer got it (AdamW's first
moment after step 1 over 1 - beta1); and of the norm of each
parameter's change over the followed steps, leaving out parameters whose
reference gradient is under a thousandth of the median parameter's (they
move by round-off alone under Adam). A norm's gap is the difference of
the two norms over the larger of the reference's norm of that parameter
and of the median parameter. ``limits/<cell>.json`` names the ones a
cell compares.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from portbench import harness
from portbench.common import EventLog, clone_tree
from portbench.reference import lowp
from portbench.spans import Spans
from portbench.trace import Profiler

TINY_GRAD = 1e-3       # share of the median parameter's reference gradient


def _named(model):
  """The parameters under the names of the plain model (a control's
  parametrized weights under their own names)."""
  return [(n.replace(".parametrizations.weight.original", ".weight"), p)
          for n, p in model.named_parameters()]


def _first_grads(model, optimizer) -> dict:
  """{name: norm of the first gradient} from AdamW's state after one step."""
  out = {}
  for name, p in _named(model):
    st = optimizer.state.get(p, {})
    beta1 = next(g["betas"][0] for g in optimizer.param_groups
                 if any(q is p for q in g["params"]))
    m = st.get("exp_avg")
    out[name] = torch.zeros((), device=p.device) if m is None else \
        torch.linalg.vector_norm(m.float()) / (1.0 - beta1)
  return out


def follow(model, optimizer, step, inputs: list):
  """Run the followed steps: ({step: total loss}, first-gradient norms,
  change norms), all as floats."""
  theta0 = {n: p.detach().clone() for n, p in _named(model)}
  losses, g1 = [], None
  for k, inp in enumerate(inputs):
    aux = step(inp)
    losses.append(aux["loss"].detach().clone())
    if k == 0:
      g1 = _first_grads(model, optimizer)
  change = {n: torch.linalg.vector_norm((p.detach() - theta0[n]).float())
            for n, p in _named(model)}
  del theta0
  return ([float(x) for x in losses], {n: float(v) for n, v in g1.items()},
          {n: float(v) for n, v in change.items()})


def norm_gaps(prog: dict, ref: dict, names) -> dict:
  """{name: |norm_p - norm_r| / max(norm_r, the median norm_r)}."""
  names = list(names)
  if not names or set(names) - set(prog) or set(names) - set(ref):
    return {"": math.inf}
  med = statistics.median(ref[n] for n in names)
  return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
          for n in names}


def worst(gaps: dict) -> tuple:
  """(the largest gap, its parameter)."""
  name = max(gaps, key=gaps.get)
  return gaps[name], name


def compare(prog, ref, where: dict | None = None) -> dict:
  """The gaps of the followed steps; `where`, when given, gets the
  parameter of each worst leaf. loss_gap: the worst step's total loss;
  first_loss_gap: the first step's; grad_gap and change_gap: the worst
  parameter's; median_grad_gap and median_change_gap: the median
  parameter's (steady from seed to seed where bf16 round-off makes a few
  small parameters swing)."""
  (lp, gp, dp), (lr, gr, dr) = prog, ref
  if len(lp) != len(lr) or not lp:
    return {k: math.inf for k in NUMBERS}
  med = statistics.median(gr.values())
  moving = [n for n in gr if gr[n] >= TINY_GRAD * med]
  grads = norm_gaps(gp, gr, gr)
  changes = norm_gaps(dp, dr, moving)
  grad, g_at = worst(grads)
  change, c_at = worst(changes)
  if where is not None:
    where.update(grad_gap=g_at, change_gap=c_at,
                 left_out=len(gr) - len(moving))
  losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr)]
  return {"loss_gap": max(losses), "first_loss_gap": losses[0],
          "grad_gap": grad, "median_grad_gap": statistics.median(
              grads.values()),
          "change_gap": change, "median_change_gap": statistics.median(
              changes.values())}


NUMBERS = ("loss_gap", "first_loss_gap", "grad_gap", "median_grad_gap",
           "change_gap", "median_change_gap")


class Driver:
  def __init__(self, ctx):
    self.ctx = ctx
    self.cuda = ctx.device == "cuda"
    self.events = EventLog(self.cuda)
    self.spans = Spans()
    self.profiler = Profiler(harness.BUILD / "traces" / f"{ctx.cell}.json") \
        if ctx.trace else None
    self._range = None

  def setup(self):
    ctx, t = self.ctx, self.ctx.traffic
    self.tr = ctx.config.train_build(ctx, t)
    self.inputs = [clone_tree(self.tr.next_inputs(k))
                   for k in range(t["follow_steps"])]
    self.k = t["follow_steps"]
    self.prog = follow(self.tr.model, self.tr.optimizer, self.tr.step,
                       [clone_tree(x) for x in self.inputs])
    ctx.stage("followed steps")
    self.w0 = self.k
    self.prof_start = self.w0 + t["profile_at"]
    self.prof_end = self.prof_start + t["profile_steps"]
    if ctx.trace:
      self.spans.install(ctx.readers)

  def _stretch(self, k: int):
    if self.profiler is None:
      return
    if k == self.prof_start:
      self.profiler.start()
      self.spans.recording = True
      self._range = torch.profiler.record_function("portbench.stretch")
      self._range.__enter__()
    elif k == self.prof_end and self.profiler.active:
      self._range.__exit__(None, None, None)
      self.spans.recording = False
      self.profiler.stop()

  def window(self, seconds: float) -> dict:
    tr = self.tr
    if self.cuda:
      torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    while True:
      self._stretch(self.k)
      self.events.mark("step")
      rng = torch.profiler.record_function("portbench.step") \
          if self.ctx.trace else None
      if rng is not None:
        rng.__enter__()
      tr.step(tr.next_inputs(self.k))
      if rng is not None:
        rng.__exit__(None, None, None)
      self.k += 1
      n += 1
      if time.perf_counter() - t0 >= seconds and \
          (self.profiler is None or self.k > self.prof_end):
        break
    self._stretch(self.prof_end)
    self.events.mark("step")
    if self.cuda:
      torch.cuda.synchronize()
    t1 = time.perf_counter()
    self.spans.uninstall()
    traced = set()
    if self.profiler is not None:
      traced = set(range(self.prof_start - 1 - self.w0,
                         self.prof_end - self.w0))
    cfg = self.ctx.config.CONFIG
    return {
        "kind": "train", "window_start": t0, "window_s": t1 - t0,
        "samples": n * tr.samples_per_step,
        "samples_per_step": tr.samples_per_step,
        "step_ms": self.events.gaps_ms("step", "step", 1)[:n],
        "traced": traced,
        "flops_per_sample": cfg["forward_flops_per_sample"],
        "precision": cfg["precision"],
        "trace": self.profiler.read() if self.profiler is not None and
        self.profiler.prof is not None else None,
        "calls": self.spans.calls}

  def release(self):
    """Free the program's model, optimizer and step (the followed inputs
    and the data they index stay: they are the benchmark's inputs)."""
    self.data = getattr(self.tr, "data", None)
    self.tr = None
    gc.collect()
    if self.cuda:
      torch.cuda.empty_cache()

  def _reference(self, control: bool):
    cfg = self.ctx.config
    model = cfg.build_model(self.ctx, "reference")
    if control:
      model = lowp.control_model(model, cfg.CONFIG["precision"])
      lowp.round_inputs(model, cfg.CONFIG["control"]["inputs"])
    cast = cfg.CONFIG["control"]["cast"] if control else "fp32"
    opt, step = cfg.train_reference(self.ctx, self.ctx.traffic, model,
                                    self.data, cast)
    return follow(model, opt, step, [clone_tree(x) for x in self.inputs])

  def check(self, control: bool = False) -> dict:
    self.where = {}
    with lowp.exact_float32():
      ref = self._reference(False)
      values = compare(self.prog, ref, self.where)
      if control:
        with lowp.control_precision(
            self.ctx.config.CONFIG["control"]["model"]):
          low = self._reference(True)
        values.update({f"control_{k}": v
                       for k, v in compare(low, ref).items()})
    return values
