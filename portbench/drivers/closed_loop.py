"""Closed-loop evaluation: the policy drives the whole batch through
``sim.episode.rollout_chunked``, one chunk at a time, until the window is
over; each chunk ends in its own done check, the loop's one host sync.

Traffic parameters (``traffic/<name>.json``): town, batch, n_walkers,
use_scenarios, chunk (ticks a call), warmup_ticks (run in set-up, one
call: two ticks run every shape of the window, the LiDAR's front and
rear half), check_ticks (ticks whose step is checked, drawn from
the seed among the first check_within of the window; the first tick of
the run is always checked), profile_at and profile_ticks (the traced
stretch, in ticks from the window's start).

The record it leaves for the metrics' readers: kind "eval", batch,
window_start, window_s, episode_ticks (the batch times the window's
ticks: an episode that ends keeps its slot and is stepped, masked, like
the others), alive_ticks (those that began alive, from the state's
frozen tick counters), tick_ms (every window tick: the
gap between CUDA events at consecutive policy entries, the last closed by
an event after the last chunk's sync), policy_ms (entry to return of the
policy), traced (window tick indices that the profiler's start and stop
touch), flops_per_sample, precision, trace (a ``trace.Trace`` or None)
and calls (the spans' copied arguments).

``correct``: at each checked tick the step's input state and draws are
copied, with the model's inputs and outputs and the next state. After
the window the frozen reference, in float32 with TF32 off, runs the same
tick from that state: sensors_gap compares the model's inputs (camera,
LiDAR BEV, target point, command, speed) in the configuration's
precision (the largest difference over the largest value), model_gap
the model's outputs (the norm of the difference over the norm, all
outputs as one vector: the largest single difference, or one small
head's, swings from seed to seed under bf16 round-off), and step_gap the
change of the
state over the tick (sensors into the agent state, controls, UKF,
planners, scenarios, ego dynamics, traffic, walkers, criteria) against
that of the reference's tick run on the program's own model outputs, as
a served model's tokens are judged.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import harness
from portbench.common import (TO_REFERENCE, EventLog, clone_tree,
                              convert_tree, delta_gap, norm_gap, tree_gap)
from portbench.reference import lowp
from portbench.spans import Spans
from portbench.trace import Profiler

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


class Replay(torch.nn.Module):
  """A model that returns given outputs, for the reference's tick run on
  the program's own model outputs."""

  def __init__(self, out, device):
    super().__init__()
    self.anchor = torch.nn.Parameter(torch.zeros(1, device=device))
    self.out = out

  def forward(self, *args):
    return self.out


class Driver:
  def __init__(self, ctx):
    self.ctx = ctx
    t = ctx.traffic
    self.chunk = t["chunk"]
    self.cuda = ctx.device == "cuda"
    self.events = EventLog(self.cuda)
    self.spans = Spans()
    self.profiler = Profiler(harness.BUILD / "traces" / f"{ctx.cell}.json") \
        if ctx.trace else None
    self.tick = 0
    self.n_draw = 0
    self.caps = {}
    self.draws_at = {}
    self._cur = None
    self._pending = None
    self._ranges = []

  # --- the program's side -------------------------------------------------

  def _hook(self, module, args, out):
    if self._cur is not None and "model_out" not in self._cur:
      self._cur["model_in"] = clone_tree(args)
      self._cur["model_out"] = clone_tree(out)

  def _open(self, name):
    if self.ctx.trace:
      r = torch.profiler.record_function(f"portbench.{name}")
      r.__enter__()
      self._ranges.append(r)

  def _close(self):
    if self._ranges:
      self._ranges.pop().__exit__(None, None, None)

  def _draw(self):
    d = {k: (torch.randn if kind == "normal" else torch.rand)(
        (self.B,) + tuple(shape), generator=self.gen, device=self.ctx.device)
         for k, shape, kind in self.specs}
    if self.n_draw in self.check_at:
      self.draws_at[self.n_draw] = clone_tree(d)
    self.n_draw += 1
    return d

  def _policy(self, cfg, maps, scene, state, generator=None, draws=None):
    i = self.tick
    self.tick += 1
    self._close()                                   # the last tick's sim
    if self.profiler is not None:
      if i == self.prof_start:
        self.profiler.start()
        self.spans.recording = True
        self._open("stretch")
      elif i == self.prof_end:
        self._close()
        self.spans.recording = False
        self.profiler.stop()
    self.events.mark("tick")
    if self._pending is not None:
      self._pending["next"] = clone_tree(state)
      self._pending = None
    if i in self.check_at:
      self._cur = {"state": clone_tree(state), "draws": self.draws_at.pop(i)}
    self._open("policy")
    out = self.inner(cfg, maps, scene, state, generator=generator,
                     draws=draws)
    self._close()
    self.events.mark("policy_end")
    if self._cur is not None:
      self.caps[i] = self._pending = self._cur
      self._cur = None
    self._open("sim")
    return out

  def _run_chunk(self, ticks: int | None = None):
    from carla_garage_tpu_torch.sim.episode import rollout_chunked
    s = self.sim
    ticks = ticks or self.chunk
    self.state = rollout_chunked(s.cfg, s.maps, s.lanes, s.scene, self.state,
                                 ticks, chunk=ticks,
                                 policy=self._policy, generator=self.gen,
                                 draw_fn=self._draw)

  def setup(self):
    ctx, t = self.ctx, self.ctx.traffic
    # a plain function: the policy deep-copies the model, hooks included
    self.sim = ctx.config.eval_build(ctx, t, lambda *a: self._hook(*a))
    self.inner = self.sim.policy
    self.state = self.sim.state
    self.B = self.sim.batch
    self.gen = torch.Generator(device=ctx.device).manual_seed(
        ctx.seeds["draws"])
    self.specs = list(getattr(self.inner, "draw_specs", ()))
    from carla_garage_tpu_torch.structs import ScenarioSpecs, ScenarioState
    if isinstance(self.sim.scene.scenarios, ScenarioSpecs) and \
        isinstance(self.state.scenario, ScenarioState):
      self.specs.append(("control_loss",
                         (self.sim.scene.scenarios.kind.shape[1],),
                         "normal"))
    w0 = t["warmup_ticks"]
    rng = np.random.default_rng(ctx.seeds["sample"])
    picks = rng.choice(t["check_within"], size=t["check_ticks"],
                       replace=False)
    self.check_at = {0} | {w0 + int(p) for p in picks}
    self.prof_start = w0 + t["profile_at"]
    self.prof_end = self.prof_start + t["profile_ticks"]
    if ctx.trace:
      self.spans.install(ctx.readers)
    self._run_chunk(w0)
    self.w0 = self.tick

  def window(self, seconds: float) -> dict:
    start = self.state.tick.clone()
    if self.cuda:
      torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
      self._run_chunk()
      if time.perf_counter() - t0 >= seconds:
        break
    t1 = time.perf_counter()
    self._close()
    self.events.mark("tick")                  # closes the last tick's gap
    if self._pending is not None:
      self._pending["next"] = clone_tree(self.state)
      self._pending = None
    if self.profiler is not None and self.profiler.active:
      self._close()
      self.profiler.stop()
    if self.cuda:
      torch.cuda.synchronize()
    self.spans.uninstall()
    n = self.tick - self.w0
    tick_ms = self.events.gaps_ms("tick", "tick", 1)[self.w0:self.w0 + n]
    policy_ms = self.events.gaps_ms("tick", "policy_end")[self.w0:
                                                          self.w0 + n]
    traced = set()
    if self.profiler is not None:
      traced = set(range(self.prof_start - 1 - self.w0,
                         self.prof_end - self.w0))
    cfg = self.ctx.config.CONFIG
    return {
        "kind": "eval", "batch": self.B, "window_start": t0,
        "window_s": t1 - t0,
        "episode_ticks": self.B * (self.tick - self.w0),
        "alive_ticks": int((self.state.tick - start).sum()),
        "tick_ms": tick_ms, "policy_ms": policy_ms, "traced": traced,
        "flops_per_sample": cfg["forward_flops_per_sample"],
        "precision": cfg["precision"],
        "trace": self.profiler.read() if self.profiler is not None and
        self.profiler.prof is not None else None,
        "calls": self.spans.calls}

  def release(self):
    """Free the program: its policy, model and state (the scene, maps and
    lanes are the benchmark's inputs and stay for the reference)."""
    self.inner = self.sim.policy = self.state = self.sim.state = None
    gc.collect()
    if self.cuda:
      torch.cuda.empty_cache()

  # --- the reference's side -----------------------------------------------

  def _reference_tick(self, cap, model, replay_out=None, cast="fp32"):
    """The reference's (model inputs, model outputs, next state) of one
    checked tick, with `model`, or run on `replay_out` in its place; cast
    as the configuration's ``eval_reference`` takes it."""
    from portbench.reference.cgt.sim.episode import sim_step
    got = {}

    def hook(module, args, out):
      got.setdefault("in", clone_tree(args))
      got.setdefault("out", clone_tree(out))

    m = model if replay_out is None else Replay(replay_out, self.ctx.device)
    handle = m.register_forward_hook(hook)
    cfg, policy = self.ctx.config.eval_reference(self.ctx, m, cast)
    nxt = sim_step(cfg, self.ref_maps, self.ref_lanes, self.ref_scene,
                   cap["state"], policy, draws=dict(cap["draws"]))
    handle.remove()
    return got.get("in"), got.get("out"), nxt

  def _reference_model(self, control: bool):
    cfg = self.ctx.config.CONFIG
    model = self.ctx.config.build_model(self.ctx, "reference")
    if not control:
      return model
    low = lowp.control_model(model, cfg["precision"])
    lowp.round_inputs(low, cfg["control"]["inputs"])
    return low

  def check(self, control: bool = False) -> dict:
    """The worst gaps over the checked ticks (and with `control` also
    those of the control in the program's place: the model and its inputs
    one precision below the configuration's, the state's float32 in
    bfloat16, as the configuration's ``control`` names them)."""
    s = self.sim
    self.ref_maps, self.ref_lanes, self.ref_scene = (
        convert_tree(x, TO_REFERENCE) for x in (s.maps, s.lanes, s.scene))
    cfg = self.ctx.config.CONFIG
    dt = DTYPES[cfg["precision"]]
    names = ("sensors_gap", "model_gap", "step_gap")
    worst = {k: 0.0 for k in names}
    if control:
      worst.update({f"control_{k}": 0.0 for k in names})
    as_dt = lambda xs: [x.to(dt).float() for x in xs]
    replay = lambda out: {k: v.float() if isinstance(v, torch.Tensor) else v
                          for k, v in out.items()}

    def gaps(prefix, st, p_in, p_out, p_next):
      _, _, r_next = self._reference_tick(st, None, replay(p_out))
      for k, g in (("sensors_gap", tree_gap(as_dt(p_in), as_dt(r_in),
                                            1e-6)[0]),
                   ("model_gap", norm_gap(p_out, r_out)[0]),
                   ("step_gap", delta_gap(st["state"], p_next, r_next)[0])):
        worst[prefix + k] = max(worst[prefix + k], g)

    with lowp.exact_float32():
      ref = self._reference_model(False)
      low = self._reference_model(True) if control else None
      for i, cap in sorted(self.caps.items()):
        if "next" not in cap or "model_out" not in cap:
          worst = {k: math.inf for k in worst}
          continue
        st = {"state": convert_tree(cap["state"], TO_REFERENCE),
              "draws": cap["draws"]}
        r_in, r_out, _ = self._reference_tick(st, ref)
        gaps("", st, cap["model_in"], cap["model_out"],
             convert_tree(cap["next"], TO_REFERENCE))
        if control:
          with lowp.control_precision(cfg["control"]["model"]):
            c_in, c_out, c_next = self._reference_tick(
                st, low, cast=cfg["control"]["cast"])
          gaps("control_", st, c_in, c_out,
               lowp.round_tree(c_next, cfg["control"]["state"]))
    return worst
