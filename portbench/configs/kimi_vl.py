"""Kimi-VL-A3B (``kimi_vl.json``): MoonViT over the whole camera frame at
native resolution and a DeepSeek-V3-style decoder with latent attention
and 64 routed experts, driving through the sensor agent with SimLingo's
glue: the program's and the reference's model and sensor policy, built
from the same sizes and weights.

The program is ``carla_garage_tpu_torch`` (``models.kimi_vl.KimiVL``
through ``agents.sensor_agent.make_sensor_policy``, bf16); the reference
is ``reference/kimi_vl.py`` over the frozen ``reference/cgt``, in float32
with TF32 off. The simulator's settings come from ``tfpp.py``.

The model has 16.08B parameters, so its weights are made in pieces: each
tensor of the reference's layout from its own seed (``drawer``: the run's
weights seed and the tensor's index in the layout), by
``portbench/weights.py``'s rule. The program is built on the meta device
and each tensor drawn on the card and cast to bf16 as it is placed
(``KimiVL.load_published``), so 64 GB of float32 never exist at once. The
reference holds its float32 weights but for the routed experts', which
it draws when their layer runs (``reference/kimi_vl.ExpertSlot``): the
check then fits one card, the control included.
"""

from __future__ import annotations

import types

import numpy as np
import torch
from torch import nn

from portbench import harness, weights

TFPP = harness.load_config("tfpp")


def sizes(ctx) -> dict:
  """The configuration as this run uses it: the published sizes, or the
  tests' tiny ones on the CPU."""
  c = ctx.config.CONFIG
  return dict(c, **c["test_small"]) if ctx.small else c


def program_config(model: dict):
  from carla_garage_tpu_torch.models.kimi_vl import KimiVLConfig
  return KimiVLConfig(**model)


def program_model(model: dict):
  from carla_garage_tpu_torch.models.kimi_vl import KimiVL
  return KimiVL(program_config(model))


def reference_config(model: dict):
  from portbench.reference.kimi_vl import KimiConfig
  return KimiConfig(**model)


def reference_model(model: dict):
  from portbench.reference import kimi_vl
  return kimi_vl.model(reference_config(model))


def meta_inputs(model: dict, batch: int):
  """The forward's inputs (the frame, the two target points, speed,
  command)."""
  c = reference_config(model)
  z = lambda *s: torch.zeros(s)
  return (z(batch, 3, c.camera_height, c.camera_width), z(batch, 2, 2),
          z(batch), z(batch, 6))


def drawer(spec: list, seed: int, device):
  """fetch(name) -> the float32 tensor `name` of the layout `spec`, drawn
  on `device` from its own seed: (`seed`, its index in `spec`) through
  ``np.random.SeedSequence``, by ``weights.make_state_dict``'s rule."""
  index = {n: (i, s) for i, (n, s) in enumerate(spec)}

  def fetch(name: str) -> torch.Tensor:
    i, shape = index[name]
    sub = int(np.random.SeedSequence([int(seed), i]).generate_state(
        1, np.uint64)[0] >> 1)
    return weights.make_state_dict([(name, shape)], sub, device)[name]
  return fetch


def _spec(ctx) -> list:
  if not ctx.small:
    return weights.layout(ctx.config.CONFIG["name"])
  with torch.device("meta"):
    return weights.spec_of(reference_model(sizes(ctx)["model"]))


def build_model(ctx, side: str):
  """The seed's weights in the model of `side` ("program": in bf16 where
  the policy runs bf16, else float32; "reference": float32, its routed
  experts drawn as they run) on the run's device."""
  from portbench.reference import kimi_vl
  s = sizes(ctx)
  m = s["model"]
  fetch = drawer(_spec(ctx), ctx.seeds["weights"], ctx.device)
  if side == "program":
    with torch.device("meta"):
      model = program_model(m)
    dtype = torch.bfloat16 if s["policy"]["bf16"] else torch.float32
    return model.load_published(fetch, dtype)
  with torch.device("meta"):
    model = reference_model(m)
  lazy = {id(lin) for e in model.modules()
          if isinstance(e, kimi_vl.ExpertSlot) for lin in e.children()}
  for name, mod in model.named_modules():
    for pname, _ in list(mod.named_parameters(recurse=False)):
      full = f"{name}.{pname}" if name else pname
      t = torch.empty(0, device=ctx.device) if id(mod) in lazy else \
          fetch(full)
      setattr(mod, pname, nn.Parameter(t, requires_grad=False))
  template, commands = kimi_vl.template_and_commands(model.cfg)
  model.template_ids = template.to(ctx.device)
  model.command_ids = commands.to(ctx.device)
  model.draw = fetch
  return model


def _grids(pkg: str, cfg, s: dict):
  from importlib import import_module
  cam = import_module(f"{pkg}.sensors.camera").camera_ray_grid
  lid = import_module(f"{pkg}.sensors.lidar").lidar_ray_grid
  d = s["sensors"]["lidar_decimate"]
  return (cam(cfg, scale=1), lid(cfg, half=0, decimate=d),
          lid(cfg, half=1, decimate=d))


def eval_build(ctx, traffic: dict, model_hook):
  """The program's side of an eval cell: the scene from the seed, the
  seeded model (bf16, on the meta device first) with `model_hook`
  registered as a forward hook, and the sensor policy with its agent
  state. A second hook keeps the program's chosen experts, as uint8 on
  the device, at every tick among which the driver draws those it checks:
  the warm-up's and the window's first ``check_within`` (``ctx.
  kimi_routes``, {tick: [MoE layers, B * L, top_k]}, for the check)."""
  from carla_garage_tpu_torch import config as pcfg
  from carla_garage_tpu_torch.agents.sensor_agent import (make_sensor_policy,
                                                          sensor_grids)
  from carla_garage_tpu_torch.sim.scene_builder import make_town_batch
  s = sizes(ctx)
  cfg = TFPP.sim_config(pcfg, s)
  B = traffic["batch"]
  _, maps, lanes, scene, state = make_town_batch(
      cfg, traffic["town"], batch=B, seed=ctx.seeds["scene"],
      n_vehicles=s["sim"]["max_vehicles"], n_walkers=traffic["n_walkers"],
      use_scenarios=traffic["use_scenarios"], device=ctx.device)
  ctx.stage("scene")
  vcfg = program_config(s["model"])
  model = build_model(ctx, "program")
  model.register_forward_hook(model_hook)
  ctx.kimi_routes = {}
  keep, calls = traffic["warmup_ticks"] + traffic["check_within"], [0]
  assert vcfg.n_routed_experts <= 256

  def keep_routes(module, args, out):
    if calls[0] < keep:
      ctx.kimi_routes[calls[0]] = module.routes.to(torch.uint8)
    calls[0] += 1
  model.register_forward_hook(keep_routes)
  ctx.stage("model")
  policy, reset = make_sensor_policy(
      model, None, vcfg,
      sensor_grids(cfg, vcfg, lidar_decimate=s["sensors"]["lidar_decimate"]),
      bf16=s["policy"]["bf16"])
  state = state.replace(agent=reset(cfg, B, device=ctx.device))
  ctx.stage("policy")
  return types.SimpleNamespace(cfg=cfg, maps=maps, lanes=lanes, scene=scene,
                               state=state, policy=policy, batch=B)


def eval_reference(ctx, model, cast: str = "fp32"):
  """The reference's (cfg, policy) around `model`: the camera-only policy
  of ``reference/kimi_vl.py`` over the frozen pieces in float32, or with
  the bf16 casts for cast="bf16" (the control). A reference model is
  offered the program's chosen experts at the checked ticks and takes
  those within the configuration's ``routes`` ``tie`` of its own
  (``reference/kimi_vl.near_tie``; the ``assumed`` ``routes``)."""
  from portbench.reference import kimi_vl
  from portbench.reference.cgt import config as rcfg
  s = sizes(ctx)
  cfg = TFPP.sim_config(rcfg, s)
  vcfg = reference_config(s["model"])
  grids = _grids("portbench.reference.cgt",
                 kimi_vl.camera_config(cfg, vcfg), s)
  routes = getattr(ctx, "kimi_routes", None) \
      if isinstance(model, kimi_vl.KimiVLReference) else None
  return cfg, kimi_vl.make_policy(model, vcfg, *grids, bf16=cast == "bf16",
                                  routes=routes,
                                  tie=ctx.config.CONFIG["routes"]["tie"])


def print_expert_load():
  """The program's counter of tokens per expert (``model.moe.
  expert_load``, [MoE layers, experts], added to by every forward since
  the model was built) on standard error: each layer's largest over its
  mean, the worst layer's, and the experts that got no token. Nothing
  where the program has no such counter."""
  import sys
  from portbench.program_spans import _profiling
  get = getattr(_profiling(), "counters", None)
  load = None if get is None else get().get("model.moe.expert_load")
  if load is None:
    return
  load = load.double().cpu()
  mean = load.mean(1).clamp(min=1e-9)
  ratio = load.max(1).values / mean
  print(f"kimi_vl expert load: {int(load.sum())} token-expert pairs over "
        f"{load.shape[0]} layers; max/mean a layer "
        f"{[round(float(r), 3) for r in ratio]}, worst "
        f"{float(ratio.max())!r} (layer {int(ratio.argmax())}); "
        f"{int((load == 0).sum())} experts took no token", file=sys.stderr)
