"""SimLingo (``simlingo.json``): InternVL2-1B's vision tower over three
448-pixel tiles and its Qwen2-0.5B decoder, driving through the sensor
agent: the program's and the reference's model and sensor policy, built
from the same sizes and weights.

The program is ``carla_garage_tpu_torch`` (``models.vla.SimLingo`` through
``agents.sensor_agent.make_sensor_policy``, bf16); the reference is
``reference/simlingo.py`` over the frozen ``reference/cgt``, in float32
with TF32 off. The camera is the model's own (896x448 at 110 degrees:
InternVL2's tiling gives two tiles and the thumbnail); the LiDAR half
sweep is rendered for the creep recovery's safety box alone. The
simulator's settings come from ``tfpp.py``.
"""

from __future__ import annotations

import types

import torch

from portbench import harness, weights

TFPP = harness.load_config("tfpp")


def sizes(ctx) -> dict:
  """The configuration as this run uses it: the published sizes, or the
  tests' tiny ones on the CPU."""
  c = ctx.config.CONFIG
  return dict(c, **c["test_small"]) if ctx.small else c


def program_config(model: dict):
  from carla_garage_tpu_torch.models.vla import SimLingoConfig
  return SimLingoConfig(**model)


def program_model(model: dict):
  from carla_garage_tpu_torch.models.vla import SimLingo
  return SimLingo(program_config(model))


def reference_config(model: dict):
  from portbench.reference.simlingo import VLAConfig
  return VLAConfig(**model)


def reference_model(model: dict):
  from portbench.reference import simlingo
  return simlingo.model(reference_config(model))


def meta_inputs(model: dict, batch: int):
  """The forward's inputs (tiles, the two target points, speed, command)."""
  from portbench.reference.simlingo import tiles_of
  c = reference_config(model)
  z = lambda *s: torch.zeros(s)
  return (z(batch, tiles_of(c), 3, c.tile, c.tile), z(batch, 2, 2),
          z(batch), z(batch, 6))


def build_model(ctx, side: str):
  """The seed's weights in the model of `side` ("program" or
  "reference") on the run's device."""
  m = sizes(ctx)["model"]
  make = program_model if side == "program" else reference_model
  spec = weights.layout(ctx.config.CONFIG["name"]) if not ctx.small else \
      weights.spec_of(reference_model(m))
  return weights.build(lambda: make(m), spec, ctx.seeds["weights"],
                       ctx.device)


def _grids(pkg: str, cfg, s: dict):
  from importlib import import_module
  cam = import_module(f"{pkg}.sensors.camera").camera_ray_grid
  lid = import_module(f"{pkg}.sensors.lidar").lidar_ray_grid
  d = s["sensors"]["lidar_decimate"]
  return (cam(cfg, scale=1), lid(cfg, half=0, decimate=d),
          lid(cfg, half=1, decimate=d))


def eval_build(ctx, traffic: dict, model_hook):
  """The program's side of an eval cell: the scene from the seed, the
  seeded model with `model_hook` registered as a forward hook before the
  policy copies it, and the sensor policy with its agent state."""
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
  ctx.stage("model")
  p = s["policy"]
  policy, reset = make_sensor_policy(
      model, None, vcfg,
      sensor_grids(cfg, vcfg, lidar_decimate=s["sensors"]["lidar_decimate"]),
      bf16=p["bf16"])
  state = state.replace(agent=reset(cfg, B, device=ctx.device))
  ctx.stage("policy")
  return types.SimpleNamespace(cfg=cfg, maps=maps, lanes=lanes, scene=scene,
                               state=state, policy=policy, batch=B)


def eval_reference(ctx, model, cast: str = "fp32"):
  """The reference's (cfg, policy) around `model`: the camera-only policy
  of ``reference/simlingo.py`` over the frozen pieces in float32, or with
  the bf16 casts for cast="bf16" (the control)."""
  from portbench.reference import simlingo
  from portbench.reference.cgt import config as rcfg
  s = sizes(ctx)
  cfg = TFPP.sim_config(rcfg, s)
  vcfg = reference_config(s["model"])
  grids = _grids("portbench.reference.cgt",
                 simlingo.camera_config(cfg, vcfg), s)
  return cfg, simlingo.make_policy(model, vcfg, *grids, bf16=cast == "bf16")
