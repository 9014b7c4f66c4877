"""PlanT (``plant.json``): the program's and the reference's model, PlanT
policy and training step, built from the same sizes and weights, in
float32 with TF32 off on both sides.

The program is ``carla_garage_tpu_torch``; the reference is the frozen
copy in ``portbench/reference/cgt``.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from portbench import weights
from portbench.reference import lowp


def sizes(ctx) -> dict:
  """The configuration as this run uses it: the published sizes, or the
  tests' tiny ones on the CPU."""
  c = ctx.config.CONFIG
  return dict(c, **c["test_small"]) if ctx.small else c


def _pcfg(pkg, model: dict):
  from importlib import import_module
  return import_module(f"{pkg}.models.plant").PlanTConfig(**model)


def program_model(model: dict):
  from carla_garage_tpu_torch.models.plant import PlanT
  return PlanT(_pcfg("carla_garage_tpu_torch", model))


def reference_model(model: dict):
  from portbench.reference.cgt.models.plant import PlanT
  return PlanT(_pcfg("portbench.reference.cgt", model))


def meta_inputs(model: dict, batch: int):
  """The forward's inputs (boxes, box types, route, three flags, speed)."""
  p = _pcfg("portbench.reference.cgt", model)
  z = lambda *s: torch.zeros(s)
  return (z(batch, p.max_objects, p.num_attributes),
          torch.zeros((batch, p.max_objects), dtype=torch.int32),
          z(batch, p.num_route_points, 2), z(batch), z(batch), z(batch),
          z(batch))


def build_model(ctx, side: str):
  m = sizes(ctx)["model"]
  make = program_model if side == "program" else reference_model
  spec = weights.layout(ctx.config.CONFIG["name"]) if not ctx.small else \
      weights.spec_of(reference_model(m))
  return weights.build(lambda: make(m), spec, ctx.seeds["weights"],
                       ctx.device)


def sim_config(pkg_config, s: dict):
  cfg = pkg_config.DEFAULT_CONFIG
  return cfg.replace(sim=dataclasses.replace(cfg.sim, **s["sim"]))


def exact(ctx):
  """The configuration's float32 without TF32, set for the program."""
  lowp._set_tf32(False)


# --- closed-loop evaluation -------------------------------------------------

def eval_build(ctx, traffic: dict, model_hook):
  from carla_garage_tpu_torch import config as pcfg
  from carla_garage_tpu_torch.agents.plant_agent import (make_plant_policy,
                                                         plant_agent_reset)
  from carla_garage_tpu_torch.sim.scene_builder import make_town_batch
  exact(ctx)
  s = sizes(ctx)
  cfg = sim_config(pcfg, s)
  B = traffic["batch"]
  _, maps, lanes, scene, state = make_town_batch(
      cfg, traffic["town"], batch=B, seed=ctx.seeds["scene"],
      n_vehicles=s["sim"]["max_vehicles"], n_walkers=traffic["n_walkers"],
      use_scenarios=traffic["use_scenarios"], device=ctx.device)
  ctx.stage("scene")
  state = state.replace(agent=plant_agent_reset(cfg, B, device=ctx.device))
  model = build_model(ctx, "program")
  model.register_forward_hook(model_hook)
  ctx.stage("model")
  p = s["policy"]
  policy = make_plant_policy(model, None,
                             _pcfg("carla_garage_tpu_torch", s["model"]),
                             direct=p["direct"],
                             brake_threshold=p["brake_threshold"],
                             creep=p["creep"])
  ctx.stage("policy")
  return types.SimpleNamespace(cfg=cfg, maps=maps, lanes=lanes, scene=scene,
                               state=state, policy=policy, batch=B)


def eval_reference(ctx, model, cast: str = "fp32"):
  from portbench.reference.cgt import config as rcfg
  from portbench.reference.cgt.agents.plant_agent import make_plant_policy
  s = sizes(ctx)
  p = s["policy"]
  return sim_config(rcfg, s), make_plant_policy(
      model, None, _pcfg("portbench.reference.cgt", s["model"]),
      direct=p["direct"], brake_threshold=p["brake_threshold"],
      creep=p["creep"])


# --- training -----------------------------------------------------------------

def _dataset(ctx, traffic, pkg):
  """PlanT's dataset from expert frames on a scene from the seed, made by
  the port's own datagen (the benchmark's input to both sides)."""
  from carla_garage_tpu_torch import config as pcfg
  from carla_garage_tpu_torch.sim.datagen import collect_expert_frames
  from carla_garage_tpu_torch.sim.scene_builder import make_town_batch
  from carla_garage_tpu_torch.train.plant_train import build_plant_dataset
  s = sizes(ctx)
  cfg = sim_config(pcfg, s)
  _, maps, lanes, scene, state = make_town_batch(
      cfg, traffic["town"], batch=traffic["episodes"],
      seed=ctx.seeds["scene"], n_vehicles=s["sim"]["max_vehicles"],
      n_walkers=traffic["n_walkers"], device=ctx.device)
  ctx.stage("scene")
  gen = torch.Generator(device=ctx.device).manual_seed(ctx.seeds["draws"])
  with torch.no_grad():
    _, frames = collect_expert_frames(cfg, maps, lanes, scene, state,
                                      traffic["frames"], generator=gen)
    ctx.stage("expert frames")
    return build_plant_dataset(cfg, _pcfg("carla_garage_tpu_torch",
                                          s["model"]), frames, scene)


def train_build(ctx, traffic: dict):
  """The program's training step at the cell's batch and its feed:
  ``iterate_minibatches`` with the velocity dropout, drawn by the seed."""
  from carla_garage_tpu_torch.train import plant_train as pt
  from carla_garage_tpu_torch.train.transfuser_train import make_optimizer
  exact(ctx)
  s = sizes(ctx)
  ds = _dataset(ctx, traffic, "carla_garage_tpu_torch")
  model = build_model(ctx, "program")
  opt, _ = make_optimizer(model, s["train"]["lr"], 1_000_000,
                          schedule=None)
  step = pt.make_train_step(model, opt)
  ctx.stage("dataset, model and step")
  it = pt.iterate_minibatches(ds, traffic["batch_size"],
                              np.random.default_rng(ctx.seeds["sample"]),
                              epochs=1_000_000,
                              velocity_dropout=pt.VELOCITY_DROPOUT)
  return types.SimpleNamespace(
      model=model, optimizer=opt, step=step, next_inputs=lambda k: next(it),
      samples_per_step=traffic["batch_size"], n_samples=len(ds))


def train_reference(ctx, traffic: dict, model, data=None,
                    cast: str = "fp32"):
  """The reference's (optimizer, step) around `model`: the frozen loss
  and AdamW on the same batches."""
  from portbench.reference.cgt.train import plant_train as pt
  from portbench.reference.cgt.train.transfuser_train import make_optimizer
  s = sizes(ctx)
  opt, _ = make_optimizer(model, s["train"]["lr"], 1_000_000,
                          schedule=None)
  return opt, pt.make_train_step(model, opt)
