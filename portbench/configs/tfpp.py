"""TransFuser++ (``tfpp.json``): the program's and the reference's model,
sensor policy and training step, built from the same sizes and weights.

The program is ``carla_garage_tpu_torch``; the reference is the frozen
copy in ``portbench/reference/cgt``, run in float32 with TF32 off and the
plain versions of both kernels.
"""

from __future__ import annotations

import dataclasses
import types

import torch

from portbench import weights


def sizes(ctx) -> dict:
  """The configuration as this run uses it: the published sizes, or the
  tests' tiny ones on the CPU."""
  c = ctx.config.CONFIG
  return dict(c, **c["test_small"]) if ctx.small else c


def _tcfg(pkg, model: dict):
  from importlib import import_module
  T = import_module(f"{pkg}.models.transfuser").TransfuserConfig
  return T(**{k: tuple(v) if isinstance(v, list) else v
              for k, v in model.items()})


def program_model(model: dict):
  from carla_garage_tpu_torch.models.transfuser import LidarCenterNet
  return LidarCenterNet(_tcfg("carla_garage_tpu_torch", model))


def reference_model(model: dict):
  from portbench.reference.cgt.models.transfuser import LidarCenterNet
  return LidarCenterNet(_tcfg("portbench.reference.cgt", model))


def meta_inputs(model: dict, batch: int):
  """The forward's inputs (rgb, LiDAR BEV, target point, command, speed)."""
  t = _tcfg("portbench.reference.cgt", model)
  z = lambda *s: torch.zeros(s)
  return (z(batch, t.img_h, t.img_w, 3),
          z(batch, t.lidar_h, t.lidar_w, t.lidar_channels), z(batch, 2),
          z(batch, 6), z(batch))


def build_model(ctx, side: str):
  """The seed's weights in the model of `side` ("program" or
  "reference") on the run's device."""
  m = sizes(ctx)["model"]
  make = program_model if side == "program" else reference_model
  spec = weights.layout(ctx.config.CONFIG["name"]) if not ctx.small else \
      weights.spec_of(reference_model(m))
  return weights.build(lambda: make(m), spec, ctx.seeds["weights"],
                       ctx.device)


def sim_config(pkg_config, s: dict):
  cfg = pkg_config.DEFAULT_CONFIG
  return cfg.replace(sim=dataclasses.replace(cfg.sim, **s["sim"]))


def _grids(pkg: str, cfg, s: dict):
  from importlib import import_module
  cam = import_module(f"{pkg}.sensors.camera").camera_ray_grid
  lid = import_module(f"{pkg}.sensors.lidar").lidar_ray_grid
  d = s["sensors"]["lidar_decimate"]
  return (cam(cfg, scale=s["sensors"]["camera_scale"]),
          lid(cfg, half=0, decimate=d), lid(cfg, half=1, decimate=d))


# --- closed-loop evaluation -------------------------------------------------

def eval_build(ctx, traffic: dict, model_hook):
  """The program's side of an eval cell: the scene from the seed (the
  port's own builder), the seeded model with `model_hook` registered as a
  forward hook before the policy copies it, and the policy."""
  from carla_garage_tpu_torch import config as pcfg
  from carla_garage_tpu_torch.agents.sensor_agent import (
      make_transfuser_policy, sensor_agent_reset)
  from carla_garage_tpu_torch.sim.scene_builder import make_town_batch
  s = sizes(ctx)
  cfg = sim_config(pcfg, s)
  B = traffic["batch"]
  _, maps, lanes, scene, state = make_town_batch(
      cfg, traffic["town"], batch=B, seed=ctx.seeds["scene"],
      n_vehicles=s["sim"]["max_vehicles"], n_walkers=traffic["n_walkers"],
      use_scenarios=traffic["use_scenarios"], device=ctx.device)
  ctx.stage("scene")
  cam, lid_f, lid_r = _grids("carla_garage_tpu_torch", cfg, s)
  state = state.replace(agent=sensor_agent_reset(
      cfg, B, lid_f.shape[0] * lid_f.shape[1], device=ctx.device))
  model = build_model(ctx, "program")
  model.register_forward_hook(model_hook)
  ctx.stage("model")
  p = s["policy"]
  policy = make_transfuser_policy(
      model, None, _tcfg("carla_garage_tpu_torch", s["model"]), cam, lid_f,
      lid_r, direct=p["direct"], bf16=p["bf16"],
      brake_threshold=p["brake_threshold"])
  ctx.stage("policy")
  return types.SimpleNamespace(cfg=cfg, maps=maps, lanes=lanes, scene=scene,
                               state=state, policy=policy, batch=B)


def eval_reference(ctx, model, cast: str = "fp32"):
  """The reference's (cfg, policy) around `model`: the frozen sensor
  policy in float32, or with the bf16 cast of weights and inputs for
  cast="bf16" (the control)."""
  from portbench.reference.cgt import config as rcfg
  from portbench.reference.cgt.agents.sensor_agent import \
      make_transfuser_policy
  s = sizes(ctx)
  cfg = sim_config(rcfg, s)
  cam, lid_f, lid_r = _grids("portbench.reference.cgt", cfg, s)
  p = s["policy"]
  policy = make_transfuser_policy(
      model, None, _tcfg("portbench.reference.cgt", s["model"]), cam, lid_f,
      lid_r, direct=p["direct"], bf16=cast == "bf16",
      brake_threshold=p["brake_threshold"])
  return cfg, policy


# --- training -----------------------------------------------------------------

def train_build(ctx, traffic: dict):
  """The program's training step and its feed: expert frames collected
  from the seed on a scene from the seed (the port's own datagen: the
  benchmark's input to both sides), the seeded model, AdamW with the clip,
  and the bf16 step over `micro_batches` frames of every episode. The
  feed cycles over the frames in orders drawn by the seed, with fresh
  LiDAR-dropoff and speed-dropout draws every micro-batch."""
  import numpy as np
  from carla_garage_tpu_torch import config as pcfg
  from carla_garage_tpu_torch.sensors.lidar import full_lidar_grid
  from carla_garage_tpu_torch.sim.datagen import collect_expert_frames
  from carla_garage_tpu_torch.sim.scene_builder import make_town_batch
  from carla_garage_tpu_torch.train import transfuser_train as tt
  s = sizes(ctx)
  cfg = sim_config(pcfg, s)
  B, M = traffic["batch"], traffic["micro_batches"]
  dev = ctx.device
  _, maps, lanes, scene, state = make_town_batch(
      cfg, traffic["town"], batch=B, seed=ctx.seeds["scene"],
      n_vehicles=s["sim"]["max_vehicles"], n_walkers=traffic["n_walkers"],
      device=dev)
  ctx.stage("scene")
  gen = torch.Generator(device=dev).manual_seed(ctx.seeds["draws"])
  with torch.no_grad():
    _, frames = collect_expert_frames(cfg, maps, lanes, scene, state,
                                      traffic["frames"], generator=gen)
  ctx.stage("expert frames")
  cam, _, _ = _grids("carla_garage_tpu_torch", cfg, s)
  lid = full_lidar_grid(cfg, decimate=s["sensors"]["lidar_decimate"])
  n_lidar = lid.shape[0] * lid.shape[1]
  model = build_model(ctx, "program")
  t = s["train"]
  opt, _ = tt.make_optimizer(model, t["lr"], 1_000_000, schedule=None)
  step, _, _ = tt.make_transfuser_train_step(
      cfg, _tcfg("carla_garage_tpu_torch", s["model"]), model, opt, maps,
      scene, frames, cam, lid, bf16=t["bf16"], clip_norm=t["clip_norm"])
  ctx.stage("model and step")
  F = traffic["frames"]
  rng = np.random.default_rng(ctx.seeds["sample"])
  order = []

  def next_inputs(k):
    while len(order) < (k + 1) * M:
      order.extend(int(i) for i in rng.permutation(F))
    draws = [{"lidar": torch.rand((B, n_lidar), generator=gen, device=dev),
              "speed_drop": torch.rand((B,), generator=gen, device=dev)
              < tt.SPEED_DROPOUT} for _ in range(M)]
    return {"f_idx": order[k * M:(k + 1) * M], "draws": draws}

  return types.SimpleNamespace(
      model=model, optimizer=opt,
      step=lambda inp: step(inp["f_idx"], draws=inp["draws"]),
      next_inputs=next_inputs, samples_per_step=B * M,
      data=(maps, scene, frames, cam, lid))


def train_reference(ctx, traffic: dict, model, data, cast: str = "fp32"):
  """The reference's (optimizer, step) around `model`: the frozen render,
  labels, forward and backward (float32, or with the bf16 casts for
  cast="bf16", the control), clip and AdamW on the same frames and
  draws."""
  from portbench.common import TO_REFERENCE, convert_tree
  from portbench.reference.cgt import config as rcfg
  from portbench.reference.cgt.train import transfuser_train as tt
  s = sizes(ctx)
  maps, scene, frames, cam, lid = data
  maps, scene, frames = (convert_tree(x, TO_REFERENCE)
                         for x in (maps, scene, frames))
  t = s["train"]
  opt, _ = tt.make_optimizer(model, t["lr"], 1_000_000, schedule=None)
  step, _, _ = tt.make_transfuser_train_step(
      sim_config(rcfg, s), _tcfg("portbench.reference.cgt", s["model"]),
      model, opt, maps, scene, frames, cam, lid, bf16=cast == "bf16",
      clip_norm=t["clip_norm"])
  return opt, lambda inp: step(inp["f_idx"], draws=inp["draws"])
