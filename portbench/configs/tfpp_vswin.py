"""TransFuser++ with a Video Swin-T LiDAR branch over 16 LiDAR frames
(``tfpp_vswin.json``): the program's and the reference's model and sensor
policy, built from the same sizes and weights.

The program is ``carla_garage_tpu_torch`` with a ``VideoTransfuserConfig``
(``lidar_arch="video_swin_t"``); the reference is ``reference/vswin.py``
over the frozen ``reference/cgt``, in float32 with TF32 off. Both sensor
agents keep the half sweeps the program's model takes
(``lidar_history``). The sizes for the run, the
simulator's settings and the sensors' ray grids come from ``tfpp.py``.
"""

from __future__ import annotations

import types

import torch

from portbench import harness, weights

TFPP = harness.load_config("tfpp")
# the model's keys of the video branch -> reference.vswin.VSwinConfig's
SWIN = {"lidar_seq_len": "seq_len", "swin_embed_dim": "embed_dim",
        "swin_depths": "depths", "swin_heads": "heads",
        "swin_window": "window", "swin_patch": "patch",
        "swin_mlp_ratio": "mlp_ratio"}
# of those, the published block's own in the program (its constants)
FIXED = ("swin_patch", "swin_mlp_ratio")


def _tuples(model: dict) -> dict:
  return {k: tuple(v) if isinstance(v, list) else v
          for k, v in model.items()}


def program_config(model: dict):
  from carla_garage_tpu_torch.models.transfuser import VideoTransfuserConfig
  return VideoTransfuserConfig(**{k: v for k, v in _tuples(model).items()
                                  if k not in FIXED})


def program_model(model: dict):
  from carla_garage_tpu_torch.models.transfuser import LidarCenterNet
  return LidarCenterNet(program_config(model))


def reference_configs(model: dict):
  """(the frozen TransfuserConfig, VSwinConfig) of the model's sizes."""
  from portbench.reference.cgt.models.transfuser import TransfuserConfig
  from portbench.reference.vswin import VSwinConfig
  m = _tuples(model)
  v = VSwinConfig(in_channels=m["lidar_channels"],
                  **{SWIN[k]: m.pop(k) for k in SWIN})
  return TransfuserConfig(**m), v


def reference_model(model: dict):
  from portbench.reference import vswin
  return vswin.model(*reference_configs(model))


def meta_inputs(model: dict, batch: int):
  """The forward's inputs (rgb, the LiDAR frames' BEV, target point,
  command, speed)."""
  t, v = reference_configs(model)
  z = lambda *s: torch.zeros(s)
  return (z(batch, t.img_h, t.img_w, 3),
          z(batch, t.lidar_h, t.lidar_w, t.lidar_channels * v.seq_len),
          z(batch, 2), z(batch, 6), z(batch))


def build_model(ctx, side: str):
  """The seed's weights in the model of `side` ("program" or
  "reference") on the run's device."""
  m = TFPP.sizes(ctx)["model"]
  make = program_model if side == "program" else reference_model
  spec = weights.layout(ctx.config.CONFIG["name"]) if not ctx.small else \
      weights.spec_of(reference_model(m))
  return weights.build(lambda: make(m), spec, ctx.seeds["weights"],
                       ctx.device)


def eval_build(ctx, traffic: dict, model_hook):
  """The program's side of an eval cell, as ``tfpp.eval_build`` makes it,
  with the sensor agent keeping the half sweeps the model takes."""
  from carla_garage_tpu_torch import config as pcfg
  from carla_garage_tpu_torch.agents.sensor_agent import (
      make_transfuser_policy, sensor_agent_reset)
  from carla_garage_tpu_torch.models.transfuser import lidar_history
  from carla_garage_tpu_torch.sim.scene_builder import make_town_batch
  s = TFPP.sizes(ctx)
  cfg = TFPP.sim_config(pcfg, s)
  B = traffic["batch"]
  _, maps, lanes, scene, state = make_town_batch(
      cfg, traffic["town"], batch=B, seed=ctx.seeds["scene"],
      n_vehicles=s["sim"]["max_vehicles"], n_walkers=traffic["n_walkers"],
      use_scenarios=traffic["use_scenarios"], device=ctx.device)
  ctx.stage("scene")
  cam, lid_f, lid_r = TFPP._grids("carla_garage_tpu_torch", cfg, s)
  tcfg = program_config(s["model"])
  state = state.replace(agent=sensor_agent_reset(
      cfg, B, lid_f.shape[0] * lid_f.shape[1], seq_len=lidar_history(tcfg),
      device=ctx.device))
  model = build_model(ctx, "program")
  model.register_forward_hook(model_hook)
  ctx.stage("model")
  p = s["policy"]
  policy = make_transfuser_policy(
      model, None, tcfg, cam, lid_f, lid_r,
      direct=p["direct"], bf16=p["bf16"],
      brake_threshold=p["brake_threshold"])
  ctx.stage("policy")
  return types.SimpleNamespace(cfg=cfg, maps=maps, lanes=lanes, scene=scene,
                               state=state, policy=policy, batch=B)


def eval_reference(ctx, model, cast: str = "fp32"):
  """The reference's (cfg, policy) around `model`: the frozen sensor
  policy (its buffer voxelizes the older sweeps one at a time) in
  float32, or with the bf16 casts for cast="bf16" (the control)."""
  from portbench.reference.cgt import config as rcfg
  from portbench.reference.cgt.agents.sensor_agent import \
      make_transfuser_policy
  s = TFPP.sizes(ctx)
  cfg = TFPP.sim_config(rcfg, s)
  cam, lid_f, lid_r = TFPP._grids("portbench.reference.cgt", cfg, s)
  p = s["policy"]
  policy = make_transfuser_policy(
      model, None, reference_configs(s["model"])[0], cam, lid_f, lid_r,
      direct=p["direct"], bf16=cast == "bf16",
      brake_threshold=p["brake_threshold"])
  return cfg, policy
