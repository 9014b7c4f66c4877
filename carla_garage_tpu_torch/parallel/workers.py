"""Rank functions for ``launch.spawn``: one data-parallel train step or
sharded rollout per call, from inputs saved with ``torch.save`` to a file
(the ranks read the same file). Each also runs as one process with
``mesh=None``, the reference a data-parallel run is held against: on the
card, unless `device` names the CPU. They live in the package because a
spawned rank imports its function's module afresh.
"""

from __future__ import annotations

import torch

from carla_garage_tpu_torch.parallel import mesh as mesh_lib
from carla_garage_tpu_torch.structs import tree_map


def _device(mesh, device):
  return mesh.device if mesh is not None else torch.device(device)


def _load(path, dev):
  """The inputs a caller saved; on a card, float32 matmuls and
  convolutions without TF32 (the comparisons are float32)."""
  if dev.type == "cuda":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
  return torch.load(path, weights_only=False)


def _named_grads(named) -> dict:
  return {n: p.grad.detach().clone() for n, p in named
          if p.grad is not None}


def transfuser_step_rank(mesh, path, device="cuda") -> list:
  """Float32 TransFuser++ train steps from one file. It holds cfg, tcfg,
  state_dict, maps, scene, frames (the global batch), camera_grid,
  lidar_grid, f_idx, draws (one dict per micro-batch for the global
  batch) and runs: one dict per step to take from the same weights, with
  optimizer ("sgd", "adamw" or "zero1", ZeRO-1 over the mesh), lr, and
  optionally clip_norm, log_vars (Kendall weighting) and schedule.
  Returns per run the aux losses, the gradients the optimizer stepped on,
  the parameters after the step and the optimizer-state bytes this rank
  holds."""
  from carla_garage_tpu_torch.models.transfuser import LidarCenterNet
  from carla_garage_tpu_torch.train.schedules import init_log_vars
  from carla_garage_tpu_torch.train.transfuser_train import (
      LOSS_WEIGHTS, make_optimizer, make_transfuser_train_step,
      trainable_params)
  dev = _device(mesh, device)
  p = _load(path, dev)
  maps, scene, frames = tree_map(lambda x: x.to(dev),
                                 (p["maps"], p["scene"], p["frames"]))
  draws = tree_map(lambda x: x.to(dev), p["draws"])
  out = []
  for run in p["runs"]:
    model = LidarCenterNet(p["tcfg"])
    model.load_state_dict(p["state_dict"])
    model = model.to(dev)
    if mesh is not None:
      mesh_lib.replicate(mesh, model.state_dict())
    log_vars = init_log_vars(tuple(LOSS_WEIGHTS), dev) \
        if run.get("log_vars") else None
    sched = None
    if run["optimizer"] == "sgd":
      opt = torch.optim.SGD(trainable_params(model) +
                            list((log_vars or {}).values()), lr=run["lr"])
    else:
      opt, sched = make_optimizer(
          model, run["lr"], steps=10, schedule=run.get("schedule"),
          log_vars=log_vars,
          mesh=mesh if run["optimizer"] == "zero1" else None)
    step, _, _ = make_transfuser_train_step(
        p["cfg"], p["tcfg"], model, opt, maps, scene, frames,
        p["camera_grid"], p["lidar_grid"], log_vars=log_vars,
        clip_norm=run.get("clip_norm"), scheduler=sched, mesh=mesh)
    aux = step(p["f_idx"], draws=draws)
    out.append(dict(
        aux=aux, grads=_named_grads(model.named_parameters()),
        log_var_grads=_named_grads((log_vars or {}).items()),
        params={n: q.detach().clone() for n, q in model.named_parameters()},
        opt_bytes=mesh_lib.optimizer_state_bytes(opt)))
  return out


def transfuser_eval_rank(mesh, path, device="cuda") -> dict:
  """The float32 TransFuser++ ``eval_step`` on a file that
  ``transfuser_step_rank`` takes (its runs are not used): f_idx rendered
  with the given draws, each rank its slice of the episodes. Returns the
  eval aux (losses, mIoU, confusion, checkpoint angle error) of the
  global batch."""
  from carla_garage_tpu_torch.models.transfuser import LidarCenterNet
  from carla_garage_tpu_torch.train.transfuser_train import \
      make_transfuser_train_step
  dev = _device(mesh, device)
  p = _load(path, dev)
  maps, scene, frames = tree_map(lambda x: x.to(dev),
                                 (p["maps"], p["scene"], p["frames"]))
  model = LidarCenterNet(p["tcfg"])
  model.load_state_dict(p["state_dict"])
  model = model.to(dev)
  _, eval_step, _ = make_transfuser_train_step(
      p["cfg"], p["tcfg"], model, torch.optim.SGD(model.parameters(), lr=0.0),
      maps, scene, frames, p["camera_grid"], p["lidar_grid"], mesh=mesh)
  return eval_step(p["f_idx"],
                   draws=tree_map(lambda x: x.to(dev), p["draws"]))


def plant_step_rank(mesh, path, device="cuda") -> list:
  """PlanT train steps from one file. It holds pcfg, state_dict, batch (the
  global sample batch), speed_weights and runs: one dict per step from the
  same weights, with lr and optionally log_vars. Returns per run the aux
  losses and the gradients (SGD steps, so the weights' update is the
  gradient)."""
  from carla_garage_tpu_torch.models.plant import PlanT
  from carla_garage_tpu_torch.train.plant_train import (LOSS_KEYS,
                                                        make_train_step)
  from carla_garage_tpu_torch.train.schedules import init_log_vars
  dev = _device(mesh, device)
  p = _load(path, dev)
  batch = tree_map(lambda x: x.to(dev), p["batch"])
  out = []
  for run in p["runs"]:
    model = PlanT(p["pcfg"])
    model.load_state_dict(p["state_dict"])
    model = model.to(dev)
    if mesh is not None:
      mesh_lib.replicate(mesh, model.state_dict())
    log_vars = init_log_vars(LOSS_KEYS, dev) if run.get("log_vars") \
        else None
    opt = torch.optim.SGD(list(model.parameters()) +
                          list((log_vars or {}).values()), lr=run["lr"])
    aux = make_train_step(model, opt, log_vars=log_vars,
                          speed_weights=p["speed_weights"],
                          mesh=mesh)(batch)
    out.append(dict(aux=aux, grads=_named_grads(model.named_parameters()),
                    log_var_grads=_named_grads((log_vars or {}).items())))
  return out


def rollout_records_rank(mesh, path, device="cuda") -> list:
  """The expert on a synthetic episode batch, sharded over the ranks,
  through ``rollout_chunked``; the gathered records (route ids m_0,
  m_1, ...). The file holds cfg, build (``make_synthetic_batch``'s
  arguments), ticks, chunk and draws (one dict per tick for the global
  batch)."""
  from carla_garage_tpu_torch.eval.benchmark import (_records,
                                                     _shard_episode_batch)
  from carla_garage_tpu_torch.sim.episode import rollout_chunked
  from carla_garage_tpu_torch.sim.scene_builder import make_synthetic_batch
  dev = _device(mesh, device)
  p = _load(path, dev)
  cfg = p["cfg"]
  _, maps, lanes, scene, state = make_synthetic_batch(cfg, device=dev,
                                                      **p["build"])
  B = int(state.tick.shape[0])
  ids = [f"m_{i}" for i in range(B)]
  ticks = iter(p["draws"])

  def draw_fn():
    d = tree_map(lambda x: x.to(dev), next(ticks))
    return d if mesh is None else mesh_lib.shard_leading(mesh, d, B)

  first = 0
  if mesh is not None:
    maps, lanes, scene, state = _shard_episode_batch(mesh, maps, lanes,
                                                     scene, state)
    part = mesh_lib.shard_slice(mesh, B)
    ids, first = ids[part], part.start
  final = rollout_chunked(cfg, maps, lanes, scene, state, p["ticks"],
                          chunk=p["chunk"], draw_fn=draw_fn)
  return mesh_lib.gather_records(
      mesh, _records(cfg, scene, final, ids, "SynthTown", first_index=first))


def benchmark_rank(mesh, kwargs: dict, chunk: int | None = None,
                   device="cuda"):
  """``run_carla_benchmark(**kwargs)`` on this rank's slice of the
  episodes; (records, global record). chunk replaces the runner's ticks a
  chunk (recorded or not) in this process."""
  from carla_garage_tpu_torch.eval import benchmark
  if chunk is not None:
    benchmark.CARLA_CHUNK = benchmark.RECORD_CHUNK = chunk
  return benchmark.run_carla_benchmark(mesh=mesh,
                                       device=_device(mesh, device),
                                       **kwargs)
