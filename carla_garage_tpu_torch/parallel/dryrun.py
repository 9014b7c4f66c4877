"""The multi-device dry run (port of ``__graft_entry__.py``'s ``entry`` and
``dryrun_multichip``): the full training steps and the env step over a
data-parallel mesh of ranks.

  python -m carla_garage_tpu_torch.parallel.dryrun --n-devices 1
  python -m carla_garage_tpu_torch.parallel.dryrun --n-devices 2 \\
      --backend gloo --device cpu

The defaults run on the card over NCCL (one rank a card). gloo runs
several ranks on one card, or CPU processes with ``--device cpu``.
Each rank:

1. builds the whole synthetic episode batch, keeps its slice and runs one
   closed-loop ``sim_step`` of the expert on it, with its slice of the
   batch's draws;
2. records 12 expert frames of its episodes, gathers every rank's, and
   takes one data-parallel PlanT step (``micro_plant()`` with 12 objects
   and 8 route points; AdamW, the optimizer state replicated) on the
   global sample batch, each rank on its rows;
3. takes one data-parallel TransFuser++ step (the micro model at reduced
   sensor sizes, bf16) with ZeRO-1 AdamW, and reports the optimizer-state
   bytes per rank, sharded against replicated;
4. runs the synthetic benchmark sharded over the ranks (64 ticks in
   chunks of 32) and gathers its records.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.device import resolve_device
from carla_garage_tpu_torch.parallel import launch
from carla_garage_tpu_torch.parallel import mesh as mesh_lib
from carla_garage_tpu_torch.sim.episode import sim_step
from carla_garage_tpu_torch.sim.scene_builder import make_synthetic_batch

N_FRAMES = 12                    # expert frames of the training stages
BENCH_TICKS, BENCH_CHUNK = 64, 32


def entry(device="cuda"):
  """(fn, example_args): the full closed-loop sim step (the expert policy
  inside) over a small batch."""
  _, maps, lanes, scene, state = make_synthetic_batch(
      CFG, batch=4, seed=0, n_vehicles=4, n_walkers=2,
      device=resolve_device(device))

  def fn(scene_, state_):
    return sim_step(CFG, maps, lanes, scene_, state_)

  return fn, (scene, state)


def _kernel_counts() -> dict:
  from carla_garage_tpu_torch.ops import bev_fill, raycast
  return {"raycast_boxes": raycast.raycast_boxes.launches,
          "fill_boxes_bev": bev_fill.fill_boxes.launches}


def _reset_kernel_counts():
  from carla_garage_tpu_torch.ops import bev_fill, raycast
  raycast.raycast_boxes.launches = 0
  bev_fill.fill_boxes.launches = 0


def dryrun_rank(mesh: mesh_lib.Mesh, n_devices: int) -> dict:
  """One rank's part of the dry run; its losses, optimizer-state bytes,
  the gathered records and its kernel launches."""
  from carla_garage_tpu_torch.eval.benchmark import (_records,
                                                     _shard_episode_batch,
                                                     _sharded_draw_fn,
                                                     aggregate)
  from carla_garage_tpu_torch.models.plant import PlanT, micro_plant
  from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                        micro_config)
  from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
  from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
  from carla_garage_tpu_torch.sim.datagen import (SAVE_FREQ,
                                                  collect_expert_frames)
  from carla_garage_tpu_torch.sim.episode import rollout_chunked
  from carla_garage_tpu_torch.sim.expert import expert_step
  from carla_garage_tpu_torch.train.plant_train import (BATCH_KEYS,
                                                        build_plant_dataset,
                                                        make_train_step)
  from carla_garage_tpu_torch.train.transfuser_train import \
      make_transfuser_train_step

  _reset_kernel_counts()
  dev = mesh.device
  batch = max(n_devices, 8)
  batch = (batch // n_devices) * n_devices
  _, maps, lanes, scene, state = make_synthetic_batch(
      CFG, batch=batch, seed=0, n_vehicles=4, n_walkers=2, device=dev)
  draw = _sharded_draw_fn(mesh, expert_step, scene, state,
                          torch.Generator(device=dev).manual_seed(0))
  _, _, sc, st = _shard_episode_batch(mesh, maps, lanes, scene, state)
  out = sim_step(CFG, maps, lanes, sc, st, draws=draw())
  assert out.ego.pos.shape[0] == batch // n_devices, out.ego.pos.shape

  # ---- the data-parallel PlanT step on the global sample batch ----
  _, frames = collect_expert_frames(
      CFG, maps, lanes, sc, st, N_FRAMES,
      draws=[draw() for _ in range(N_FRAMES * SAVE_FREQ)])
  frames = mesh_lib.gather_shards(mesh, frames, dim=1)
  pcfg = dataclasses.replace(micro_plant(), max_objects=12,
                             num_route_points=8)
  ds = build_plant_dataset(CFG, pcfg, frames, scene)
  n = (len(ds) // n_devices) * n_devices
  if n < n_devices:
    raise RuntimeError(f"too few samples: {len(ds)}")
  sample = {k: getattr(ds, k)[:n] for k in BATCH_KEYS
            if getattr(ds, k) is not None}
  torch.manual_seed(0)
  model = PlanT(pcfg).to(dev)
  mesh_lib.replicate(mesh, model.state_dict())
  # optax.adamw(3e-4)'s defaults
  adamw = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
  opt = torch.optim.AdamW(model.parameters(), **adamw)
  aux = make_train_step(model, opt, mesh=mesh)(sample)
  plant_loss = float(aux["loss"])
  assert torch.isfinite(aux["loss"]), aux

  # ---- the data-parallel TransFuser++ step with ZeRO-1 AdamW ----
  tcfg = dataclasses.replace(micro_config(), img_h=32, img_w=128,
                             img_anchors=(1, 4), lidar_h=256, lidar_w=256,
                             lidar_anchors=(8, 8))
  torch.manual_seed(0)
  tmodel = LidarCenterNet(tcfg).to(dev)
  mesh_lib.replicate(mesh, tmodel.state_dict())
  topt = mesh_lib.zero1_optimizer(mesh, tmodel.parameters(), **adamw)
  tstep, _, _ = make_transfuser_train_step(
      CFG, tcfg, tmodel, topt, maps, scene, frames,
      camera_ray_grid(CFG, scale=8), lidar_ray_grid(CFG, half=0,
                                                    decimate=16),
      bf16=True, mesh=mesh)
  taux = tstep([0], generator=torch.Generator(device=dev).manual_seed(1))
  tf_loss = float(taux["loss"])
  assert torch.isfinite(taux["loss"]), taux
  # the ZeRO-1 win as a measurement: this rank's optimizer state against
  # all of it (what each rank would hold replicated)
  local = mesh_lib.optimizer_state_bytes(topt)
  total = int(mesh_lib.global_sum(
      mesh, torch.tensor(local, dtype=torch.int64, device=dev)))
  per_rank = [int(x) for x in mesh_lib.gather_objects(mesh, local)]

  # ---- the sharded benchmark on the procedural town ----
  _, maps2, lanes2, scene2, state2 = make_synthetic_batch(
      CFG, batch=batch, seed=3, n_vehicles=4, n_walkers=2, device=dev)
  draw2 = _sharded_draw_fn(mesh, expert_step, scene2, state2,
                           torch.Generator(device=dev).manual_seed(3))
  maps2, lanes2, sc2, st2 = _shard_episode_batch(mesh, maps2, lanes2,
                                                 scene2, state2)
  final2 = rollout_chunked(CFG, maps2, lanes2, sc2, st2,
                           max_ticks=BENCH_TICKS, chunk=BENCH_CHUNK,
                           draw_fn=draw2)
  part = mesh_lib.shard_slice(mesh, batch)
  recs = mesh_lib.gather_records(mesh, _records(
      CFG, sc2, final2, [f"dry_{i}" for i in range(batch)][part],
      "SynthTown", first_index=part.start))
  assert len(recs) == batch, len(recs)
  return dict(env_batch=batch, plant_batch=n, plant_loss=plant_loss,
              transfuser_loss=tf_loss, opt_bytes_per_rank=per_rank,
              opt_bytes_replicated=total, records=recs,
              global_record=aggregate(recs), launches=_kernel_counts())


def dryrun_multichip(n_devices: int, backend: str | None = None,
                     device="cuda", tmpdir: str | None = None,
                     threads: int | None = None) -> list:
  """The dry run on `n_devices` ranks (NCCL on cards by default; gloo for
  several ranks on one card or on the CPU). Prints a summary line and
  returns every rank's result (``dryrun_rank``)."""
  out = launch.spawn(dryrun_rank, n_devices, backend, device, n_devices,
                     tmpdir=tmpdir, threads=threads)
  r0 = out[0]
  shard, repl = r0["opt_bytes_per_rank"], r0["opt_bytes_replicated"]
  print(f"ZeRO-1 opt state: {max(shard) / 1e6:.3f} MB/rank sharded "
        f"({', '.join(f'{b / 1e6:.3f}' for b in shard)}) vs "
        f"{repl / 1e6:.3f} MB/rank replicated "
        f"({repl / max(max(shard), 1):.2f}x reduction on {n_devices} "
        f"ranks)", flush=True)
  print(f"dryrun_multichip ok: {n_devices} ranks, env batch "
        f"{r0['env_batch']}, plant batch {r0['plant_batch']} loss "
        f"{r0['plant_loss']:.3f}, transfuser loss "
        f"{r0['transfuser_loss']:.3f} (ZeRO-1 opt state), meshed "
        f"benchmark {len(r0['records'])} episodes", flush=True)
  return out


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--n-devices", type=int, default=1)
  ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                  help="default: nccl on cards, gloo on the CPU")
  ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
  args = ap.parse_args(argv)
  dryrun_multichip(args.n_devices, args.backend, args.device)
  return 0


if __name__ == "__main__":
  sys.exit(main())
