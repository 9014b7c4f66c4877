"""bench.py's operating points on the port: batched closed-loop env steps/s.

  python -m carla_garage_tpu_torch.bench            # one JSON line
  python -m carla_garage_tpu_torch.bench --profile  # the stage profile

The same three operating points as the JAX package's ``bench.py``:

  object level: the expert policy, B=256, 8 NPCs and 2 walkers, 200 ticks
      x 5 rounds after one warm-up round (``value``, bench.py's headline);
  sensor_on_reduced: regnety_micro, a 256x64 camera, LiDAR decimated 4x,
      B=128 (``BENCH_REDUCED_B``), 100 NPCs, 50 ticks x 3;
  sensor_on_full: ``TransfuserConfig()`` (regnety_032, 1024x256 camera,
      full 600k pts/s LiDAR), B=16 (``BENCH_FULL_B``), 100 NPCs, 20 ticks
      x 3.

Both sensor points run the bf16 forward with the direct controller. Each
timed round ends in ``torch.cuda.synchronize()``. The weights are seeded
random (``torch.manual_seed(0)``), not bench.py's ``jax.random.key(0)``:
rates do not depend on weight values, but a policy's trajectory does, so
the two packages' sensor-on episodes drive differently.

It prints one JSON line with bench.py's keys plus ``device`` (the card's
name and power limit). A sensor point that fails is reported as -1 with
its ``*_error``, as bench.py does, and then the process exits non-zero.
``--profile`` times each stage of the sensor step (camera, both LiDAR
halves, voxelization, the bf16 forward, the object-level tick, the full
policy tick) at both sensor points, writes the table to
``results/torch/profile_sensor_on.json`` and one Chrome trace of a full
policy tick to ``results/torch/trace_sensor_on_{reduced,full}/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import types

import torch

from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.device import resolve_device

BATCH = 256
TICKS = 200
TARGET_STEPS_PER_SEC = 10_000.0
# the stage profile measures the batch the benchmark publishes
REDUCED_B = int(os.environ.get("BENCH_REDUCED_B", 128))
FULL_B = int(os.environ.get("BENCH_FULL_B", 16))
OUT_DIR = os.path.join("results", "torch")


def _sync(dev: torch.device):
  if dev.type == "cuda":
    torch.cuda.synchronize()


def reduced_config():
  """The reduced sensor point's model, also the one that
  scripts/train_transfuser.py trains under --micro: regnety_micro on a
  256x64 camera and the 256x256 BEV."""
  from carla_garage_tpu_torch.models.transfuser import TransfuserConfig
  return TransfuserConfig(
      image_arch="regnety_micro", lidar_arch="regnety_micro",
      img_h=256 // 4, img_w=1024 // 4, lidar_h=256, lidar_w=256,
      img_anchors=(2, 8), lidar_anchors=(8, 8),
      n_embd=128, d_model=128, n_decoder_layers=3)


def _timed_rounds(run, state, rounds: int, dev: torch.device):
  """One warm-up round, then `rounds` timed rounds from where it ended.
  Returns (seconds of the timed rounds, final state)."""
  state = run(state)
  _sync(dev)
  t0 = time.perf_counter()
  for _ in range(rounds):
    state = run(state)
  _sync(dev)
  return time.perf_counter() - t0, state


def measure_object_level(batch: int = BATCH, ticks: int = TICKS,
                         rounds: int = 5, device="cuda"):
  """The expert policy at `batch` episodes (8 NPCs, 2 walkers) for
  `rounds` rounds of `ticks` ticks after a warm-up round. Returns
  (env-steps/s, final state)."""
  from carla_garage_tpu_torch.sim.episode import rollout
  from carla_garage_tpu_torch.sim.scene_builder import make_synthetic_batch
  dev = resolve_device(device)
  _, maps, lanes, scene, state = make_synthetic_batch(
      CFG, batch=batch, seed=0, n_vehicles=8, n_walkers=2, device=dev)
  gen = torch.Generator(device=dev).manual_seed(0)
  dt, state = _timed_rounds(
      lambda st: rollout(CFG, maps, lanes, scene, st, ticks, generator=gen),
      state, rounds, dev)
  return batch * ticks * rounds / dt, state


def _sensor_setup(full_spec: bool, batch: int | None, dev: torch.device):
  """A sensor point's set-up: cfg, tcfg, the seeded model, its policy, the
  ray grids (cam, lid_f, lid_r), and a scene of 100 NPCs an episode with
  the agent reset (maps, lanes, scene, state)."""
  from carla_garage_tpu_torch.agents.sensor_agent import (
      make_sensor_policy, sensor_grids)
  from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                        TransfuserConfig)
  from carla_garage_tpu_torch.sim.scene_builder import make_synthetic_batch
  if full_spec:
    cam_scale, lid_dec, B = 1, 1, batch or FULL_B
    tcfg = TransfuserConfig()
  else:
    cam_scale, lid_dec, B = 4, 4, batch or REDUCED_B
    tcfg = reduced_config()
  # honest traffic density: 100 town-wide NPCs an episode
  cfg = CFG.replace(sim=dataclasses.replace(CFG.sim, max_vehicles=100))
  cam, lid_f, lid_r = sensor_grids(cfg, tcfg, cam_scale, lid_dec)
  with torch.random.fork_rng(devices=[]):
    torch.manual_seed(0)
    model = LidarCenterNet(tcfg)
  model = model.to(dev)
  _, maps, lanes, scene, state = make_synthetic_batch(
      cfg, batch=B, seed=0, n_vehicles=100, n_walkers=2, device=dev)
  policy, reset = make_sensor_policy(model, None, tcfg, (cam, lid_f, lid_r),
                                     direct=True, bf16=True)
  state = state.replace(agent=reset(cfg, B, device=dev))
  return types.SimpleNamespace(cfg=cfg, tcfg=tcfg, model=model,
                               policy=policy, cam=cam, lid_f=lid_f,
                               lid_r=lid_r, maps=maps, lanes=lanes,
                               scene=scene, state=state)


def measure_sensor_on(full_spec: bool, ticks: int | None = None,
                      rounds: int = 3, batch: int | None = None,
                      device="cuda"):
  """The full sensor path a tick: camera + LiDAR half sweep + voxelize +
  the bf16 TransFuser++ forward + control. full_spec=False: the reduced
  point (B=REDUCED_B, 50 ticks a round); True: the reference sensor spec
  (B=FULL_B, 20 ticks a round). Returns (env-steps/s, final state)."""
  from carla_garage_tpu_torch.sim.episode import rollout
  dev = resolve_device(device)
  ticks = ticks or (20 if full_spec else 50)
  s = _sensor_setup(full_spec, batch, dev)
  B = s.state.tick.shape[0]
  gen = torch.Generator(device=dev).manual_seed(1)
  dt, state = _timed_rounds(
      lambda st: rollout(s.cfg, s.maps, s.lanes, s.scene, st, ticks,
                         s.policy, generator=gen), s.state, rounds, dev)
  return B * ticks * rounds / dt, state


def profile_sensor_stages(full_spec: bool, reps: int = 10,
                          batch: int | None = None, device="cuda",
                          trace_dir: str | None = None) -> dict:
  """ms of each stage of the sensor step, timed alone at a sensor point's
  batch and config: camera, LiDAR (both halves), voxelize (both halves'
  points), the bf16 forward, the object-level tick and the full policy
  tick; ``other_ms`` is the full tick less the five stages. Each stage
  runs once, then `reps` times between two synchronizations. With
  trace_dir, one more full policy tick is traced there (outside the
  timing, which the profiler would inflate)."""
  from carla_garage_tpu_torch.sensors.camera import render_camera
  from carla_garage_tpu_torch.sensors.lidar import render_lidar
  from carla_garage_tpu_torch.sensors.voxelize import voxelize
  from carla_garage_tpu_torch.sim.episode import rollout
  from carla_garage_tpu_torch.utils.profiling import trace
  dev = resolve_device(device)
  s = _sensor_setup(full_spec, batch, dev)
  cfg, tcfg, maps, lanes, scene, state = (s.cfg, s.tcfg, s.maps, s.lanes,
                                          s.scene, s.state)
  B = state.tick.shape[0]
  gen = torch.Generator(device=dev).manual_seed(1)
  pts, val = render_lidar(cfg, maps, scene, state, s.lid_f, generator=gen)
  pts2, val2 = torch.cat([pts, pts], 1), torch.cat([val, val], 1)
  m16 = s.model.to(torch.bfloat16).eval()
  z = lambda *s: torch.zeros(s, dtype=torch.bfloat16, device=dev)
  fwd_in = (z(B, tcfg.img_h, tcfg.img_w, 3),
            z(B, tcfg.lidar_h, tcfg.lidar_w, tcfg.lidar_channels),
            z(B, 2), z(B, 6), z(B))

  @torch.no_grad()
  def forward():
    return m16(*fwd_in)

  stages = {
      "camera": lambda: render_camera(cfg, maps, scene, state,
                                      s.cam)["rgb"],
      "lidar_2halves": lambda: (
          render_lidar(cfg, maps, scene, state, s.lid_f, generator=gen)[0] +
          render_lidar(cfg, maps, scene, state, s.lid_r, generator=gen)[0]),
      "voxelize": lambda: voxelize(pts2, val2, cfg),
      "model_fwd_bf16": forward,
      "object_sim_step": lambda: rollout(cfg, maps, lanes, scene, state, 1,
                                         generator=gen),
      "full_policy_step": lambda: rollout(cfg, maps, lanes, scene, state, 1,
                                          s.policy, generator=gen),
  }
  out = {}
  for name, fn in stages.items():
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
      fn()
    _sync(dev)
    out[name] = round((time.perf_counter() - t0) / reps * 1000.0, 3)
  if trace_dir is not None:
    with trace(trace_dir):
      stages["full_policy_step"]()
  out["B"] = B
  out["config"] = "full" if full_spec else "reduced"
  accounted = out["camera"] + out["lidar_2halves"] + out["voxelize"] + \
      out["model_fwd_bf16"] + out["object_sim_step"]
  out["other_ms"] = round(out["full_policy_step"] - accounted, 3)
  return out


def device_line(device="cuda") -> str:
  """The card's name and power limit as nvidia-smi gives them, or the
  device's type when it is not a card."""
  if resolve_device(device).type != "cuda":
    return str(resolve_device(device))
  out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
  return out.stdout.strip().splitlines()[0]


def main(argv=None, device="cuda") -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--profile", action="store_true",
                  help="profile the sensor step's stages instead")
  args = ap.parse_args(argv)
  if args.profile:
    prof = {k: profile_sensor_stages(
        full, device=device,
        trace_dir=os.path.join(OUT_DIR, f"trace_sensor_on_{k}"))
        for k, full in (("reduced", False), ("full", True))}
    prof["device"] = device_line(device)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_sensor_on.json"), "w") as f:
      json.dump(prof, f, indent=1)
    print(json.dumps(prof, indent=1))
    return 0
  payload = {"metric": "batched_env_steps_per_sec_per_chip"}
  obj_rate = measure_object_level(device=device)[0]
  failed = False
  for key, full in (("sensor_on_reduced", False), ("sensor_on_full", True)):
    try:
      payload[f"{key}_steps_per_sec"] = round(
          measure_sensor_on(full, device=device)[0], 1)
    except Exception:  # noqa: BLE001 - reported in the payload, then exit 1
      traceback.print_exc(file=sys.stderr)
      payload[f"{key}_steps_per_sec"] = -1.0
      payload[f"{key}_error"] = traceback.format_exc().strip()[-300:]
      failed = True
  payload.update({
      "value": round(obj_rate, 1),
      "unit": "env_steps/s/chip (object-level sim, expert policy; "
              "sensor_on_reduced = regnety_micro @256x64 cam + LiDAR/4, "
              f"B={REDUCED_B}; sensor_on_full = regnety_032 @1024x256 cam "
              f"+ full 600k pts/s LiDAR, bf16, B={FULL_B} — the reference "
              "sensor spec)",
      "vs_baseline": round(obj_rate / TARGET_STEPS_PER_SEC, 4),
      "sensor_on_steps_per_sec": payload.get("sensor_on_reduced_steps_per_sec"),
      "sensor_on_vs_baseline": round(
          payload.get("sensor_on_reduced_steps_per_sec", -1.0)
          / TARGET_STEPS_PER_SEC, 4),
      "device": device_line(device),
  })
  print(json.dumps(payload))
  return 1 if failed else 0


if __name__ == "__main__":
  sys.exit(main())
