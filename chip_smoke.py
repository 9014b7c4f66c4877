"""Drive the PyTorch port's sensor-on closed loop on one NVIDIA card.

  python3 chip_smoke.py                     # build, check, drive
  python3 chip_smoke.py --profile out.txt   # and write a device-time
                                            # profile of two ticks there

Phases, each of which fails the run if it fails:
  1. card: print the card's name and power limit; build the port's CUDA
     kernel from its source;
  2. reference: three ticks of the port at a small size (B=2, micro model,
     float32, TF32 off) on the card and on the CPU, from the same weights
     and draws; the CPU run is the port's plain path, which the test suite
     holds against the JAX package;
  3. main path: the committed 16-episode scene (100 NPCs, 2 walkers), the
     full-width TransFuser++ (regnety_032 both branches, 1024x256 camera,
     29,952-ray LiDAR half sweeps) with seeded random weights, bf16
     forward; warm-up ticks, then timed ticks with every kernel's launch
     count set to 0 just before and read just after;
  4. kernels: each kernel against its plain PyTorch version on the card,
     at the shapes the main path gave it (captured during a warm-up tick)
     and on a random case with a ragged ray count, with times;
  5. the output: every state and control leaf finite, ticks advanced.

The last two lines of standard output are the ``kernels`` JSON and
``{"ok": true, "device": ...}``. Without a card it exits non-zero and
prints no result.
"""

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12      # fp32 outside the tensor cores
WARMUP = 3                        # ticks before the timed ones
TICKS = 12                        # timed ticks of the main path


def log(*a):
  print(*a, flush=True)


def card_line() -> str:
  out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
  return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=10, inner=10):
  """Device time of one call: the median over `reps` samples, each of
  `inner` calls enqueued back to back between one pair of CUDA events.
  The stream is kept busy (``torch.cuda._sleep``) while the host records
  the first event and enqueues the calls, so the host's work before each
  launch (checks, allocation) hides behind the device's and is not
  counted."""
  for _ in range(2):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(reps):
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(2_000_000)
    a.record()
    for _ in range(inner):
      fn()
    b.record()
    b.synchronize()
    times.append(a.elapsed_time(b) / inner)
  return statistics.median(times)


def check_kernel(name, inputs, kernel, plain):
  """Kernel vs plain version on the same card inputs. The kernel is built
  with -fmad=false and IEEE division and repeats the plain version's fp32
  operations in order, so they should agree bit for bit; the check allows
  1e-5 of t (an ulp of a 100 m hit) and no class mismatch."""
  saved = kernel.launches
  t, c = kernel(*inputs)
  torch.cuda.synchronize()
  t_ref, c_ref = plain(*inputs)
  err = float((t - t_ref).abs().max()) if t.numel() else 0.0
  mismatch = float((c != c_ref).float().mean()) if c.numel() else 0.0
  ms = time_ms(lambda: kernel(*inputs))
  plain_ms = time_ms(lambda: plain(*inputs), inner=2)
  kernel.launches = saved            # comparison launches do not count
  log(f"  {name}: rays {tuple(inputs[1].shape)} boxes "
      f"{tuple(inputs[2].shape)}  t max|err| {err:.3g}  cls mismatch "
      f"share {mismatch:.3g}  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms")
  assert err <= 1e-5 and mismatch == 0.0, (name, err, mismatch)
  return err, ms, plain_ms


def leaves_close(a, b, what):
  from carla_garage_tpu_torch.structs import tree_items
  worst = 0.0
  for (path, x), (_, y) in zip(tree_items(a), tree_items(b)):
    x = x.cpu()
    if x.dtype.is_floating_point:
      # f32 on both (TF32 off), sin/cos and reductions of two libraries:
      # the tick test's bar of 1e-4 is met on the CPU against JAX
      torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4, msg=path)
      worst = max(worst, float((x - y).abs().max()) if x.numel() else 0.0)
    else:
      assert torch.equal(x, y), (what, path)
  return worst


def slice_batch(tree, n):
  from carla_garage_tpu_torch.structs import tree_map
  return tree_map(lambda x: x[:n].contiguous(), tree)


def small_reference_check(maps, lanes, scene, state):
  """Three ticks at B=2 with the micro model, on the card and on the CPU."""
  from carla_garage_tpu_torch.agents.sensor_agent import (
      make_transfuser_policy, sensor_agent_reset)
  from carla_garage_tpu_torch.config import DEFAULT_CONFIG as cfg
  from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                        micro_config)
  from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
  from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
  from carla_garage_tpu_torch.sim.episode import sim_step

  B = 2
  tcfg = dataclasses.replace(micro_config(), img_h=32, img_w=128,
                             lidar_h=256, lidar_w=256, img_anchors=(1, 4),
                             lidar_anchors=(8, 8))
  cam = camera_ray_grid(cfg, scale=8)
  lf, lr = lidar_ray_grid(cfg, 0, 16), lidar_ray_grid(cfg, 1, 16)
  n_lidar = lf.shape[0] * lf.shape[1]
  torch.manual_seed(1)
  model = LidarCenterNet(tcfg)
  runs = {}
  for dev in ("cpu", "cuda"):
    maps_d, lanes_d = maps.to(dev), lanes.to(dev)
    m = LidarCenterNet(tcfg).to(dev)
    m.load_state_dict(model.state_dict())
    policy = make_transfuser_policy(m, None, tcfg, cam, lf, lr)
    sc = slice_batch(scene, B).to(dev)
    st = slice_batch(state, B).to(dev).replace(
        agent=sensor_agent_reset(cfg, B, n_lidar, device=dev))
    gen = torch.Generator().manual_seed(2)
    for _ in range(3):
      draws = {"gps": torch.randn((B, 2), generator=gen),
               "compass": torch.randn((B,), generator=gen),
               "lidar": torch.rand((B, n_lidar), generator=gen)}
      st = sim_step(cfg, maps_d, lanes_d, sc, st, policy,
                    draws={k: v.to(dev) for k, v in draws.items()})
    runs[dev] = st
  torch.cuda.synchronize()
  worst = leaves_close(runs["cuda"], runs["cpu"], "card vs CPU")
  log(f"  card vs CPU after 3 ticks at B=2: max |diff| of float leaves "
      f"{worst:.3g} (bar 1e-4 abs + 1e-4 rel), ints and bools equal")


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--profile", metavar="PATH",
                  help="write torch.profiler's table of two ticks here")
  args = ap.parse_args()

  if not torch.cuda.is_available():
    log("chip_smoke: torch.cuda.is_available() is False; this script runs "
        "only on an NVIDIA card")
    return 1

  from carla_garage_tpu_torch.agents.sensor_agent import (
      make_transfuser_policy, sensor_agent_reset)
  from carla_garage_tpu_torch.config import DEFAULT_CONFIG
  from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                        TransfuserConfig)
  from carla_garage_tpu_torch.ops import build
  from carla_garage_tpu_torch.ops import raycast as ops_raycast
  from carla_garage_tpu_torch.scene_io import load_scene
  from carla_garage_tpu_torch.sensors import raycast as sensors_raycast
  from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
  from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
  from carla_garage_tpu_torch.sim.episode import rollout, sim_step
  from carla_garage_tpu_torch.structs import tree_items

  # float32 comparisons below run without TF32 (matmuls and cuDNN convs)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = card_line()
  kind = torch.cuda.get_device_name(0)
  log(f"phase 1: card {card}; torch {torch.__version__} cuda "
      f"{torch.version.cuda}")
  t0 = time.perf_counter()
  for name in build.KERNELS:
    text = build.build_kernel(name)
    log(f"  built {name} in {time.perf_counter() - t0:.1f} s")
    for line in text.splitlines():
      if "registers" in line or "spill" in line:
        log(f"  nvcc {name}: {line.strip()}")

  cfg = DEFAULT_CONFIG.replace(sim=dataclasses.replace(
      DEFAULT_CONFIG.sim, max_vehicles=100))
  maps, lanes, scene, state = load_scene(device="cuda")

  log("phase 2: small reference, card vs CPU")
  small_reference_check(maps, lanes, scene, state)

  log("phase 3: main path, full width")
  B = state.tick.shape[0]
  tcfg = TransfuserConfig()
  torch.manual_seed(0)
  model = LidarCenterNet(tcfg).cuda()
  cam = camera_ray_grid(cfg)
  lid_f, lid_r = lidar_ray_grid(cfg, half=0), lidar_ray_grid(cfg, half=1)
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  policy = make_transfuser_policy(model, None, tcfg, cam, lid_f, lid_r,
                                  direct=True, uncertainty_weight=True,
                                  bf16=True)
  state = state.replace(agent=sensor_agent_reset(cfg, B, n_lidar))
  gen = torch.Generator(device="cuda").manual_seed(0)

  # warm-up tick 1 records the kernel's main-path inputs (camera, LiDAR)
  captured = []
  real = sensors_raycast.raycast_boxes

  def record(*xs):
    captured.append(tuple(x.clone() for x in xs))
    return real(*xs)

  sensors_raycast.raycast_boxes = record
  state = sim_step(cfg, maps, lanes, scene, state, policy, generator=gen)
  sensors_raycast.raycast_boxes = real
  state = rollout(cfg, maps, lanes, scene, state, WARMUP - 1, policy,
                  generator=gen)
  torch.cuda.synchronize()
  start = state

  kernels = {"raycast_boxes": ops_raycast.raycast_boxes}
  for k in kernels.values():
    k.launches = 0
  t0 = time.perf_counter()
  state = rollout(cfg, maps, lanes, scene, state, TICKS, policy,
                  generator=gen)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  launches = {n: k.launches for n, k in kernels.items()}
  ms_tick = 1e3 * dt / TICKS
  log(f"  {TICKS} ticks at B={B}: {ms_tick:.2f} ms/tick, "
      f"{B * TICKS / dt:.1f} env-steps/s  ({card})")
  log(f"  launches in the timed ticks: {launches}")
  assert launches["raycast_boxes"] == 2 * TICKS, launches

  # host syncs inside one tick (torch's sync debug mode warns on each)
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
      sim_step(cfg, maps, lanes, scene, state, policy, generator=gen)
    finally:
      torch.cuda.set_sync_debug_mode(0)
  syncs = [f"{w.filename}:{w.lineno}" for w in caught
           if "called a synchronizing" in str(w.message)]
  log(f"  host syncs in one tick: {len(syncs)} {syncs}")
  assert not syncs, "a tick must not wait for the device"

  if args.profile:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      rollout(cfg, maps, lanes, scene, state, 2, policy, generator=gen)
      torch.cuda.synchronize()
    events = prof.key_averages()
    table = events.table(sort_by="self_cuda_time_total", row_limit=40)
    on_card = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3 / 2
    n_launch = sum(e.count for e in on_card) / 2
    log(f"  profiled: device busy {busy_ms:.2f} ms a tick, {n_launch:.0f} "
        f"kernels, memsets and copies a tick (over 2 ticks / 2)")
    out = pathlib.Path(args.profile)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(f"{card}\n{table}\n")
    log("\n".join(table.splitlines()[:25]))

  log("phase 4: kernels against their plain versions on the card")
  assert len(captured) == 2, len(captured)
  err_all, ms_sum, plain_sum, n_bytes, n_flops = 0.0, 0.0, 0.0, 0, 0
  for label, inputs in zip(("camera", "lidar"), captured):
    err, ms, plain_ms = check_kernel(f"raycast_boxes[{label}]", inputs,
                                     ops_raycast.raycast_boxes,
                                     ops_raycast.raycast_boxes_plain)
    by, fl = ops_raycast.raycast_boxes_cost(inputs[1].shape[1], inputs[2])
    err_all, ms_sum, plain_sum = max(err_all, err), ms_sum + ms, \
        plain_sum + plain_ms
    n_bytes, n_flops = n_bytes + by, n_flops + fl
  rng = np.random.default_rng(0)
  o = torch.tensor(rng.uniform(-5, 5, (3, 3)), dtype=torch.float32)
  d = torch.nn.functional.normalize(torch.tensor(
      rng.normal(size=(3, 10007, 3)), dtype=torch.float32), dim=-1)
  bx = captured[0][2][:3].cpu().clone()
  bx[..., :2] = o[:, None, :2] + torch.tensor(
      rng.uniform(-30, 30, (3, bx.shape[1], 2)), dtype=torch.float32)
  err, _, _ = check_kernel("raycast_boxes[random, ragged N]",
                           tuple(x.cuda() for x in (o, d, bx)),
                           ops_raycast.raycast_boxes,
                           ops_raycast.raycast_boxes_plain)
  err_all = max(err_all, err)
  bound_bytes_ms = 1e3 * n_bytes / H100_BYTES_PER_S
  bound_ops_ms = 1e3 * n_flops / H100_FP32_FLOP_PER_S
  bound_ms = max(bound_bytes_ms, bound_ops_ms)
  log(f"  one tick's two launches: {ms_sum:.4f} ms; bound {bound_ms:.4f} ms "
      f"({n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.2f} GFLOP)")

  log("phase 5: output")
  n_leaves = 0
  for path, x in tree_items(state):
    if x.dtype.is_floating_point:
      assert bool(torch.isfinite(x).all()), path
    n_leaves += 1
  ctl = state.agent.prev_control
  assert ctl.shape == (B, 3) and bool(torch.isfinite(ctl).all())
  advanced = (state.tick > start.tick) | start.done
  assert bool(advanced.all()), (start.tick, state.tick)
  log(f"  {n_leaves} state leaves finite; ticks {state.tick.tolist()}; "
      f"done {int(state.done.sum())}/{B}; route completion max "
      f"{float(state.criteria.route_completion.max()):.4f}")

  log(card)
  log(json.dumps({"kernels": [{
      "name": "raycast_boxes", "route": "cuda",
      "source": "carla_garage_tpu_torch/csrc/raycast_boxes.cu",
      "replaces": "carla_garage_tpu/ops/pallas/raycast.py:85",
      "launches": launches["raycast_boxes"], "max_abs_err": err_all,
      "ms": ms_sum, "plain_ms": plain_sum, "bound_ms": bound_ms,
      "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms
      else "bytes",
      "library_ms": None}]}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
