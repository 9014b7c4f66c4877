"""Time the full-spec LidarCenterNet forward alone (port of
scripts/bench_forward.py): no simulator and no sensors, the model on random
inputs at the benchmark's B=16 bfloat16 operating point, so that a
normalization or layout change measures in a minute instead of a whole
bench run.

  python -m carla_garage_tpu_torch.scripts.bench_forward --norm gn
  python -m carla_garage_tpu_torch.scripts.bench_forward --norm bn_affine
  python -m carla_garage_tpu_torch.scripts.bench_forward --norm gn \\
      --profile results/torch/fwd_trace

Prints one JSON line with the JAX script's keys: norm, batch, bf16,
params_M, compile_s (the first call's seconds: the port compiles nothing,
so this is cuDNN's and the allocator's first-call cost), ms_per_step and
frames_per_s. ``--profile DIR`` also runs 5 calls under ``torch.profiler``,
writes the Chrome trace to DIR/trace.json and prints, on earlier lines,
the 15 device kernels that take the most time, their time by class
(convolution, matmul, layout or dtype copy, reduction, elementwise, other)
and the share of the profiled wall time the card was busy.

The weights come from ``torch.manual_seed(0)`` on the CPU and the inputs
from a CPU ``torch.Generator`` seeded with 0 (rgb and LiDAR uniform in
[0, 1), target point and speed zero, command one-hot at index 1), then go
to the device, so the card and the CPU run the same numbers. bf16 casts
the weights and every floating input to bfloat16, as the sensor agent's
bf16 policy does. Every timed call perturbs rgb by ``i * 1e-6`` and ends
in a synchronize. Runs on the card unless ``main(..., device="cpu")``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from carla_garage_tpu_torch.device import resolve_device
from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                      TransfuserConfig,
                                                      micro_config)
from carla_garage_tpu_torch.structs import tree_items
from carla_garage_tpu_torch.utils.profiling import trace

WARMUP = 3                  # calls between the first and the timed ones
PROFILE_CALLS = 5           # calls under the profiler
TOP_OPS = 15                # device kernels listed by the profile

# device kernels by name, first match wins; the classes say where a
# forward's time goes (cuDNN's convolutions are implicit GEMMs, so they
# are matched before the matmuls; its tensorTransform kernels turn NCHW
# into the NHWC its bf16 convolutions read, and back)
OP_CLASSES = (
    ("convolution", ("conv", "fprop", "implicit", "winograd", "dgrad")),
    ("matmul", ("gemm", "nvjet", "cutlass", "matmul")),
    ("layout or dtype copy", ("tensortransform", "nchwtonhwc", "nhwctonchw",
                              "copy", "transpose", "permute", "catarray")),
    ("reduction", ("reduce", "norm", "moments")),
    ("elementwise", ("elementwise",)),
)


def parse_args(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--batch", type=int, default=16)
  ap.add_argument("--norm", default="gn", choices=["gn", "bn_affine"])
  ap.add_argument("--micro", action="store_true")
  ap.add_argument("--iters", type=int, default=30)
  ap.add_argument("--no-bf16", action="store_true")
  ap.add_argument("--profile", default=None, metavar="DIR",
                  help="write a torch.profiler trace of 5 calls here")
  return ap.parse_args(argv)


def model_config(args) -> TransfuserConfig:
  return micro_config() if args.micro else TransfuserConfig()


def count_params(tcfg: TransfuserConfig, norm: str) -> int:
  """The model's parameter count, built on the meta device (nothing
  allocated)."""
  with torch.device("meta"):
    model = LidarCenterNet(tcfg, norm=norm)
  return sum(p.numel() for p in model.parameters())


def make_inputs(tcfg: TransfuserConfig, batch: int, device):
  """(rgb, lidar, target point, command, speed) from a CPU generator
  seeded with 0, on `device`."""
  g = torch.Generator().manual_seed(0)
  rgb = torch.rand((batch, tcfg.img_h, tcfg.img_w, 3), generator=g)
  lid = torch.rand((batch, tcfg.lidar_h, tcfg.lidar_w, tcfg.lidar_channels),
                   generator=g)
  cmd = torch.zeros((batch, 6))
  cmd[:, 1] = 1.0
  return tuple(x.to(device) for x in (rgb, lid, torch.zeros((batch, 2)),
                                      cmd, torch.zeros((batch,))))


def forward_flops(tcfg: TransfuserConfig, norm: str, batch: int) -> int:
  """Floating-point operations of one forward (2 a multiply-add of the
  convolutions and matmuls), counted by ``FlopCounterMode`` on the meta
  device."""
  from torch.utils.flop_counter import FlopCounterMode
  with torch.device("meta"):
    model = LidarCenterNet(tcfg, norm=norm).requires_grad_(False)
    inputs = make_inputs(tcfg, batch, "meta")
  counter = FlopCounterMode(display=False)
  with counter:
    model(*inputs)
  return counter.get_total_flops()


def build(args, device):
  """(inputs, fwd): fwd(rgb) runs the forward on rgb and the fixed other
  inputs and returns the float32 sum over all outputs."""
  tcfg = model_config(args)
  with torch.random.fork_rng(devices=[]):
    torch.manual_seed(0)
    model = LidarCenterNet(tcfg, norm=args.norm)
  dtype = torch.float32 if args.no_bf16 else torch.bfloat16
  model = model.to(device=device, dtype=dtype).eval()
  inputs = make_inputs(tcfg, args.batch, device)

  @torch.inference_mode()
  def fwd(rgb):
    out = model(*(x.to(dtype) for x in (rgb,) + inputs[1:]))
    # one scalar out: every output is computed and nothing large is copied
    return sum(torch.sum(v.to(torch.float32)) for _, v in tree_items(out))

  return inputs, fwd


def op_class(name: str) -> str:
  low = name.lower()
  for cls, keys in OP_CLASSES:
    if any(k in low for k in keys):
      return cls
  return "other"


def profile_summary(prof, wall_ms: float, device) -> dict:
  """The top device kernels, device time by class and the busy share of a
  profiled window; on the CPU (no device) the top host ops instead, and
  no busy share."""
  events = prof.key_averages()
  on_card = device.type == "cuda"
  if on_card:
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
  else:
    rows = [(e.key, e.count, e.self_cpu_time_total / 1e3) for e in events]
  rows.sort(key=lambda r: -r[2])
  total = sum(r[2] for r in rows)
  by_class = {}
  for name, _, ms in rows:
    by_class[op_class(name)] = by_class.get(op_class(name), 0.0) + ms
  return dict(top=rows[:TOP_OPS], total_ms=total, wall_ms=wall_ms,
              by_class=by_class, launches=sum(r[1] for r in rows),
              busy=total / wall_ms if on_card and wall_ms > 0 else None)


def print_profile(s: dict, device, calls: int) -> None:
  what = "device kernels" if device.type == "cuda" else \
      "host ops (a CPU run: no device time)"
  print(f"profile of {calls} calls: top {TOP_OPS} {what} by time "
        f"(ms, count, share of {s['total_ms']:.3f} ms)")
  for name, count, ms in s["top"]:
    print(f"  {ms:10.3f} {count:6d} {100 * ms / s['total_ms']:6.2f}%  "
          f"[{op_class(name)}] {name[:140]}")
  print("  by class: " + ", ".join(
      f"{k} {v:.3f} ms ({100 * v / s['total_ms']:.1f}%)"
      for k, v in sorted(s["by_class"].items(), key=lambda kv: -kv[1])))
  busy = "not measured (no device)" if s["busy"] is None else \
      f"{100 * s['busy']:.1f}%"
  print(f"  {s['launches'] / calls:.0f} a call; device busy {busy} of "
        f"{s['wall_ms']:.3f} ms wall")


def run(args, device="cuda"):
  """(the JSON record, {"out": the first call's float32 scalar,
  "profile": the profile summary or None})."""
  dev = resolve_device(device)
  sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
  tcfg = model_config(args)
  n_params = count_params(tcfg, args.norm)
  inputs, fwd = build(args, dev)
  rgb = inputs[0]

  t0 = time.perf_counter()
  out = float(fwd(rgb))
  compile_s = time.perf_counter() - t0
  for _ in range(WARMUP):
    fwd(rgb)
    sync()
  summary = None
  if args.profile:
    with trace(args.profile) as prof:
      t0 = time.perf_counter()
      for i in range(PROFILE_CALLS):
        fwd(rgb + i * 1e-6)
        sync()
      wall_ms = (time.perf_counter() - t0) * 1e3
    summary = profile_summary(prof, wall_ms, dev)
    print_profile(summary, dev, PROFILE_CALLS)
  t0 = time.perf_counter()
  for i in range(args.iters):
    fwd(rgb + i * 1e-6)
    sync()
  dt = (time.perf_counter() - t0) / args.iters
  record = {
      "norm": args.norm, "batch": args.batch, "bf16": not args.no_bf16,
      "params_M": round(n_params / 1e6, 1),
      "compile_s": round(compile_s, 1),
      "ms_per_step": round(dt * 1e3, 2),
      "frames_per_s": round(args.batch / dt, 1),
  }
  return record, {"out": out, "profile": summary}


def main(argv=None, device="cuda") -> int:
  record, _ = run(parse_args(argv), device)
  print(json.dumps(record))
  return 0


if __name__ == "__main__":
  sys.exit(main())
