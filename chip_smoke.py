"""Drive the PyTorch port's main paths on one NVIDIA card.

  python3 chip_smoke.py                     # build, check, drive
  python3 chip_smoke.py --profile out.txt   # and write device-time
                                            # profiles of two ticks, one
                                            # training step and two eval
                                            # ticks there

Phases, each of which fails the run if it fails:
  1. card: print the card's name and power limit; build every CUDA kernel
     of the port from its source, one nvcc per source, all started
     together, and print ptxas's register and spill lines;
  2. tick reference: three ticks of the sensor-on loop at a small size
     (B=2, micro model, float32, TF32 off) on the card and on the CPU,
     from the same weights and draws; the CPU run is the port's plain
     path, which the test suite holds against the JAX package;
  3. training reference: expert datagen (B=2, 3 recorded frames = 15
     ticks) on the card and on the CPU from the same steer-noise draws,
     every state and frame leaf; then one train step (B=2, micro model at
     reduced sensor sizes, two micro-batches, float32, TF32 off) on the
     card and on the CPU from the same weights, frames and draws: the
     loss, every aux loss and every gradient;
  4. the sensor-on tick (slice 1's main path): the committed 16-episode
     scene (100 NPCs, 2 walkers), the full-width TransFuser++ (regnety_032
     both branches, 1024x256 camera, 29,952-ray LiDAR half sweeps) with
     seeded random weights, bf16 forward; warm-up ticks, then timed ticks
     with every kernel's launch count set to 0 just before and read just
     after; no host sync in a tick;
  5. expert datagen (slice 2's main path, first half): the expert drives
     the committed scene for 24 recorded frames (120 ticks); no host sync
     in a tick, every frame leaf finite, usable frames;
  6. training at full width (slice 2's main path, second half):
     TransfuserConfig() with the full 59,904-ray sweep, bf16, 4
     micro-batches of 16 episodes a step (an effective batch of 64),
     AdamW with clip 1.0 and the multistep schedule, on those frames; a
     warm-up step, then timed steps with the launch counts set to 0 just
     before and read just after, split by CUDA events into render +
     labels, forward + backward and optimizer, with the peak device
     memory; no host sync in a step;
  7. kernels: each kernel against its plain PyTorch version on the card,
     at the shapes the main paths gave it (captured during warm-ups) and
     on random ragged cases, with times and bounds;
  8. scenario tick reference: a scene of the port's own builder (B=2,
     ``make_town_batch("synth", use_scenarios=True)``) with one hand-made
     CONTROL_LOSS row just ahead of the ego, 60 expert ticks on the card
     and on the CPU from the same steer-noise and control-loss draws,
     every state leaf; the rows triggered, by type;
  9. closed-loop evaluation (slice 4's main path, the path of the
     training script's ``closed_loop_eval``): the port builds a 16-route
     scenario scene (100 NPCs, 2 walkers), the full-width bf16 TransFuser++
     with seeded random weights drives it through ``rollout_chunked``
     (64 ticks in one chunk; phase 23 drives 512), then
     ``compute_scores`` -> records ->
     ``aggregate``, written with ``write_endpoint`` and ``write_csv`` and
     read back; ms/tick (timed with torch's sync debug mode off), launch
     counts, the scenario rows triggered by type; then the host syncs
     (none in a tick, one a chunk) on a short chunked run under the sync
     debug mode, timed with the mode off and on;
  10. DAgger datagen (slice 4's main path, second half): that policy on
     that scene through ``collect_dagger_frames``, 10 frames (50 ticks);
     no host sync in a tick, every frame leaf finite;
  11. PlanT reference: 20 ticks of the micro PlanT policy (direct, creep)
     on phase 8's scene at B=2, on the card and on the CPU from the same
     weights and control-loss draws, every state leaf; then one micro
     PlanT train step (batch 32, float32, TF32 off) on both devices: the
     loss, every aux loss and every gradient;
  12. PlanT datagen and dataset (slice 5, ``scripts/train_plant.py``'s
     recipe): the expert drives phase 9's scene for 60 frames in chunks
     of 20, the quality gate keeps clean episodes, then
     ``build_plant_dataset`` at ``PlanTConfig()``; it fails if the train
     split holds fewer than one batch of 512;
  13. PlanT training at full width: ``PlanTConfig()`` (bert-medium, 30
     objects, 20 route points), float32, batch 512, AdamW 3e-4 with the
     multistep schedule, estimated speed-class weights, velocity dropout
     0.15, set up by ``plant_trainer`` as ``train_plant`` sets itself up;
     a warm-up step, then timed steps with the launch counts set to 0 just
     before and read just after; device kernels a step, peak memory,
     validation losses; no host sync in an epoch's steps in a row, its
     first included; then ``train_plant`` itself for 11 steps, timed with
     its set-up and validation;
  14. PlanT closed-loop eval and DAgger: the trained model at the eval
     suite's point (direct, brake threshold 0.33, creep) drives phase 9's
     scene through ``rollout_chunked`` (64 ticks in one chunk), then
     scores -> records; no host sync in a tick, no kernel launch; then
     ``relabel_with_plant`` over the dataset, and 10 DAgger frames with
     PlanT driving, built into a dataset with waypoint weight 0;
  15. the sensor agent's operating points on the committed scene, each
     with the full-width bf16 TransFuser++: ``stop_control``,
     ``jpeg_quality=95``, ``seq_len=2``, ``map_track`` and
     ``direct=False`` with ``use_wp_gru``; warm-up ticks, then timed ticks
     with 2 launches of the raycast kernel a tick; for ``stop_control`` the
     timed ticks add a class-3 peak 1 m ahead of the ego to the model's
     heatmap logits, and the controller must track it and brake; then
     ``jpeg_artifacts`` and ``topk_decode`` on the card against the CPU
     on one tick's inputs;
  16. bench.py's operating points through the port's bench functions:
     the expert at B=256 (20 ticks a round) and the reduced sensor point
     at B=128 (10 ticks a round), one warm-up round and one timed round
     each, with env-steps/s and ms/tick, every state leaf finite, 0 and 2
     raycast launches a tick; the raycast kernel against its plain
     version at the shapes the sensor point gave it (B=128); then the
     stage profile of the reduced and the full point (2 repetitions);
  17. checkpoints: TransfuserConfig() and the PlanT recipe's config saved
     and loaded into fresh models on the card (state dicts bit-equal, one
     forward equal), and ``config_from_meta`` over every committed
     ``checkpoints/*/meta.json``;
  18. ``train_plant`` end to end on synthetic towns at a cut depth: the
     results JSON's keys, the best segment's weights saved and loaded bit
     for bit, no kernel launch;
  19. ``dagger_ab`` end to end: both arms, a verdict, waypoint weight 0
     on every DAgger sample;
  20. imported towns: an asset root in the reference's layout in a
     temporary directory: "Town01", a 7 x 7 grid of yellow-marked two-way
     streets 115 m apart (3,000 x 3,000 px at 4 px/m), and "Town02", the
     default 1,680 x 1,680 px grid, as h5 layers; a Longest6 route XML of
     8 + 4 routes sampled by ``routing.sample_lane_route`` on each town's
     lanes recovered without hints; scenario annotations (Scenario1/3/4
     along the lanes, Scenario7-10 at the junctions' light positions).
     Each town is then built as the benchmark loads it: ``load_town``
     where h5py imports, else ``town_from_layers`` and the port's cache
     writer into a temporary ``CGT_TOWN_CACHE``; the host seconds of each
     recovery, the lanes, lights and stop signs;
  21. imported-town reference: Town01 at B=2 with scenarios, 60 expert
     ticks on the card and on the CPU from the same steer-noise and
     control-loss draws, every state leaf;
  22. ``run_benchmarks --honest --single-batch --towns Town01 Town02
     --max-ticks 512``: the expert drives the 12 routes (100 NPCs,
     scenarios on) as one mixed-town batch through ``rollout_chunked``;
     the endpoint JSON and CSV read back, every state leaf finite, no
     kernel launch, one host sync a chunk and none a tick; ms/tick,
     env-steps/s, DS;
  23. ``run_benchmarks --agent transfuser --checkpoint <TransfuserConfig()
     with seeded random weights, saved by the port> --honest --reps 2
     --towns Town01 --max-ticks 512``: 16 episodes at full width, bf16;
     2 raycast launches a tick, every launch held against the plain
     version on the card as the run goes (its ms/tick includes that
     work, whose host seconds it prints) and the first of each shape
     timed against it; ms/tick, DS;
  24. ``train_transfuser`` end to end at TransfuserConfig() (bf16) on
     ``--towns Town01 synth --eval-towns Town02`` of that asset root: the
     kernels' launches of every step, no host sync in a step, the step,
     DAgger and best checkpoints and the results JSON; both kernels held
     against their plain versions at every launch and timed against them
     at every shape the run gave them (training, eval and DAgger
     batches); then the same arguments again, which must take every
     shard from the cache, resume the train state after the last
     BC step and run no BC step before its DAgger round, where it is
     stopped (phase 20 before the imported towns came);
  25. the disk path's codecs on the card's machine: whether PIL imports
     there (information only; the port never imports it) and which .lzc
     library loaded; the JPEG codec built from its source, then one
     episode's full-width rendered camera frame through JPEG at quality
     90 (PSNR at least 35 dB), its semantic PNG and its 24-bit depth PNG
     (both exact), with host encode and decode times;
  26. ``export_reference_layout`` at full width: phase 5's first 16 frames
     of the 16 episodes (1024x256 camera, 59,904-ray sweep) written in the
     reference's layout, every raycast and box-fill launch held to its
     plain version (3 and 1 a frame), files, bytes and the host seconds
     split into render and encode + write; each kernel timed against its
     plain version at the export's shapes; the frames through
     ``save_frames`` / ``load_frames``, bit-equal; then the export at B=2
     on a small grid on the card and on the CPU from the same draws: the
     same files, JSON within 1e-5, semantic and BEV PNGs equal, depths
     within 1e-4, .lzc points within 1e-5 m plus a 2 mm quantum, JPEGs
     within the CPU test's bound;
  27. ``train_transfuser_from_disk`` at full width on phase 26's
     directory: ``load_disk_samples`` (host seconds, samples a second),
     then TransfuserConfig() in bf16 at batch 8, a warm-up step and 4
     timed ones, ms/step split into the host batch build and the device
     step, samples/s, peak memory, no kernel launch, finite losses;
  28. the remaining models at full width with seeded weights:
     ``AIMBackbone()`` (regnety_032), ``BevEncoder(projection=
     make_projection_grid())`` (a 64x64x8 grid), ``VideoResNet()`` and
     ``SwinTransformer3D()`` on a 4-frame 256x256 LiDAR sequence and
     ``GRUWaypointsPredictorTransFuser(pred_len=8)``: each on the card
     against the CPU at B=2 in float32 (every output within 1e-4 abs +
     1e-4 rel), then a timed bf16 forward at B=16, finite, no
     kernel launch;
  29. a reference-layout TransFuser++ ensemble: ``config.pickle`` (a dict)
     and ``model_0030.pth`` / ``model_0031.pth``, full-width regnety_032
     state dicts in the timm / reference key layout drawn from a numpy
     seed, BatchNorm statistics far from the identity; loaded by
     ``load_ensemble_directory``, member 0 on the card against the CPU at
     B=2 (float32), then the two members served in bf16 through
     ``make_transfuser_policy`` on the committed scene for 32 ticks, with
     2 raycast launches a tick, every one held to its plain version;
  30. PlanT from a reference-layout ``PlanTConfig()`` state dict through
     ``convert_plant``: card against CPU at B=2, then 8 PlanT ticks on the
     committed scene, no kernel launch;
  31. multi-GPU (data parallelism over ``torch.distributed`` ranks): a.
     ``dryrun_multichip(1)`` over NCCL on the card (a sharded expert
     ``sim_step``, a data-parallel PlanT step, a data-parallel
     TransFuser++ step with ZeRO-1 AdamW, the sharded benchmark); then two
     ranks sharing the one card over gloo (NCCL takes one rank a card):
     b. the micro TransFuser++ step (B=4, float32, TF32 off, episode 3
     done at the step's frames, so the shards hold different valid
     counts) against one process's step on the card: every loss and
     every all-reduced gradient; c. full-width data-parallel training,
     ``TransfuserConfig()`` in bf16 on phase 5's frames, 4 micro-batches
     of 16 episodes split 8 + 8, AdamW (ZeRO-1) with clip 1.0 and the
     multistep schedule: a warm-up step with every kernel launch held to
     its plain version, then timed steps with the launch counts set to 0
     just before and read just after (2 raycast and 1 box-fill launches
     a micro-batch a rank), ms/step and the all-reduce's ms by CUDA
     events, each rank's peak memory and optimizer-state bytes; d. the
     committed scene's 16 episodes split 8 + 8 under the full-width bf16
     TransFuser++ (seeded weights broadcast from rank 0) through
     ``rollout_chunked``, 2 raycast launches a tick a rank, every one
     held to its plain version; then the expert on the same split, whose
     gathered records must equal one process's run of the same ticks.
     The ranks return their launch counts to this process. Measured on
     one card, these are not a multi-card speed;
  32. the remaining entry points: a. ``bench_forward.main`` at full spec
     (TransfuserConfig(), B=16, bf16, 30 timed calls) with ``--norm gn``
     and ``--norm bn_affine``, each JSON line printed, params_M 120.3, no
     kernel launch, ms/step against the forward's operation count at the
     bf16 peak; b. one ``--profile`` run with gn: its 15 slowest device
     kernels, device time by class and the card's busy share; c. the
     micro forward (``--micro --no-bf16 --batch 2``) on the card against
     the CPU from the same seed and weights, within 1e-4 relative (TF32
     off); d. ``merge_seed_runs`` on the committed
     ``results/{longest6,lav}_plant_r5_honest_seed{0,1,2}.json``, whose
     ``_checkpoint`` and ``values`` must equal the committed merged files
     within 1e-12;
  33. the output: every tick-state leaf finite, ticks advanced.

Every phase prints its wall time. The last two lines of standard output
are the ``kernels`` JSON and ``{"ok": true, "device": ...}``. A kernel's
``launches`` there is the sum over the main paths' timed runs,
``launches_by_path`` each path's count. Without a card it exits non-zero
and prints no result.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12      # fp32 outside the tensor cores
WARMUP = 3                        # ticks before the timed ones
TICKS = 12                        # timed ticks of the sensor-on tick
DATAGEN_FRAMES = 24               # recorded frames, 5 ticks each
MICRO_BATCHES = 4                 # frames_per_step: 4 x 16 = 64 samples
TRAIN_STEPS = 3                   # timed full-width training steps
SCENARIO_TICKS = 60               # expert ticks of the scenario reference
EVAL_TICKS = 64                   # closed-loop eval: the script runs 6,000
EVAL_CHUNK = 64                   # ticks in chunks of 512; phase 23 runs
                                  # 512 at full width
SYNC_CHECK_CHUNKS = 2             # the eval's host-sync check: 2 chunks
SYNC_CHECK_CHUNK = 8              # of 8 ticks
DAGGER_FRAMES = 10                # the DAgger collector's frames
PLANT_REF_TICKS = 20              # PlanT reference ticks at B=2
PLANT_FRAMES = 60                 # PlanT datagen: recorded frames,
PLANT_CHUNK = 20                  # collected 20 at a time as the script
PLANT_BATCH = 512                 # the r5 recipe's --batch
PLANT_STEPS = 10                  # timed full-width PlanT steps
OP_WARMUP, OP_TICKS = 3, 4        # operating points: warm-up, timed ticks
STOP_AHEAD_M = 1.0                # stop_control: the class-3 peak ahead
BENCH_OBJ_TICKS = 20              # bench points: ticks a round (bench.py:
BENCH_SENSOR_TICKS = 10           # 200 and 50), timed rounds (5 and 3)
BENCH_ROUNDS = 1                  # after one warm-up round
BENCH_PROFILE_REPS = 2            # stage profile repetitions (bench.py: 10)
ENTRY_EVAL_CHUNK = 32             # the entry points' evals: ticks a chunk
ENTRY_EVAL_TICKS = 32             # and in all (the scripts: 512, 6,000)
SMALL_EVAL = ["--eval-seeds", "1", "--eval-routes", "2", "--eval-max-ticks",
              str(ENTRY_EVAL_TICKS)]
PLANT_ENTRY_ARGV = ["--towns", "synth", "synth2", "--eval-towns", "synth3",
                    "--shards", "2", "--episodes", "8", "--frames", "20",
                    "--steps", "20", "--segments", "2", "--batch",
                    "128"] + SMALL_EVAL
# one shard of 16 episodes: 8 would hold at most 8 x 12 labelled frames,
# less than a batch of 128
DAGGER_AB_ARGV = ["--towns", "synth", "synth2", "--eval-towns", "synth3",
                  "--segments", "2", "--seg-steps", "10", "--shards", "1",
                  "--episodes", "16", "--frames", "20", "--dagger-frames",
                  "20", "--batch", "128"] + SMALL_EVAL
# phase 20 on an imported town and the grid town, evaluated on another
# imported town (the asset root of phase 21)
TRANSFUSER_ENTRY_ARGV = [
    "--towns", "Town01", "synth", "--eval-towns", "Town02", "--datasets",
    "2", "--episodes", "4", "--frames", "20", "--steps", "4",
    "--frames-per-step", "2", "--block-steps", "2", "--eval-every", "2",
    "--eval-routes", "2", "--final-eval-seeds", "1", "--dagger-rounds", "1",
    "--dagger-steps", "2", "--dagger-frames", "20"]
# the imported towns of phases 21-24: grids of yellow-marked two-way
# streets from maps/synthetic at 4 px/m, Town01 7 x 7 streets 115 m apart
# (3,000 x 3,000 px), Town02 the default grid (1,680 x 1,680 px), with
# 8 and 4 Longest6 routes
IMPORTED_TOWNS = {"Town01": dict(n_x=7, n_y=7, block=115.0), "Town02": {}}
IMPORTED_ROUTES = {"Town01": 8, "Town02": 4}
CARLA_TICKS = 512                 # run_benchmarks --max-ticks, run as one
                                  # chunk (the runner's chunk is 1,024;
                                  # cut in depth to keep the script short)
UNCHECKED_TICKS = 128             # the sensor benchmark's window timed
                                  # without the launch check
EXPORT_FRAMES = 16                # phase 5's frames written to disk: the
                                  # first PRED_LEN + 8 of its 24
EXPORT_REF_FRAMES = 3             # the export's card-vs-CPU reference
DISK_BATCH = 8                    # train_transfuser_from_disk's default
DISK_STEPS = 4                    # timed disk steps after a warm-up step
CODEC_REPS = 5                    # host timings: the median of 5
JPEG_PSNR_MIN = 35.0              # dB at quality 90 on a rendered frame
MODELS_BATCH = 16                 # the remaining models' timed forward
ENSEMBLE_MEMBERS = 2              # the converted ensemble: model_0030/31
ENSEMBLE_TICKS = 32               # its served ticks, every launch checked
PLANT_CONVERTED_TICKS = 8         # ticks of the converted PlanT
DP_RANKS = 2                      # ranks sharing the card over gloo
DP_MICRO_BATCH = 4                # the micro step's episodes, 2 a rank
DP_TRAIN_STEPS = 2                # timed full-width DP steps
DP_EVAL_TICKS = 32                # the sharded sensor eval, one chunk
DP_EXPERT_TICKS, DP_CHUNK = 64, 32  # the sharded expert run
FWD_BATCH = 16                    # bench_forward: its default batch,
FWD_ITERS = 30                    # its default timed calls, and the
FWD_PROFILE_ITERS = 5             # profiled run's timed calls
H100_BF16_FLOP_PER_S = 989e12     # dense bf16 on the tensor cores, H100
                                  # SXM data sheet
MERGED_RUNS = ("longest6", "lav")  # committed results/*_plant_r5_honest*
# the port's JPEG decode of one rendered frame on two devices' renders:
# the CPU test's bound (tests/test_torch_port_legacy_train.py)
JPEG_MAX, JPEG_MEAN = 3, 0.5


def log(*a):
  print(*a, flush=True)


class PhaseClock:
  """Numbers the phases, logs each one's title as it starts and its wall
  time when the next one starts (or at ``stop``)."""

  def __init__(self):
    self.n, self.t0 = 0, None

  def start(self, title):
    self.stop()
    self.n += 1
    log(f"phase {self.n}: {title}")
    self.t0 = time.perf_counter()

  def stop(self):
    if self.t0 is not None:
      log(f"  phase {self.n} wall time {time.perf_counter() - self.t0:.1f} s")
      self.t0 = None


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


def host_syncs(fn):
  """Run fn under torch's sync debug mode; the places that waited for the
  device."""
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
      fn()
    finally:
      torch.cuda.set_sync_debug_mode(0)
  return [f"{w.filename}:{w.lineno}" for w in caught
          if "called a synchronizing" in str(w.message)]


def bound(n_bytes, n_flops):
  """(bound ms, what bounds it) on the H100's data-sheet rates."""
  by_bytes = 1e3 * n_bytes / H100_BYTES_PER_S
  by_ops = 1e3 * n_flops / H100_FP32_FLOP_PER_S
  return max(by_bytes, by_ops), ("operations" if by_ops >= by_bytes
                                 else "bytes")


def check_raycast(name, inputs, timed=True):
  """Kernel vs plain version on the same card inputs. The kernel is built
  with -fmad=false and IEEE division and repeats the plain version's fp32
  operations in order for every pair its cull lets through, so they must
  agree bit for bit: equal t and equal classes. Untimed checks return
  times of 0."""
  from carla_garage_tpu_torch.ops.raycast import (raycast_boxes,
                                                  raycast_boxes_plain)
  saved = raycast_boxes.launches
  t, c = raycast_boxes(*inputs)
  torch.cuda.synchronize()
  t_ref, c_ref = raycast_boxes_plain(*inputs)
  err = float((t - t_ref).abs().max()) if t.numel() else 0.0
  mismatch = float((c != c_ref).float().mean()) if c.numel() else 0.0
  same = torch.equal(t, t_ref) and torch.equal(c, c_ref)
  ms = time_ms(lambda: raycast_boxes(*inputs)) if timed else 0.0
  plain_ms = time_ms(lambda: raycast_boxes_plain(*inputs), inner=2) \
      if timed else 0.0
  raycast_boxes.launches = saved     # comparison launches do not count
  log(f"  {name}: rays {tuple(inputs[1].shape)} boxes "
      f"{tuple(inputs[2].shape)}  bit-equal {same}  t max|err| {err:.3g}  "
      f"cls mismatch share {mismatch:.3g}" +
      (f"  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms" if timed else ""))
  assert same, (name, err, mismatch)
  return err, ms, plain_ms


def raycast_pairs(name, inputs):
  """Print the (ray, box) pairs of these inputs: valid, let through by the
  cull's mirror, in a footprint (what the bound charges), and hit by the
  exact test. Returns (bytes, flops) of the recounted bound."""
  from carla_garage_tpu_torch.ops.raycast import (raycast_boxes_cost,
                                                  raycast_candidates_plain,
                                                  raycast_hits_plain)
  n_bytes, n_flops, valid, foot = raycast_boxes_cost(*inputs)
  cand = int(raycast_candidates_plain(*inputs).sum())
  hits = int(raycast_hits_plain(*inputs).sum())
  assert hits <= cand and hits <= foot <= valid, (hits, cand, foot, valid)
  log(f"  {name} pairs: valid {valid}, cull candidates {cand} "
      f"({cand / max(valid, 1):.4f}), footprint {foot}, hits {hits}; bound "
      f"terms: bytes {bound(n_bytes, 0)[0]:.6f} ms ({n_bytes / 1e6:.1f} MB), "
      f"operations {bound(0, n_flops)[0]:.6f} ms ({n_flops / 1e9:.3f} "
      f"GFLOP)")
  return n_bytes, n_flops


def check_fill(name, boxes, h, w, timed=True):
  """The box-fill kernel vs its plain version on the same card inputs:
  built with -fmad=false, it repeats the plain version's fp32 operations
  in order for every box its tile cull keeps, so the maps must be equal
  pixel for pixel. Untimed checks return times of 0."""
  from carla_garage_tpu_torch.ops.bev_fill import (fill_boxes,
                                                   fill_boxes_bev_plain)
  saved = fill_boxes.launches
  out = fill_boxes(boxes, h, w)
  torch.cuda.synchronize()
  ref = fill_boxes_bev_plain(boxes, h, w)
  err = float((out.int() - ref.int()).abs().max()) if out.numel() else 0.0
  n_diff = int((out != ref).sum())
  ms = time_ms(lambda: fill_boxes(boxes, h, w)) if timed else 0.0
  plain_ms = time_ms(lambda: fill_boxes_bev_plain(boxes, h, w), inner=2) \
      if timed else 0.0
  fill_boxes.launches = saved        # comparison launches do not count
  log(f"  {name}: boxes {tuple(boxes.shape)} grid {h}x{w}  pixels that "
      f"differ {n_diff}  max|err| {err:.3g}  covered share "
      f"{float((out > 0).float().mean()):.4f}" +
      (f"  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms" if timed else ""))
  assert n_diff == 0, (name, n_diff)
  return err, ms, plain_ms


def sass_loops(lib):
  """The loops of a kernel library's SASS (cuobjdump -sass), each as
  "start-end: n instructions" between a backward branch's target and the
  branch; "cuobjdump not found" where the toolkit lacks it."""
  import re
  import shutil
  tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
  if not pathlib.Path(tool).exists():
    return "cuobjdump not found"
  text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                        text=True, timeout=120).stdout
  addrs, loops = [], []
  for line in text.splitlines():
    if "Function :" in line:
      addrs = []
    m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
    if not m:
      continue
    addr = int(m.group(1), 16)
    addrs.append(addr)
    br = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", m.group(2))
    if br and int(br.group(1), 16) < addr:
      start = int(br.group(1), 16)
      n = sum(1 for a in addrs if start <= a <= addr)
      loops.append(f"{start:#x}-{addr:#x}: {n}")
  return ", ".join(loops) or "none"


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


def reduced_sizes(cfg):
  """The test suite's reduced sensor sizes: a micro model on a 128x128
  BEV and a 32x128 camera."""
  from carla_garage_tpu_torch.models.transfuser import micro_config
  rcfg = cfg.replace(sensor=dataclasses.replace(
      cfg.sensor, lidar_resolution_width=128, lidar_resolution_height=128))
  tcfg = dataclasses.replace(micro_config(), img_h=32, img_w=128,
                             lidar_h=128, lidar_w=128, img_anchors=(1, 4),
                             lidar_anchors=(4, 4))
  return rcfg, tcfg


def small_reference_check(cfg, maps, lanes, scene, state):
  """Three ticks at B=2 with the micro model, on the card and on the CPU."""
  from carla_garage_tpu_torch.agents.sensor_agent import (
      make_transfuser_policy, sensor_agent_reset)
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


def expert_reference(cfg, maps, lanes, scene, state, n_frames=3):
  """Expert datagen at B=2 on the card and on the CPU from the same
  steer-noise draws: n_frames recorded frames (5 ticks each), the final
  state and every frame leaf. The CPU run is the port's path that the test
  suite holds against the JAX package."""
  from carla_garage_tpu_torch.sim.datagen import (SAVE_FREQ,
                                                  collect_expert_frames)

  B = 2
  gen = torch.Generator().manual_seed(5)
  draws = [{"steer_noise": torch.randn((B,), generator=gen)}
           for _ in range(n_frames * SAVE_FREQ)]
  runs = {}
  for dev in ("cpu", "cuda"):
    runs[dev] = collect_expert_frames(
        cfg, maps.to(dev), lanes.to(dev), slice_batch(scene, B).to(dev),
        slice_batch(state, B).to(dev), n_frames,
        draws=[{k: v.to(dev) for k, v in d.items()} for d in draws])
  torch.cuda.synchronize()
  worst = leaves_close(runs["cuda"], runs["cpu"], "expert, card vs CPU")
  log(f"  card vs CPU, expert datagen at B=2, {n_frames} frames "
      f"({n_frames * SAVE_FREQ} ticks): max |diff| of float leaves "
      f"{worst:.3g} (bar 1e-4 abs + 1e-4 rel), ints and bools equal")


def grads_close(g_g, g_c, what):
  """Gradients on the card against the CPU's: the bars of
  tests/test_torch_port_train.py (port vs JAX), 1e-3 of the global norm
  and 2e-2 of a tensor's largest entry; attention key biases have a zero
  gradient in exact arithmetic. Returns (error of the norm, worst
  tensor)."""
  gmax = max(float(g.abs().max()) for g in g_c.values())
  norm = sum(float((g ** 2).sum()) for g in g_c.values()) ** 0.5
  diff = sum(float(((g_g[n] - g_c[n]) ** 2).sum()) for n in g_c) ** 0.5
  worst = 0.0
  for n, g in g_c.items():
    if n.endswith("key.bias"):
      assert float(g_g[n].abs().max()) < 1e-5 * gmax, (what, n)
      continue
    err = float((g_g[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
    worst = max(worst, err)
    assert err < 2e-2, (what, n, err)
  assert diff < 1e-3 * norm, (what, diff / norm)
  return diff / norm, worst


def small_train_reference(cfg, maps, lanes, scene, state):
  """One train step at B=2 (micro model, reduced sensor sizes, two
  micro-batches, float32) on the card and on the CPU. Frames: 10 recorded
  frames of the expert on the CPU, copied to the card."""
  from carla_garage_tpu_torch.models.transfuser import LidarCenterNet
  from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
  from carla_garage_tpu_torch.sensors.lidar import full_lidar_grid
  from carla_garage_tpu_torch.sim.datagen import collect_expert_frames
  from carla_garage_tpu_torch.train.transfuser_train import (
      make_transfuser_train_step)

  B = 2
  rcfg, tcfg = reduced_sizes(cfg)
  expert_reference(cfg, maps, lanes, scene, state)
  cam = camera_ray_grid(rcfg, scale=8)
  lid = full_lidar_grid(rcfg, decimate=16)
  n_lidar = lid.shape[0] * lid.shape[1]
  maps_c, lanes_c = maps.to("cpu"), lanes.to("cpu")
  sc = slice_batch(scene, B).to("cpu")
  _, frames = collect_expert_frames(
      rcfg, maps_c, lanes_c, sc, slice_batch(state, B).to("cpu"), 10,
      generator=torch.Generator().manual_seed(3))
  torch.manual_seed(1)
  model = LidarCenterNet(tcfg)
  gen = torch.Generator().manual_seed(4)
  f_idx = [0, 1]
  draws = [{"lidar": torch.rand((B, n_lidar), generator=gen),
            "speed_drop": torch.rand((B,), generator=gen) < 0.15}
           for _ in f_idx]
  runs = {}
  for dev in ("cpu", "cuda"):
    m = LidarCenterNet(tcfg).to(dev)
    m.load_state_dict(model.state_dict())
    opt = torch.optim.SGD(m.parameters(), lr=1.0)
    step, _, _ = make_transfuser_train_step(
        rcfg, tcfg, m, opt, maps_c.to(dev), sc.to(dev), frames.to(dev), cam,
        lid)
    aux = step(f_idx, draws=[{k: v.to(dev) for k, v in d.items()}
                             for d in draws])
    runs[dev] = ({k: v.cpu() for k, v in aux.items()},
                 {n: p.grad.cpu() for n, p in m.named_parameters()})
  (aux_g, g_g), (aux_c, g_c) = runs["cuda"], runs["cpu"]
  assert set(aux_g) == set(aux_c) and len(aux_g) == 13, sorted(aux_g)
  worst_aux = 0.0
  for k in aux_c:
    # the same float32 model on cuDNN and on the CPU's kernels
    torch.testing.assert_close(aux_g[k], aux_c[k], rtol=2e-4, atol=1e-5,
                               msg=k)
    worst_aux = max(worst_aux, float((aux_g[k] - aux_c[k]).abs()))
  err, worst = grads_close(g_g, g_c, "train step")
  log(f"  card vs CPU, one train step at B=2: loss "
      f"{float(aux_c['loss']):.6f} vs {float(aux_g['loss']):.6f}, aux max "
      f"|diff| {worst_aux:.3g}; gradients {len(g_c)} tensors, error "
      f"{err:.3g} of the norm, {worst:.3g} of a tensor at worst")


def sensor_tick(cfg, maps, lanes, scene, state, kernels, args, card):
  """The sensor-on tick at full width. Returns (final state, start state,
  the raycast inputs of one warm-up tick, launches in the timed ticks)."""
  from carla_garage_tpu_torch.agents.sensor_agent import (
      make_transfuser_policy, sensor_agent_reset)
  from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                        TransfuserConfig)
  from carla_garage_tpu_torch.sensors import raycast as sensors_raycast
  from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
  from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
  from carla_garage_tpu_torch.sim.episode import rollout, sim_step

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

  # warm-up tick 1 records the kernel's inputs (camera, LiDAR)
  captured = []
  real = sensors_raycast.raycast_boxes

  def record(*xs):
    captured.append(tuple(x.clone() for x in xs))
    return real(*xs)

  sensors_raycast.raycast_boxes = record
  try:
    state = sim_step(cfg, maps, lanes, scene, state, policy, generator=gen)
  finally:
    sensors_raycast.raycast_boxes = real
  state = rollout(cfg, maps, lanes, scene, state, WARMUP - 1, policy,
                  generator=gen)
  torch.cuda.synchronize()
  start = state

  for k in kernels.values():
    k.launches = 0
  t0 = time.perf_counter()
  state = rollout(cfg, maps, lanes, scene, state, TICKS, policy,
                  generator=gen)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  launches = {n: k.launches for n, k in kernels.items()}
  log(f"  {TICKS} ticks at B={B}: {1e3 * dt / TICKS:.2f} ms/tick, "
      f"{B * TICKS / dt:.1f} env-steps/s  ({card})")
  log(f"  launches in the timed ticks: {launches}")
  assert launches == {"raycast_boxes": 2 * TICKS, "fill_boxes_bev": 0}, \
      launches

  syncs = host_syncs(lambda: sim_step(cfg, maps, lanes, scene, state,
                                      policy, generator=gen))
  log(f"  host syncs in one tick: {len(syncs)} {syncs}")
  assert not syncs, "a tick must not wait for the device"

  if args.profile:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      rollout(cfg, maps, lanes, scene, state, 2, policy, generator=gen)
      torch.cuda.synchronize()
    write_profile(args.profile, card, "two sensor-on ticks", prof, 2, "w")
  assert len(captured) == 2, len(captured)
  return state, start, captured, launches


def write_profile(path, card, what, prof, n, mode):
  events = prof.key_averages()
  table = events.table(sort_by="self_cuda_time_total", row_limit=40)
  on_card = [e for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA]
  busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3 / n
  n_launch = sum(e.count for e in on_card) / n
  log(f"  profiled {what}: device busy {busy_ms:.2f} ms each, "
      f"{n_launch:.0f} kernels, memsets and copies each (over {n})")
  out = pathlib.Path(path)
  out.parent.mkdir(parents=True, exist_ok=True)
  with out.open(mode) as f:
    f.write(f"{card}\n{what}\n{table}\n")
  log("\n".join(table.splitlines()[:25]))


def datagen(cfg, maps, lanes, scene, state, card):
  """Expert datagen on the card. Returns the recorded frames."""
  from carla_garage_tpu_torch.sim.datagen import (SAVE_FREQ,
                                                  collect_expert_frames,
                                                  waypoint_labels)
  from carla_garage_tpu_torch.sim.episode import sim_step
  from carla_garage_tpu_torch.structs import tree_items

  B = state.tick.shape[0]
  gen = torch.Generator(device="cuda").manual_seed(1)
  n_ticks = DATAGEN_FRAMES * SAVE_FREQ
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  final, frames = collect_expert_frames(cfg, maps, lanes, scene, state,
                                        DATAGEN_FRAMES, generator=gen)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  log(f"  {DATAGEN_FRAMES} frames ({n_ticks} ticks) at B={B}: "
      f"{1e3 * dt / n_ticks:.2f} ms/tick, {B * n_ticks / dt:.1f} "
      f"env-steps/s  ({card})")
  syncs = host_syncs(lambda: sim_step(cfg, maps, lanes, scene, final,
                                      generator=gen))
  log(f"  host syncs in one expert tick: {len(syncs)} {syncs}")
  assert not syncs, "a datagen tick must not wait for the device"
  n_leaves = 0
  for path, x in tree_items(frames):
    assert x.shape[:2] == (DATAGEN_FRAMES, B), (path, x.shape)
    if x.dtype.is_floating_point:
      assert bool(torch.isfinite(x).all()), path
    n_leaves += 1
  _, wp_valid = waypoint_labels(frames)
  usable = int(wp_valid.any(-1).sum())
  log(f"  {n_leaves} frame leaves finite; usable frames {usable}/"
      f"{DATAGEN_FRAMES}; brake share {float(frames.brake.mean()):.3f}; "
      f"done {int(final.done.sum())}/{B}; ego speed max "
      f"{float(frames.ego_speed.max()):.2f} m/s")
  assert usable >= 1
  return frames


def train_full_width(cfg, maps, scene, frames, kernels, args, card):
  """Full-width bf16 training on the recorded frames. Returns the kernels'
  inputs captured in the warm-up step and the launches of the timed
  steps."""
  from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                        TransfuserConfig)
  from carla_garage_tpu_torch.ops import bev_fill as ops_bev_fill
  from carla_garage_tpu_torch.sensors import raycast as sensors_raycast
  from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
  from carla_garage_tpu_torch.sensors.lidar import full_lidar_grid
  from carla_garage_tpu_torch.train import transfuser_train
  from carla_garage_tpu_torch.train.transfuser_train import (
      make_optimizer, make_transfuser_train_step)

  B = frames.ego_yaw.shape[1]
  K = MICRO_BATCHES
  tcfg = TransfuserConfig()
  torch.manual_seed(0)
  model = LidarCenterNet(tcfg).cuda()
  n_params = sum(p.numel() for p in model.parameters())
  # the training script's recipe: clip_by_global_norm(1.0), then adamw
  # with the multistep schedule over the steps run here
  opt, sched = make_optimizer(model, lr=3e-4, steps=TRAIN_STEPS + 2,
                              schedule="multistep")
  lid = full_lidar_grid(cfg)
  step, _, wp_valid = make_transfuser_train_step(
      cfg, tcfg, model, opt, maps, scene, frames, camera_ray_grid(cfg), lid,
      bf16=True, clip_norm=1.0, scheduler=sched)
  usable = np.nonzero(wp_valid.cpu().numpy().any(-1))[0]
  np_rng = np.random.default_rng(0)
  gen = torch.Generator(device="cuda").manual_seed(2)
  draw = lambda: np_rng.choice(usable, size=K).tolist()
  log(f"  model {n_params / 1e6:.1f}M parameters; LiDAR "
      f"{lid.shape[0] * lid.shape[1]} rays; {K} micro-batches of {B}")

  # the warm-up step records the kernels' inputs of its first micro-batch
  # (the box-fill kernel's input is the array that fill_boxes_bev packs)
  captured = {"raycast": [], "fill": []}
  real_rc, real_pack = sensors_raycast.raycast_boxes, ops_bev_fill.pack_boxes

  def rec_rc(*xs):
    captured["raycast"].append(tuple(x.clone() for x in xs))
    return real_rc(*xs)

  def rec_pack(*xs):
    boxes = real_pack(*xs)
    captured["fill"].append((boxes.clone(), cfg.sensor.lidar_resolution_height,
                             cfg.sensor.lidar_resolution_width))
    return boxes

  sensors_raycast.raycast_boxes, ops_bev_fill.pack_boxes = rec_rc, rec_pack
  try:
    aux = step(draw(), generator=gen)
  finally:
    sensors_raycast.raycast_boxes = real_rc
    ops_bev_fill.pack_boxes = real_pack
  torch.cuda.synchronize()
  assert len(captured["raycast"]) == 2 * K and len(captured["fill"]) == K
  log(f"  warm-up step: loss {float(aux['loss']):.4f}")

  # the timed steps' split: a CUDA event where a micro-batch's render +
  # labels start and end (the forward + backward runs from there to the
  # next render or to the clip), where the clip starts and where the
  # optimizer step ends
  events = []

  def mark(name):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    events.append((name, ev))

  real_batch, real_clip = (transfuser_train.make_train_batch,
                           torch.nn.utils.clip_grad_norm_)

  def timed_batch(*a, **kw):
    mark("render")
    out = real_batch(*a, **kw)
    mark("forward_backward")
    return out

  def timed_clip(*a, **kw):
    mark("optimizer")
    return real_clip(*a, **kw)

  for k in kernels.values():
    k.launches = 0
  torch.cuda.reset_peak_memory_stats()
  transfuser_train.make_train_batch = timed_batch
  torch.nn.utils.clip_grad_norm_ = timed_clip
  hook = opt.register_step_post_hook(lambda *_: mark("end"))
  try:
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
      aux = step(draw(), generator=gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
  finally:
    transfuser_train.make_train_batch = real_batch
    torch.nn.utils.clip_grad_norm_ = real_clip
    hook.remove()
  launches = {n: k.launches for n, k in kernels.items()}
  assert [n for n, _ in events] == (["render", "forward_backward"] * K +
                                    ["optimizer", "end"]) * TRAIN_STEPS
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  split = {}
  for (name, a), (_, b) in zip(events, events[1:]):
    if name != "end":
      split[name] = split.get(name, 0.0) + a.elapsed_time(b) / TRAIN_STEPS
  ms_step = 1e3 * dt / TRAIN_STEPS
  log(f"  {TRAIN_STEPS} steps of {K} x {B}: {ms_step:.1f} ms/step, "
      f"{K * B * TRAIN_STEPS / dt:.1f} samples/s  ({card})")
  log(f"  split per step (CUDA events): render + labels "
      f"{split['render']:.1f} ms, forward + backward "
      f"{split['forward_backward']:.1f} ms, optimizer "
      f"{split['optimizer']:.1f} ms; peak memory {peak_gb:.2f} GB")
  log(f"  launches in the timed steps: {launches}")
  assert launches == {"raycast_boxes": 2 * K * TRAIN_STEPS,
                      "fill_boxes_bev": K * TRAIN_STEPS}, launches
  bad = [k for k, v in aux.items() if not bool(torch.isfinite(v))]
  assert not bad, bad
  log("  aux of the last step: " + ", ".join(
      f"{k[5:] if k.startswith('loss_') else k} {float(v):.4f}"
      for k, v in aux.items()))
  syncs = host_syncs(lambda: step(draw(), generator=gen))
  log(f"  host syncs in one train step: {len(syncs)} {syncs}")
  assert not syncs, "a train step must not wait for the device"

  if args.profile:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      step(draw(), generator=gen)
      torch.cuda.synchronize()
    write_profile(args.profile, card, "one full-width train step", prof, 1,
                  "a")
  return captured, launches


def scenario_counts(scene, state) -> dict:
  """{type name: rows triggered} over the batch's valid scenario rows."""
  from carla_garage_tpu_torch.sim.scenarios import ScenarioType
  sp = scene.scenarios
  fired = (state.scenario.triggered & sp.valid).cpu()
  kind = sp.kind.cpu()
  return {name: f"{int((fired & (kind == v)).sum())}/"
                f"{int(((kind == v) & sp.valid.cpu()).sum())}"
          for name, v in vars(ScenarioType).items()
          if name.isupper() and name != "NONE"}


def scenario_scene_b2(cfg):
  """A B=2 scenario scene of the port's builder, on the host, with a
  hand-made CONTROL_LOSS row a few metres ahead of the ego's start.
  Returns (maps, lanes, scene, state)."""
  from carla_garage_tpu_torch.sim.scenarios import ScenarioType
  from carla_garage_tpu_torch.sim.scene_builder import make_town_batch

  B = 2
  t0 = time.perf_counter()
  _, maps, lanes, scene, state = make_town_batch(
      cfg, "synth", batch=B, seed=1, n_vehicles=8, n_walkers=2,
      use_scenarios=True, device="cpu")
  log(f"  scene built on the host in {time.perf_counter() - t0:.2f} s")
  # the synthetic town has no annotations, so the builder emits no
  # CONTROL_LOSS row: put one in the last (free) row, armed within 10 m of
  # the route point 8 m ahead, for 40 ticks
  sp = scene.scenarios
  K = sp.kind.shape[1]
  assert not bool(sp.valid[:, K - 1].any())
  set_row = lambda t, v: torch.cat([t[:, :K - 1], torch.full_like(
      t[:, K - 1:], v)], 1)
  sp = sp.replace(
      kind=set_row(sp.kind, ScenarioType.CONTROL_LOSS),
      trigger_pos=torch.cat([sp.trigger_pos[:, :K - 1],
                             scene.route.points[:, 8, None]], 1),
      trigger_dist=set_row(sp.trigger_dist, 10.0),
      duration=set_row(sp.duration, 40), magnitude=set_row(sp.magnitude, 0.1),
      valid=set_row(sp.valid, True))
  return maps, lanes, scene.replace(scenarios=sp), state


def card_vs_cpu_expert(cfg, maps, lanes, scene, state, seed):
  """SCENARIO_TICKS expert ticks of a scene on the card and on the CPU
  from the same steer-noise and control-loss draws. Returns (the CPU's
  final state, the worst float difference)."""
  from carla_garage_tpu_torch.sim.episode import sim_step

  B = state.tick.shape[0]
  K = scene.scenarios.kind.shape[1]
  gen = torch.Generator().manual_seed(seed)
  draws = [{"steer_noise": torch.randn((B,), generator=gen),
            "control_loss": torch.randn((B, K), generator=gen)}
           for _ in range(SCENARIO_TICKS)]
  runs = {}
  for dev in ("cpu", "cuda"):
    m, ln, sc, st = (x.to(dev) for x in (maps, lanes, scene, state))
    for d in draws:
      st = sim_step(cfg, m, ln, sc, st,
                    draws={k: v.to(dev) for k, v in d.items()})
    runs[dev] = st
  torch.cuda.synchronize()
  worst = leaves_close(runs["cuda"], runs["cpu"], "card vs CPU")
  return runs["cpu"], worst


def scenario_reference(cfg):
  """60 expert ticks on the B=2 scenario scene, on the card and on the CPU
  from the same draws."""
  B = 2
  maps, lanes, scene, state = scenario_scene_b2(cfg)
  K = scene.scenarios.kind.shape[1]
  final, worst = card_vs_cpu_expert(cfg, maps, lanes, scene, state, seed=6)
  cl_ticks = final.scenario.ticks_active[:, K - 1].tolist()
  assert min(cl_ticks) > 0, cl_ticks
  log(f"  card vs CPU, {SCENARIO_TICKS} expert ticks with scenarios at "
      f"B={B}: max |diff| of float leaves {worst:.3g} (bar 1e-4 abs + 1e-4 "
      f"rel), ints and bools equal; CONTROL_LOSS active ticks {cl_ticks}")
  log(f"  rows triggered (triggered/valid): {scenario_counts(scene, final)}")


def closed_loop_eval(cfg, kernels, args, card):
  """The closed-loop evaluation at full width on a 16-route scenario scene
  that the port builds. Returns (maps, lanes, scene, start state, policy,
  launches, ticks run)."""
  from carla_garage_tpu_torch.agents.sensor_agent import (
      make_transfuser_policy, sensor_agent_reset)
  from carla_garage_tpu_torch.eval import benchmark
  from carla_garage_tpu_torch.maps import native_router
  from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                        TransfuserConfig)
  from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
  from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
  from carla_garage_tpu_torch.sim import episode
  from carla_garage_tpu_torch.sim.scene_builder import make_town_batch
  from carla_garage_tpu_torch.sim.scoring import compute_scores, global_stats
  from carla_garage_tpu_torch.structs import tree_items

  B = 16
  t0 = time.perf_counter()
  _, maps, lanes, scene, state = make_town_batch(
      cfg, "synth", batch=B, seed=0, n_vehicles=100, n_walkers=2,
      use_scenarios=True)
  torch.cuda.synchronize()
  log(f"  scene of {B} routes (100 NPCs, 2 walkers, scenarios) built in "
      f"{time.perf_counter() - t0:.2f} s on the host; route gaps through "
      f"the {'native A*' if native_router.available() else 'scipy'} "
      f"router")
  tcfg = TransfuserConfig()
  torch.manual_seed(0)
  model = LidarCenterNet(tcfg).cuda()
  lid_f, lid_r = lidar_ray_grid(cfg, half=0), lidar_ray_grid(cfg, half=1)
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  policy = make_transfuser_policy(model, None, tcfg, camera_ray_grid(cfg),
                                  lid_f, lid_r, direct=True, bf16=True,
                                  brake_threshold=0.33)
  start = state.replace(agent=sensor_agent_reset(cfg, B, n_lidar))
  gen = torch.Generator(device="cuda").manual_seed(3)

  # count the chunks: rollout_chunked runs each through episode.rollout
  chunks = []
  real_rollout = episode.rollout

  def counted(*a, **kw):
    chunks.append(1)
    return real_rollout(*a, **kw)

  def chunked(n_ticks, chunk, check_syncs=False):
    """(final state, chunks run, seconds, host syncs or None) of
    rollout_chunked from start; the rollout runs under torch's sync debug
    mode when check_syncs is set."""
    out = []
    run = lambda: out.append(episode.rollout_chunked(
        cfg, maps, lanes, scene, start, n_ticks, chunk=chunk, policy=policy,
        generator=gen))
    chunks.clear()
    episode.rollout = counted
    try:
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      syncs = host_syncs(run) if check_syncs else run()
      torch.cuda.synchronize()
      return out[0], len(chunks), time.perf_counter() - t0, syncs
    finally:
      episode.rollout = real_rollout

  for k in kernels.values():
    k.launches = 0
  final, n_chunks, dt, _ = chunked(EVAL_TICKS, EVAL_CHUNK)
  launches = {n: k.launches for n, k in kernels.items()}
  ticks = n_chunks * EVAL_CHUNK
  log(f"  {ticks} ticks ({n_chunks} chunks of {EVAL_CHUNK}) at B={B}: "
      f"{1e3 * dt / ticks:.2f} ms/tick, {B * ticks / dt:.1f} env-steps/s  "
      f"({card})")
  log(f"  launches in the rollout: {launches}")
  assert launches == {"raycast_boxes": 2 * ticks, "fill_boxes_bev": 0}, \
      launches

  # the host syncs, on a short chunked run from the same start: once with
  # torch's sync debug mode off and once with it on, for its cost
  n = SYNC_CHECK_CHUNKS * SYNC_CHECK_CHUNK
  dt_off = chunked(n, SYNC_CHECK_CHUNK)[2]
  _, n_chunks, dt_on, syncs = chunked(n, SYNC_CHECK_CHUNK, check_syncs=True)
  log(f"  host syncs in {n} ticks ({n_chunks} chunks of {SYNC_CHECK_CHUNK}):"
      f" {len(syncs)} {syncs}; {1e3 * dt_off / n:.2f} ms/tick with the sync "
      f"debug mode off, {1e3 * dt_on / n:.2f} with it on")
  assert n_chunks == SYNC_CHECK_CHUNKS and len(syncs) == n_chunks and \
      all("episode.py" in x for x in syncs), \
      "one host sync a chunk, the done check"
  tick_syncs = host_syncs(lambda: episode.sim_step(
      cfg, maps, lanes, scene, final, policy, generator=gen))
  log(f"  host syncs in one eval tick: {len(tick_syncs)} {tick_syncs}")
  assert not tick_syncs, "an eval tick must not wait for the device"
  log(f"  scenario rows triggered (triggered/valid): "
      f"{scenario_counts(scene, final)}")
  for path, x in tree_items(final):
    if x.dtype.is_floating_point:
      assert bool(torch.isfinite(x).all()), path
  assert bool(((final.tick > 0) | final.done).all())

  t0 = time.perf_counter()
  lens = torch.as_tensor(benchmark._route_lens(scene), device="cuda")
  g = {k: float(v) for k, v in global_stats(compute_scores(
      cfg, final.criteria, lens)).items()}
  records = benchmark._records(cfg, scene, final,
                               [f"synth_{i}" for i in range(B)], "SynthTown")
  agg = benchmark.aggregate(records)
  for k in ("driving_score", "route_completion", "infraction_score"):
    assert abs(agg[k] - g[k]) <= 1e-4 * max(abs(g[k]), 1.0), (k, agg, g)
  with tempfile.TemporaryDirectory() as tmp:
    path = pathlib.Path(tmp) / "endpoint.json"
    benchmark.write_endpoint(records, agg, str(path),
                             meta={"ticks": ticks, "seed": 0, "card": card})
    benchmark.write_csv(records, str(pathlib.Path(tmp) / "results.csv"))
    back = json.loads(path.read_text())
    rows = (pathlib.Path(tmp) / "results.csv").read_text().splitlines()
  assert back["_checkpoint"]["records"] == records and len(rows) == B + 1
  assert back["_checkpoint"]["global_record"] == agg
  statuses = sorted({r["status"] for r in records})
  log(f"  scores in {time.perf_counter() - t0:.2f} s: DS "
      f"{agg['driving_score']:.3f}, RC {agg['route_completion']:.3f}, IS "
      f"{agg['infraction_score']:.3f} over {agg['num_routes']} routes; "
      f"statuses {statuses}; endpoint and CSV read back")

  if args.profile:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      episode.rollout(cfg, maps, lanes, scene, start, 2, policy,
                      generator=gen)
      torch.cuda.synchronize()
    write_profile(args.profile, card, "two eval ticks with scenarios", prof,
                  2, "a")
  return maps, lanes, scene, start, policy, launches, ticks


def dagger(cfg, maps, lanes, scene, start, policy, kernels, card):
  """DAgger datagen with the eval's policy on the eval's scene, from its
  start state: one chunk of DAGGER_FRAMES frames. Returns (launches,
  ticks run)."""
  from carla_garage_tpu_torch.sim.datagen import (SAVE_FREQ,
                                                  collect_dagger_frames,
                                                  make_dagger_policy)
  from carla_garage_tpu_torch.sim.episode import sim_step
  from carla_garage_tpu_torch.structs import tree_items

  B = start.tick.shape[0]
  gen = torch.Generator(device="cuda").manual_seed(4)
  n_ticks = DAGGER_FRAMES * SAVE_FREQ
  for k in kernels.values():
    k.launches = 0
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  final, frames = collect_dagger_frames(cfg, maps, lanes, scene, start,
                                        policy, DAGGER_FRAMES, generator=gen)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  launches = {n: k.launches for n, k in kernels.items()}
  log(f"  {DAGGER_FRAMES} frames ({n_ticks} ticks) at B={B}: "
      f"{1e3 * dt / n_ticks:.2f} ms/tick, {B * n_ticks / dt:.1f} "
      f"env-steps/s  ({card})")
  log(f"  launches: {launches}")
  assert launches == {"raycast_boxes": 2 * n_ticks, "fill_boxes_bev": 0}, \
      launches
  syncs = host_syncs(lambda: sim_step(cfg, maps, lanes, scene, final,
                                      make_dagger_policy(policy),
                                      generator=gen))
  log(f"  host syncs in one DAgger tick: {len(syncs)} {syncs}")
  assert not syncs, "a DAgger tick must not wait for the device"
  n_leaves = 0
  for path, x in tree_items(frames):
    assert x.shape[:2] == (DAGGER_FRAMES, B), (path, x.shape)
    if x.dtype.is_floating_point:
      assert bool(torch.isfinite(x).all()), path
    n_leaves += 1
  assert int(final.expert.planner_dense.idx.max()) > 0
  log(f"  {n_leaves} frame leaves finite; alive frames "
      f"{int(frames.alive.sum())}/{DAGGER_FRAMES * B}; expert brake share "
      f"{float(frames.brake.mean()):.3f}; ego speed max "
      f"{float(frames.ego_speed.max()):.2f} m/s")
  return launches, n_ticks


def device_kernels(fn):
  """(device busy ms, kernels, memsets and copies) of one call of fn, from
  torch.profiler."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  on_card = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  return (sum(e.self_device_time_total for e in on_card) / 1e3,
          sum(e.count for e in on_card))


def plant_reference(cfg):
  """The micro PlanT policy at B=2 on phase 8's scene for 20 ticks, on the
  card and on the CPU from the same weights and control-loss draws; then
  one micro train step at batch 32 on both devices, from the same weights
  and batch (32 samples of 30 expert frames recorded on the CPU)."""
  from carla_garage_tpu_torch.agents.plant_agent import (make_plant_policy,
                                                         plant_agent_reset)
  from carla_garage_tpu_torch.models.plant import PlanT, micro_plant
  from carla_garage_tpu_torch.sim.datagen import collect_expert_frames
  from carla_garage_tpu_torch.sim.episode import sim_step
  from carla_garage_tpu_torch.train.plant_train import (BATCH_KEYS,
                                                        build_plant_dataset,
                                                        plant_loss)

  B = 2
  maps, lanes, scene, state = scenario_scene_b2(cfg)
  K = scene.scenarios.kind.shape[1]
  pcfg = micro_plant()
  torch.manual_seed(7)
  weights = PlanT(pcfg).state_dict()
  gen = torch.Generator().manual_seed(8)
  draws = [{"control_loss": torch.randn((B, K), generator=gen)}
           for _ in range(PLANT_REF_TICKS)]
  runs = {}
  for dev in ("cpu", "cuda"):
    m = PlanT(pcfg).to(dev)
    m.load_state_dict(weights)
    policy = make_plant_policy(m, None, pcfg, direct=True, creep=True)
    mp, ln, sc, st = (x.to(dev) for x in (maps, lanes, scene, state))
    st = st.replace(agent=plant_agent_reset(cfg, B, device=dev))
    for d in draws:
      st = sim_step(cfg, mp, ln, sc, st, policy,
                    draws={k: v.to(dev) for k, v in d.items()})
    runs[dev] = st
  torch.cuda.synchronize()
  worst = leaves_close(runs["cuda"], runs["cpu"], "PlanT, card vs CPU")
  log(f"  card vs CPU, {PLANT_REF_TICKS} PlanT ticks (micro, direct, creep) "
      f"with scenarios at B={B}: max |diff| of float leaves {worst:.3g} "
      f"(bar 1e-4 abs + 1e-4 rel), ints and bools equal; dense route "
      f"index {runs['cpu'].agent.planner_dense.idx.tolist()}")

  _, frames = collect_expert_frames(cfg, maps, lanes, scene, state, 30,
                                    generator=torch.Generator().manual_seed(9))
  ds = build_plant_dataset(cfg, pcfg, frames, scene)
  assert len(ds) >= 32, len(ds)
  batch = {k: getattr(ds, k)[:32] for k in BATCH_KEYS
           if getattr(ds, k) is not None}
  runs = {}
  for dev in ("cpu", "cuda"):
    m = PlanT(pcfg).to(dev)
    m.load_state_dict(weights)
    loss, aux = plant_loss(m, {k: v.to(dev) for k, v in batch.items()})
    loss.backward()
    runs[dev] = ({k: v.detach().cpu() for k, v in aux.items()},
                 {n: p.grad.cpu() for n, p in m.named_parameters()})
  (aux_g, g_g), (aux_c, g_c) = runs["cuda"], runs["cpu"]
  assert set(aux_g) == set(aux_c) and len(aux_c) == 5, sorted(aux_c)
  worst_aux = 0.0
  for k in aux_c:
    torch.testing.assert_close(aux_g[k], aux_c[k], rtol=2e-4, atol=1e-5,
                               msg=k)
    worst_aux = max(worst_aux, float((aux_g[k] - aux_c[k]).abs()))
  err, worst = grads_close(g_g, g_c, "PlanT step")
  log(f"  card vs CPU, one micro PlanT step at batch 32 ({len(ds)} samples "
      f"recorded): loss {float(aux_c['loss']):.6f} vs "
      f"{float(aux_g['loss']):.6f}, aux max |diff| {worst_aux:.3g}; "
      f"gradients {len(g_c)} tensors, error {err:.3g} of the norm, "
      f"{worst:.3g} of a tensor at worst")


def plant_datagen(cfg, maps, lanes, scene, start, card):
  """The expert on phase 9's scene from its start: PLANT_FRAMES frames in
  chunks of PLANT_CHUNK, the quality gate, then the dataset at
  PlanTConfig(). Returns the dataset."""
  from carla_garage_tpu_torch.models.plant import PlanTConfig
  from carla_garage_tpu_torch.sim.datagen import (SAVE_FREQ,
                                                  collect_expert_frames)
  from carla_garage_tpu_torch.structs import tree_map
  from carla_garage_tpu_torch.train.plant_train import build_plant_dataset

  B = start.tick.shape[0]
  gen = torch.Generator(device="cuda").manual_seed(10)
  st, parts = start, []
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(PLANT_FRAMES // PLANT_CHUNK):
    st, fr = collect_expert_frames(cfg, maps, lanes, scene, st, PLANT_CHUNK,
                                   generator=gen)
    parts.append(fr)
  frames = tree_map(lambda *xs: torch.cat(xs), *parts)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  n_ticks = PLANT_FRAMES * SAVE_FREQ
  # the quality gate of scripts/train_plant.py: clean episodes only
  cr = st.criteria
  clean = (cr.n_collision_vehicle == 0) & (cr.n_collision_walker == 0) & \
      (cr.n_collision_static == 0) & (cr.n_red_light == 0) & ~cr.blocked
  frames = frames.replace(alive=frames.alive & clean[None])
  t0 = time.perf_counter()
  ds = build_plant_dataset(cfg, PlanTConfig(), frames, scene)
  torch.cuda.synchronize()
  dt_ds = time.perf_counter() - t0
  n_train = len(ds) - int(0.1 * len(ds))
  log(f"  {PLANT_FRAMES} frames ({n_ticks} ticks, chunks of {PLANT_CHUNK}) "
      f"at B={B}: {1e3 * dt / n_ticks:.2f} ms/tick ({card}); clean "
      f"episodes {int(clean.sum())}/{B}")
  log(f"  dataset: {len(ds)} samples ({n_train} to train), built in "
      f"{dt_ds:.2f} s; speed classes "
      f"{torch.bincount(ds.speed_label.long(), minlength=4).tolist()}; "
      f"object slots filled {float((ds.boxes.abs().sum(-1) > 0).float().mean()):.3f}")
  assert n_train >= PLANT_BATCH, \
      f"{n_train} training samples, fewer than one batch of {PLANT_BATCH}"
  return ds


def plant_train_full(cfg, ds, kernels, card):
  """PlanTConfig() training in float32 at batch PLANT_BATCH on the dataset,
  through ``plant_trainer``, the set-up and step that ``train_plant`` runs;
  then ``train_plant`` itself. Returns (the trained model, launches in the
  timed steps)."""
  from carla_garage_tpu_torch.models.plant import PlanTConfig
  from carla_garage_tpu_torch.train.plant_train import (
      estimate_speed_weights, plant_trainer, train_plant)

  pcfg = PlanTConfig()
  kw = dict(batch_size=PLANT_BATCH, lr=3e-4, schedule="multistep",
            estimate_weights=True)
  # one epoch's steps: the sync check runs that many in a row, so that it
  # takes in the step that draws an epoch's order and copies it over
  per_epoch = (len(ds) - int(0.1 * len(ds))) // PLANT_BATCH
  n_steps = 1 + PLANT_STEPS + per_epoch + 1
  tr = plant_trainer(cfg, pcfg, ds, n_steps, **kw)
  n_params = sum(p.numel() for p in tr.model.parameters())
  log(f"  PlanTConfig(): {n_params / 1e6:.2f}M parameters, "
      f"{pcfg.max_tokens} tokens; {n_steps} steps, {per_epoch} an epoch; "
      f"speed-class weights "
      f"{[round(w, 4) for w in estimate_speed_weights(ds)]}")
  aux = tr.step()
  torch.cuda.synchronize()
  log(f"  warm-up step: loss {float(aux['loss']):.4f}")
  for k in kernels.values():
    k.launches = 0
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  for _ in range(PLANT_STEPS):
    aux = tr.step()
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  launches = {n: k.launches for n, k in kernels.items()}
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  log(f"  {PLANT_STEPS} steps of {PLANT_BATCH}: {1e3 * dt / PLANT_STEPS:.2f} "
      f"ms/step, {PLANT_BATCH * PLANT_STEPS / dt:.1f} samples/s ({card}); "
      f"peak memory {peak_gb:.2f} GB")
  log(f"  launches in the timed steps: {launches}")
  assert launches == {"raycast_boxes": 0, "fill_boxes_bev": 0}, launches
  bad = [k for k, v in aux.items() if not bool(torch.isfinite(v))]
  assert not bad, bad
  log("  aux of the last step: " + ", ".join(
      f"{k[5:] if k.startswith('loss_') else k} {float(v):.4f}"
      for k, v in aux.items()))
  syncs = host_syncs(lambda: [tr.step() for _ in range(per_epoch)])
  log(f"  host syncs in {per_epoch} train steps in a row (batches drawn, "
      f"one epoch's start included): {len(syncs)} {syncs}")
  assert not syncs, "a PlanT train step must not wait for the device"
  busy, n_k = device_kernels(tr.step)
  log(f"  profiled step: device busy {busy:.2f} ms, {n_k} kernels, memsets "
      f"and copies")
  val = tr.validate()
  assert val and all(np.isfinite(v) for v in val.values()), val
  log(f"  validation ({int(0.1 * len(ds))} samples): " + ", ".join(
      f"{k} {v:.4f}" for k, v in val.items()))
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  _, hist = train_plant(cfg, pcfg, ds, steps=1 + PLANT_STEPS,
                        log_every=PLANT_STEPS + 1, **kw)
  dt = time.perf_counter() - t0
  assert len(hist) == 2 and np.isfinite(hist[-1]["loss"]) and \
      "val_loss" in hist[-1], hist
  log(f"  train_plant, {1 + PLANT_STEPS} steps from seed 0: loss "
      f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, val_loss "
      f"{hist[-1]['val_loss']:.4f} ({dt:.2f} s with its set-up and "
      f"validation)")
  return tr.model, launches


def plant_eval_dagger(cfg, maps, lanes, scene, start, model, ds, kernels,
                      card):
  """The trained PlanT at the eval suite's operating point on phase 9's
  scene, then the relabelling of the dataset and one DAgger chunk.
  Returns (eval launches, eval ticks, DAgger launches, DAgger ticks)."""
  from carla_garage_tpu_torch.agents.plant_agent import (make_plant_policy,
                                                         plant_agent_reset)
  from carla_garage_tpu_torch.eval import benchmark
  from carla_garage_tpu_torch.models.plant import PlanTConfig
  from carla_garage_tpu_torch.sim import episode
  from carla_garage_tpu_torch.sim.datagen import (SAVE_FREQ,
                                                  collect_dagger_frames)
  from carla_garage_tpu_torch.structs import tree_items
  from carla_garage_tpu_torch.train.plant_train import (build_plant_dataset,
                                                        relabel_with_plant)

  pcfg = PlanTConfig()
  B = start.tick.shape[0]
  policy = make_plant_policy(model, None, pcfg, direct=True,
                             brake_threshold=0.33, creep=True)
  st0 = start.replace(agent=plant_agent_reset(cfg, B))
  gen = torch.Generator(device="cuda").manual_seed(11)
  chunks = []
  real_rollout = episode.rollout

  def counted(*a, **kw):
    chunks.append(1)
    return real_rollout(*a, **kw)

  def chunked(n_ticks, chunk, check_syncs=False):
    out = []
    run = lambda: out.append(episode.rollout_chunked(
        cfg, maps, lanes, scene, st0, n_ticks, chunk=chunk, policy=policy,
        generator=gen))
    chunks.clear()
    episode.rollout = counted
    try:
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      syncs = host_syncs(run) if check_syncs else run()
      torch.cuda.synchronize()
      return out[0], len(chunks), time.perf_counter() - t0, syncs
    finally:
      episode.rollout = real_rollout

  for k in kernels.values():
    k.launches = 0
  final, n_chunks, dt, _ = chunked(EVAL_TICKS, EVAL_CHUNK)
  launches = {n: k.launches for n, k in kernels.items()}
  ticks = n_chunks * EVAL_CHUNK
  log(f"  {ticks} PlanT ticks ({n_chunks} chunks of {EVAL_CHUNK}) at B={B}:"
      f" {1e3 * dt / ticks:.2f} ms/tick, {B * ticks / dt:.1f} env-steps/s  "
      f"({card})")
  log(f"  launches in the rollout: {launches}")
  assert launches == {"raycast_boxes": 0, "fill_boxes_bev": 0}, launches
  n = SYNC_CHECK_CHUNKS * SYNC_CHECK_CHUNK
  _, n_chunks, _, syncs = chunked(n, SYNC_CHECK_CHUNK, check_syncs=True)
  tick_syncs = host_syncs(lambda: episode.sim_step(
      cfg, maps, lanes, scene, final, policy, generator=gen))
  log(f"  host syncs in {n} chunked ticks: {len(syncs)} {syncs}; in one "
      f"PlanT tick: {len(tick_syncs)} {tick_syncs}")
  assert n_chunks == SYNC_CHECK_CHUNKS and len(syncs) == n_chunks and \
      all("episode.py" in x for x in syncs), \
      "one host sync a chunk, the done check"
  assert not tick_syncs, "a PlanT tick must not wait for the device"
  busy, n_k = device_kernels(lambda: episode.rollout(
      cfg, maps, lanes, scene, final, 2, policy, generator=gen))
  log(f"  profiled PlanT ticks: device busy {busy / 2:.2f} ms, {n_k / 2:.0f} "
      f"kernels, memsets and copies a tick")
  for path, x in tree_items(final):
    if x.dtype.is_floating_point:
      assert bool(torch.isfinite(x).all()), path
  records = benchmark._records(cfg, scene, final,
                               [f"synth_{i}" for i in range(B)], "SynthTown")
  agg = benchmark.aggregate(records)
  log(f"  scores: DS {agg['driving_score']:.3f}, RC "
      f"{agg['route_completion']:.3f}, IS {agg['infraction_score']:.3f} over "
      f"{agg['num_routes']} routes; statuses "
      f"{sorted({r['status'] for r in records})}; scenario rows triggered "
      f"{scenario_counts(scene, final)}")

  torch.cuda.synchronize()
  t0 = time.perf_counter()
  rl = relabel_with_plant(model, ds)
  torch.cuda.synchronize()
  changed = float((rl.speed_label != ds.speed_label).float().mean())
  log(f"  relabel_with_plant over {len(ds)} samples in "
      f"{time.perf_counter() - t0:.2f} s: speed labels changed "
      f"{changed:.3f}, waypoint labels finite "
      f"{bool(torch.isfinite(rl.wp_label).all())}")
  assert bool(torch.isfinite(rl.wp_label).all())

  n_ticks = DAGGER_FRAMES * SAVE_FREQ
  for k in kernels.values():
    k.launches = 0
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  _, frames = collect_dagger_frames(cfg, maps, lanes, scene, st0, policy,
                                    DAGGER_FRAMES, generator=gen)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  d_launches = {n: k.launches for n, k in kernels.items()}
  assert d_launches == {"raycast_boxes": 0, "fill_boxes_bev": 0}, d_launches
  for path, x in tree_items(frames):
    assert x.shape[:2] == (DAGGER_FRAMES, B), (path, x.shape)
    if x.dtype.is_floating_point:
      assert bool(torch.isfinite(x).all()), path
  dds = build_plant_dataset(cfg, pcfg, frames, scene)
  dds.wp_weight = torch.zeros(len(dds), device=dds.boxes.device)
  log(f"  DAgger: {DAGGER_FRAMES} frames ({n_ticks} ticks) with PlanT "
      f"driving at B={B}: {1e3 * dt / n_ticks:.2f} ms/tick ({card}); "
      f"launches {d_launches}; dataset {len(dds)} samples, waypoint weight "
      f"0")
  return launches, ticks, d_launches, n_ticks


class StopSignAhead(torch.nn.Module):
  """`model` with a class-3 (stop sign) peak of logit +20 added to its
  CenterNet heatmap STOP_AHEAD_M ahead of the ego, where the CPU test's
  scripted model places one: seeded random weights detect none."""

  def __init__(self, model, cfg):
    super().__init__()
    self.model = model
    self.sensor = cfg.sensor

  def forward(self, *args):
    out = self.model(*args)
    heat = out["pred_bb"]["heatmap"]                 # [B,h,w,C] logits
    s = self.sensor
    cy = int(-s.min_y * heat.shape[1] / (s.max_y - s.min_y))
    cx = int((STOP_AHEAD_M - s.min_x) * heat.shape[2] / (s.max_x - s.min_x))
    peak = torch.zeros_like(heat)
    peak[:, cy, cx, 3] = 20.0
    return dict(out, pred_bb=dict(out["pred_bb"], heatmap=heat + peak))


def op_points(cfg, maps, lanes, scene, state0, kernels, card):
  """The sensor agent's operating points at full width on the committed
  scene, then jpeg_artifacts and topk_decode on the card against the CPU
  on one tick's inputs. Returns (launches in the timed ticks, ticks)."""
  from carla_garage_tpu_torch.agents import sensor_agent as sa
  from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                        TransfuserConfig)
  from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
  from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
  from carla_garage_tpu_torch.sim.episode import rollout

  B = state0.tick.shape[0]
  cam = camera_ray_grid(cfg)
  lid_f, lid_r = lidar_ray_grid(cfg, half=0), lidar_ray_grid(cfg, half=1)
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  captured = {}
  real_jpeg, real_topk = sa.jpeg_artifacts, sa.topk_decode
  real_stop = sa._stop_controller

  def rec_jpeg(rgb, quality):
    captured.setdefault("jpeg", (rgb.clone(), quality))
    return real_jpeg(rgb, quality=quality)

  def rec_topk(preds, **kw):
    captured.setdefault("topk", ({k: v.clone() for k, v in preds.items()},
                                 kw))
    return real_topk(preds, **kw)

  options = (("stop_control", dict(stop_control=True), {}, 1),
             ("jpeg_quality=95", dict(jpeg_quality=95), {}, 1),
             ("seq_len=2", {}, dict(lidar_channels=4), 2),
             ("map_track", dict(map_track=True), {}, 1),
             ("direct=False, use_wp_gru", dict(direct=False),
              dict(use_wp_gru=True), 1))
  total = {n: 0 for n in kernels}
  for name, policy_kw, model_kw, seq_len in options:
    tcfg = TransfuserConfig(**model_kw)
    torch.manual_seed(0)
    model = LidarCenterNet(tcfg).cuda()
    policy = sa.make_transfuser_policy(model, None, tcfg, cam, lid_f, lid_r,
                                       bf16=True, **{"direct": True,
                                                     **policy_kw})
    st = state0.replace(agent=sa.sensor_agent_reset(cfg, B, n_lidar,
                                                    seq_len=seq_len))
    gen = torch.Generator(device="cuda").manual_seed(12)
    sa.jpeg_artifacts, sa.topk_decode = rec_jpeg, rec_topk
    try:
      st = rollout(cfg, maps, lanes, scene, st, OP_WARMUP, policy,
                   generator=gen)
    finally:
      sa.jpeg_artifacts, sa.topk_decode = real_jpeg, real_topk
    must_stop, speed0 = [], st.ego.speed.clone()
    if policy_kw.get("stop_control"):
      # the egos start at rest and would only clear a box seen at once:
      # the peak comes with the timed ticks, once they are moving
      policy = sa.make_transfuser_policy(StopSignAhead(model, cfg), None,
                                         tcfg, cam, lid_f, lid_r, bf16=True,
                                         direct=True, **policy_kw)

      def rec_stop(*a):
        out = real_stop(*a)
        must_stop.append(out[3])
        return out
      sa._stop_controller = rec_stop
    torch.cuda.synchronize()
    for k in kernels.values():
      k.launches = 0
    t0 = time.perf_counter()
    try:
      st = rollout(cfg, maps, lanes, scene, st, OP_TICKS, policy,
                   generator=gen)
    finally:
      sa._stop_controller = real_stop
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    assert launches == {"raycast_boxes": 2 * OP_TICKS, "fill_boxes_bev": 0}, \
        (name, launches)
    ctl = st.agent.prev_control
    assert bool(torch.isfinite(ctl).all()), name
    ag = st.agent
    log(f"  {name}: {1e3 * dt / OP_TICKS:.2f} ms/tick at B={B} ({card}); "
        f"controls finite; launches {launches}; brake share "
        f"{float(ctl[:, 2].mean()):.3f}; tracked stop boxes "
        f"{int(ag.stop_box_valid.sum())}; LiDAR buffer "
        f"{tuple(ag.prev_lidar.shape[1:3])}")
    if must_stop:
      braked = torch.stack(must_stop).any(0)
      moving = speed0 > 0.01
      held = ag.stop_box_valid | (ag.clear_stop > 0)
      last = must_stop[-1]
      log(f"    stop sign {STOP_AHEAD_M} m ahead from the first timed tick: "
          f"egos moving then {int(moving.sum())}/{B} (speed "
          f"{float(speed0.min()):.3f}-{float(speed0.max()):.3f} m/s); "
          f"braked by the controller {int(braked.sum())}/{B}; tracking the "
          f"box or stopped in it and cooling down {int(held.sum())}/{B}; "
          f"braking on the last tick {int(last.sum())}/{B}")
      assert len(must_stop) == OP_TICKS and bool(moving.any()), \
          "no ego moved after the warm-up ticks"
      assert bool(braked[moving].all()), \
          "every moving ego must brake for the stop sign in its box"
      assert bool(held.all()), "every ego must track the box or clear it"
      assert bool((ctl[last, 2] == 1.0).all() and
                  (ctl[last, 1] == 0.0).all()), "a braking ego's control"
    for n in total:
      total[n] += launches[n]
    del model, policy, st
  assert set(captured) == {"jpeg", "topk"}, sorted(captured)

  rgb, quality = captured["jpeg"]
  out_g = real_jpeg(rgb, quality=quality).cpu()
  out_c = real_jpeg(rgb.cpu(), quality=quality)
  d = (out_g - out_c).abs()
  share = float((d > 1e-4).float().mean())
  log(f"  jpeg_artifacts card vs CPU on one tick's camera "
      f"{tuple(rgb.shape)} at quality {quality}: max |diff| "
      f"{float(d.max()):.3g}, share over 1e-4 {share:.3g} (bars: 1e-3 of "
      f"the values, 0.05 absolute: a DCT coefficient that rounds the other "
      f"way at a .5 boundary moves its block by up to ~0.02); changed the "
      f"image by up to {float((out_c - rgb.cpu()).abs().max()):.3f}")
  assert share < 1e-3 and float(d.max()) < 0.05
  preds, kw = captured["topk"]
  det_g = real_topk(preds, **kw)
  det_c = real_topk({k: v.cpu() for k, v in preds.items()}, **kw)
  worst = 0.0
  for k, v in det_c.items():
    g = det_g[k].cpu()
    if v.dtype.is_floating_point:
      torch.testing.assert_close(g, v, rtol=1e-5, atol=1e-5, msg=k)
      worst = max(worst, float((g - v).abs().max()))
    else:
      assert torch.equal(g, v), k
  log(f"  topk_decode card vs CPU on one tick's CenterNet outputs "
      f"{tuple(preds['heatmap'].shape)}, k={kw['k']}: ints equal, floats "
      f"max |diff| {worst:.3g} (bar 1e-5); best score "
      f"{float(det_c['score'].max()):.4f}")
  return total, len(options) * OP_TICKS


def finite_leaves(tree, what):
  """Assert every float leaf of tree finite; returns the leaf count."""
  from carla_garage_tpu_torch.structs import tree_items
  n = 0
  for path, x in tree_items(tree):
    if x.dtype.is_floating_point:
      assert bool(torch.isfinite(x).all()), (what, path)
    n += 1
  return n


def launches_during(kernels, fn):
  """(fn's result, each kernel's launches in it): the counts are set to 0
  just before fn runs and read just after."""
  for k in kernels.values():
    k.launches = 0
  out = fn()
  return out, {n: k.launches for n, k in kernels.items()}


@contextlib.contextmanager
def first_inputs_by_shape():
  """While the body runs, record the inputs of the first raycast call and
  of the first box-fill call of each distinct shape: the shapes a path
  gave the kernels. Yields {"raycast": [inputs], "fill": [(boxes, h,
  w)]}; a recorded call runs the kernel as before."""
  from carla_garage_tpu_torch.ops import bev_fill as ops_bev_fill
  from carla_garage_tpu_torch.sensors import bev as sensors_bev
  from carla_garage_tpu_torch.sensors import raycast as sensors_raycast

  seen = {"raycast": {}, "fill": {}}
  real_rc, real_bev = sensors_raycast.raycast_boxes, sensors_bev.fill_boxes_bev

  def rec_rc(*xs):
    key = tuple(tuple(x.shape) for x in xs)
    if key not in seen["raycast"]:
      seen["raycast"][key] = tuple(x.clone() for x in xs)
    return real_rc(*xs)

  def rec_bev(cx, cy, yaw, ex, ey, cls, valid, h=256, w=256):
    key = (tuple(cx.shape), h, w)
    if key not in seen["fill"]:         # the array fill_boxes_bev packs
      boxes = ops_bev_fill.pack_boxes(cx, cy, torch.cos(yaw), torch.sin(yaw),
                                      ex, ey, cls, valid)
      seen["fill"][key] = (boxes.contiguous(), h, w)
    return real_bev(cx, cy, yaw, ex, ey, cls, valid, h=h, w=w)

  out = {"raycast": [], "fill": []}
  sensors_raycast.raycast_boxes, sensors_bev.fill_boxes_bev = rec_rc, rec_bev
  try:
    yield out
  finally:
    sensors_raycast.raycast_boxes, sensors_bev.fill_boxes_bev = real_rc, \
        real_bev
    out["raycast"] = list(seen["raycast"].values())
    out["fill"] = list(seen["fill"].values())


@contextlib.contextmanager
def every_launch_checked():
  """While the body runs, hold every raycast and box-fill launch against
  its plain version on the same inputs, bit for bit. Each check runs on a
  side stream after the launch, on copies taken in order on the body's
  stream, so that it overlaps the body's next kernels; the next check of
  the same shapes waits for it, which bounds what the checks hold. The
  comparisons stay on the card (no host sync a launch) and are read once
  when the body ends, which fails if any launch differed. Launches made
  under torch's sync debug mode are skipped. The raycast's plain version
  (a Python loop of some 2,000 small operations over the box slots,
  launch-bound) is captured once per input shape as a CUDA graph of those
  same operations and replayed. Yields the counts: raycast, fill,
  skipped, graphs, the host seconds spent on the checks and, at the end,
  differing."""
  from carla_garage_tpu_torch.ops import bev_fill as ops_bev_fill
  from carla_garage_tpu_torch.ops.raycast import raycast_boxes_plain
  from carla_garage_tpu_torch.sensors import bev as sensors_bev
  from carla_garage_tpu_torch.sensors import raycast as sensors_raycast

  n = {"raycast": 0, "fill": 0, "skipped": 0, "graphs": 0, "host_s": 0.0}
  differs, graphs, done = [], {}, {}
  side = torch.cuda.Stream()
  real_rc, real_bev = sensors_raycast.raycast_boxes, sensors_bev.fill_boxes_bev
  quiet = lambda: torch.cuda.get_sync_debug_mode() == 0

  def after_last(key):
    """The body's stream waits for the last check of `key`."""
    if key in done:
      torch.cuda.current_stream().wait_event(done[key])

  def on_side(key, keep, check):
    """check() -> a bool tensor, on the side stream after the body's work
    so far; `keep` are the tensors it reads."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
      differs.append(check())
      done[key] = side.record_event()
    for x in keep:
      x.record_stream(side)

  def graph_for(key, xs):
    """(graph, static inputs, outputs) of raycast_boxes_plain at the
    shapes of `xs`, captured on first use."""
    if key not in graphs:
      static = [x.clone() for x in xs]
      warm = torch.cuda.Stream()
      warm.wait_stream(torch.cuda.current_stream())
      with torch.cuda.stream(warm):
        raycast_boxes_plain(*static)               # warm-up off the graph
      torch.cuda.current_stream().wait_stream(warm)
      graph = torch.cuda.CUDAGraph()
      with torch.cuda.graph(graph):
        out = raycast_boxes_plain(*static)
      graphs[key] = (graph, static, out)
      n["graphs"] += 1
    return graphs[key]

  def chk_rc(o, d, b):
    t, c = real_rc(o, d, b)
    if not quiet():
      n["skipped"] += 1
      return t, c
    t0 = time.perf_counter()
    key = ("raycast",) + tuple(tuple(x.shape) for x in (o, d, b))
    after_last(key)                     # its graph's inputs are free again
    graph, static, (t_ref, c_ref) = graph_for(key, (o, d, b))
    for dst, x in zip(static, (o, d, b)):
      dst.copy_(x)
    t_k, c_k = t.clone(), c.clone()

    def check():
      graph.replay()
      return (t_k != t_ref).any() | (c_k != c_ref).any()
    on_side(key, (t_k, c_k), check)
    n["raycast"] += 1
    n["host_s"] += time.perf_counter() - t0
    return t, c

  def chk_bev(cx, cy, yaw, ex, ey, cls, valid, h=256, w=256):
    out = real_bev(cx, cy, yaw, ex, ey, cls, valid, h=h, w=w)
    if not quiet():
      n["skipped"] += 1
      return out
    t0 = time.perf_counter()
    key = ("fill", tuple(cx.shape), h, w)
    after_last(key)
    xs = [x.clone() for x in (cx, cy, yaw, ex, ey, cls, valid, out)]

    def check():
      cx_, cy_, yaw_, ex_, ey_, cls_, valid_, out_ = xs
      boxes = ops_bev_fill.pack_boxes(cx_, cy_, torch.cos(yaw_),
                                      torch.sin(yaw_), ex_, ey_, cls_,
                                      valid_)
      return (out_ != ops_bev_fill.fill_boxes_bev_plain(boxes, h, w)).any()
    on_side(key, xs, check)
    n["fill"] += 1
    n["host_s"] += time.perf_counter() - t0
    return out

  sensors_raycast.raycast_boxes, sensors_bev.fill_boxes_bev = chk_rc, chk_bev
  try:
    yield n
  finally:
    sensors_raycast.raycast_boxes, sensors_bev.fill_boxes_bev = real_rc, \
        real_bev
  torch.cuda.current_stream().wait_stream(side)
  n["differing"] = int(torch.stack(differs).sum()) if differs else 0
  assert n["differing"] == 0, ("a kernel launch differs from its plain "
                               "version", n)


def check_path_inputs(path, recorded):
  """Each kernel against its plain version (bit-equal, timed) at every
  shape recorded on a path. Returns (raycast max|err|, fill max|err|)."""
  rc_err, fill_err = 0.0, 0.0
  for inputs in recorded["raycast"]:
    err, _, _ = check_raycast(f"raycast_boxes[{path}]", inputs)
    rc_err = max(rc_err, err)
  for boxes, h, w in recorded["fill"]:
    err, _, _ = check_fill(f"fill_boxes_bev[{path}]", boxes, h, w)
    fill_err = max(fill_err, err)
  return rc_err, fill_err


def bench_points(kernels, card):
  """bench.py's object-level point (B=256) and reduced sensor point
  (B=128) through the port's bench functions at a cut depth, the raycast
  kernel against its plain version at the sensor point's shapes, then
  both sensor points' stage profiles. Returns ({path: launches}, {path:
  ticks}, raycast max|err|)."""
  from carla_garage_tpu_torch import bench

  launches, ticks = {}, {}
  rc_err = 0.0
  for path, fn, n_ticks, b1 in (
      ("bench_object", lambda: bench.measure_object_level(
          ticks=BENCH_OBJ_TICKS, rounds=BENCH_ROUNDS), BENCH_OBJ_TICKS, 0),
      ("bench_sensor_reduced", lambda: bench.measure_sensor_on(
          False, ticks=BENCH_SENSOR_TICKS, rounds=BENCH_ROUNDS),
       BENCH_SENSOR_TICKS, 2)):
    t0 = time.perf_counter()
    with first_inputs_by_shape() as recorded:
      (rate, state), n = launches_during(kernels, fn)
    run = (1 + BENCH_ROUNDS) * n_ticks          # the warm-up round included
    B = state.tick.shape[0]
    n_leaves = finite_leaves(state, path)
    log(f"  {path}: B={B}, {BENCH_ROUNDS} timed rounds of {n_ticks} ticks "
        f"after a warm-up round: {rate:.1f} env-steps/s, "
        f"{1e3 * B / rate:.2f} ms/tick ({card}); launches {n} in {run} "
        f"ticks; {n_leaves} state leaves finite; "
        f"{time.perf_counter() - t0:.1f} s with the set-up")
    assert n == {"raycast_boxes": b1 * run, "fill_boxes_bev": 0}, (path, n)
    assert bool((state.tick > 0).all())
    assert len(recorded["raycast"]) == (2 if b1 else 0), \
        [tuple(x[1].shape) for x in recorded["raycast"]]
    rc_err = max(rc_err, check_path_inputs(path, recorded)[0])
    launches[path], ticks[path] = n, run
  for full_spec in (False, True):
    prof = bench.profile_sensor_stages(full_spec, reps=BENCH_PROFILE_REPS)
    log(f"  stage profile ({BENCH_PROFILE_REPS} repetitions, {card}): "
        f"{json.dumps(prof)}")
    assert all(np.isfinite(v) and v > 0 for k, v in prof.items()
               if k not in ("B", "config", "other_ms")), prof
  return launches, ticks, rc_err


def checkpoints_round_trip():
  """Save TransfuserConfig() and plant_config() models and load them into
  fresh models on the card: state dicts bit-equal, one forward equal;
  config_from_meta over every committed checkpoints/*/meta.json."""
  from carla_garage_tpu_torch.models.plant import PlanT
  from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                        TransfuserConfig)
  from carla_garage_tpu_torch.scripts.train_plant import plant_config
  from carla_garage_tpu_torch.utils.checkpoint import (config_from_meta,
                                                       load_checkpoint,
                                                       save_checkpoint)

  g = torch.Generator(device="cuda").manual_seed(0)
  rand = lambda *s: torch.rand(s, generator=g, device="cuda")
  tcfg, pcfg = TransfuserConfig(), plant_config()
  B, O, R = 2, pcfg.max_objects, pcfg.num_route_points
  cases = (
      ("transfuser", tcfg, LidarCenterNet,
       (rand(B, tcfg.img_h, tcfg.img_w, 3),
        rand(B, tcfg.lidar_h, tcfg.lidar_w, tcfg.lidar_channels),
        rand(B, 2) * 20, torch.eye(6, device="cuda")[:B], rand(B) * 8)),
      ("plant", pcfg, PlanT,
       (rand(B, O, 7) * 10, torch.randint(0, 4, (B, O), generator=g,
                                         device="cuda", dtype=torch.int32),
        rand(B, R, 2) * 30, rand(B).round(), rand(B).round(),
        rand(B).round(), rand(B) * 8)))
  with tempfile.TemporaryDirectory() as tmp:
    for seed, (name, mcfg, cls, inputs) in enumerate(cases):
      torch.manual_seed(seed)
      model = cls(mcfg).cuda().eval()
      path = str(pathlib.Path(tmp) / name)
      save_checkpoint(path, model, meta={"model": name,
                                         "config": dataclasses.asdict(mcfg)})
      _, meta = load_checkpoint(path, meta_only=True)
      back = config_from_meta(meta)
      assert back == mcfg and hash(back) == hash(mcfg), (name, back)
      torch.manual_seed(seed + 10)
      fresh = cls(back).cuda().eval()
      load_checkpoint(path, fresh)
      sd, sd2 = model.state_dict(), fresh.state_dict()
      assert sd.keys() == sd2.keys() and all(
          torch.equal(sd[k], sd2[k]) for k in sd), name
      with torch.no_grad():
        a, b = model(*inputs), fresh(*inputs)
      from carla_garage_tpu_torch.structs import tree_items
      pairs = list(zip(tree_items(a), tree_items(b)))
      assert pairs and all(torch.equal(x, y) for (_, x), (_, y) in pairs), \
          name
      log(f"  {name}: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}"
          f"M parameters saved and loaded bit-equal on the card; "
          f"config_from_meta equal and hashable; {len(pairs)} forward "
          f"outputs equal")
  metas = sorted(pathlib.Path("checkpoints").glob("*/meta.json"))
  kinds = {}
  for p in metas:
    c = config_from_meta(json.loads(p.read_text()))
    hash(c)
    kinds[type(c).__name__] = kinds.get(type(c).__name__, 0) + 1
  log(f"  config_from_meta over {len(metas)} committed meta.json: {kinds}, "
      f"all hashable")
  assert metas


def entry_plant(kernels, card):
  """train_plant end to end at plant_config() on synthetic towns at a cut
  depth. Returns the launches."""
  from carla_garage_tpu_torch.scripts import train_plant as tp
  from carla_garage_tpu_torch.utils.checkpoint import (cpu_state,
                                                       load_checkpoint)

  seg_states = []
  real_train = tp.train_plant

  def recorded(*a, **kw):
    model, hist = real_train(*a, **kw)
    seg_states.append(cpu_state(model))
    return model, hist

  with tempfile.TemporaryDirectory() as tmp:
    argv = PLANT_ENTRY_ARGV + ["--out", f"{tmp}/plant", "--results",
                               f"{tmp}/plant.json"]
    tp.train_plant = recorded
    try:
      t0 = time.perf_counter()
      out, n = launches_during(kernels, lambda: tp.run(tp.parse_args(argv),
                                                eval_chunk=ENTRY_EVAL_CHUNK))
      dt = time.perf_counter() - t0
    finally:
      tp.train_plant = real_train
    back = json.loads(pathlib.Path(f"{tmp}/plant.json").read_text())
    assert set(back) == {"samples", "steps", "best_eval", "evals", "meta"}, \
        sorted(back)
    best_seg = back["best_eval"]["segment"]
    saved, meta = load_checkpoint(f"{tmp}/plant")
    want = seg_states[best_seg]
    assert saved.keys() == want.keys() and all(
        torch.equal(saved[k], want[k]) for k in want)
    assert meta["model"] == "plant" and meta["samples"] == back["samples"]
  log(f"  train_plant: {back['samples']} samples, {len(back['evals'])} "
      f"segments, DS by segment {[round(e['DS'], 3) for e in back['evals']]}"
      f"; best segment {best_seg} saved and loaded bit-equal; {dt:.1f} s "
      f"({card}); launches {n}")
  assert n == {"raycast_boxes": 0, "fill_boxes_bev": 0}, n
  return n


def entry_dagger_ab(kernels, card):
  """dagger_ab end to end at a cut depth: both arms, a verdict, waypoint
  weight 0 on every DAgger sample. Returns the launches."""
  from carla_garage_tpu_torch.scripts import dagger_ab as da

  dagger_sets = []
  real_collect = da.collect_dagger_ds

  def recorded(*a, **kw):
    ds = real_collect(*a, **kw)
    dagger_sets.append(ds)
    return ds

  with tempfile.TemporaryDirectory() as tmp:
    argv = DAGGER_AB_ARGV + ["--results", f"{tmp}/ab.json"]
    da.collect_dagger_ds = recorded
    try:
      t0 = time.perf_counter()
      out, n = launches_during(kernels, lambda: da.run(da.parse_args(argv),
                                                eval_chunk=ENTRY_EVAL_CHUNK))
      dt = time.perf_counter() - t0
    finally:
      da.collect_dagger_ds = real_collect
  arms = [r["arm"] for r in out["arms"]]
  assert arms == ["bc", "dagger"] and out["verdict"] in (
      "dagger helps", "dagger hurts", "within noise"), out
  assert dagger_sets and all(bool((d.wp_weight == 0).all()) and len(d)
                             for d in dagger_sets)
  log(f"  dagger_ab: DS bc {out['arms'][0]['DS']:.3f}, dagger "
      f"{out['arms'][1]['DS']:.3f}, verdict {out['verdict']!r}; "
      f"{sum(len(d) for d in dagger_sets)} DAgger samples, waypoint weight "
      f"0; {dt:.1f} s ({card}); launches {n}")
  assert n == {"raycast_boxes": 0, "fill_boxes_bev": 0}, n
  return n


def entry_transfuser(kernels, card, root):
  """train_transfuser end to end at TransfuserConfig() (bf16) at a cut
  depth, on the imported Town01 and the grid town with evals on the
  imported Town02 of the asset root `root`, then once more with the same
  arguments, which must take every shard from the cache, resume the train
  state after the last BC step and run no BC step; it is stopped where
  its DAgger round begins, which would repeat the first run's (the CPU
  tests run a resumed call to its end and hold it to an uninterrupted
  one). Both kernels are held against their plain versions at every
  launch of the first run (every_launch_checked), and timed against them
  at every shape it gave them. Returns (the first run's launches, raycast
  max|err|, fill max|err|)."""
  from carla_garage_tpu_torch.scripts import train_transfuser as tf
  from carla_garage_tpu_torch.utils.checkpoint import load_checkpoint

  steps, built, syncs, resumed = [], [], [], []
  real_make, real_build = tf.make_transfuser_train_step, tf.build_dataset
  real_load, real_dagger = tf.load_trainstate, tf.build_dagger_dataset

  class ReachedDagger(Exception):
    """The resumed call has reached its DAgger rounds."""

  def make(*a, **kw):
    train_step, eval_step, wp_valid = real_make(*a, **kw)

    def step(*sa, **skw):
      before = {n: k.launches for n, k in kernels.items()}
      if len(steps) == 1:                 # the second step: sync check
        out = []
        syncs.extend(host_syncs(lambda: out.append(train_step(*sa, **skw))))
        aux = out[0]
      else:
        aux = train_step(*sa, **skw)
      steps.append({n: k.launches - before[n] for n, k in kernels.items()})
      return aux

    return step, eval_step, wp_valid

  def build(*a, **kw):
    built.append(1)
    return real_build(*a, **kw)

  def load(*a, **kw):
    ts = real_load(*a, **kw)
    resumed.append(None if ts is None else ts["step"])
    return ts

  def stop(*a, **kw):
    raise ReachedDagger

  args = lambda tmp: tf.parse_args(TRANSFUSER_ENTRY_ARGV + [
      "--out", f"{tmp}/tf", "--results", f"{tmp}/tf.json",
      "--assets-root", root])
  n_bc, n_dag = 4, 2
  K = 2
  with tempfile.TemporaryDirectory() as tmp:
    tf.make_transfuser_train_step, tf.build_dataset = make, build
    tf.load_trainstate = load
    try:
      t0 = time.perf_counter()
      with every_launch_checked() as checked, \
          first_inputs_by_shape() as recorded:
        out, n = launches_during(kernels, lambda: tf.run(
            args(tmp), eval_chunk=ENTRY_EVAL_CHUNK,
            eval_max_ticks=ENTRY_EVAL_TICKS))
      dt = time.perf_counter() - t0
      log(f"  launches checked against the plain versions (the sync-"
          f"checked step's skipped): {checked}")
      assert checked["raycast"] + checked["fill"] + checked["skipped"] == \
          n["raycast_boxes"] + n["fill_boxes_bev"], (checked, n)
      assert len(steps) == n_bc + n_dag and len(built) == 2, (steps, built)
      assert all(s == {"raycast_boxes": 2 * K, "fill_boxes_bev": K}
                 for s in steps), steps
      log(f"  train_transfuser: {len(steps)} steps ({n_bc} BC + {n_dag} "
          f"DAgger) of {K} micro-batches, each with "
          f"{steps[0]['raycast_boxes']} raycast and "
          f"{steps[0]['fill_boxes_bev']} box-fill launches; host syncs in "
          f"its second step {len(syncs)} {syncs}; final DS "
          f"{out['transfuser_DS']:.3f}; {dt:.1f} s ({card}); launches {n}")
      assert not syncs, "a train step must not wait for the device"
      back = json.loads(pathlib.Path(f"{tmp}/tf.json").read_text())
      assert {"transfuser_DS", "transfuser_DS_std", "transfuser_RC",
              "transfuser_IS", "final_eval", "best_train_eval", "evals",
              "steps", "frames", "meta"} == set(back), sorted(back)
      assert [e["step"] for e in back["evals"]] == [2, 4, 4 + n_dag]
      for name in ("tf_step2", "tf_step4", "tf_dagger0", "tf"):
        sd, meta = load_checkpoint(f"{tmp}/{name}")
        assert meta["model"] == "transfuser" and all(
            bool(torch.isfinite(v).all()) for v in sd.values()), name
      ts = torch.load(f"{tmp}/tf_trainstate.pt", weights_only=False)
      assert ts["step"] == n_bc, ts["step"]
      log(f"  checkpoints tf_step2, tf_step4, tf_dagger0 and the best "
          f"(DS {back['best_train_eval']['DS']:.3f} at step "
          f"{back['best_train_eval']['step']}) load; results JSON read back")
      # training renders a camera and a full sweep a micro-batch and one
      # BEV box map; the evals and DAgger a camera and a half sweep a tick
      assert len(recorded["raycast"]) >= 4 and recorded["fill"], \
          [tuple(x[1].shape) for x in recorded["raycast"]]
      rc_err, fill_err = check_path_inputs("entry_transfuser", recorded)

      steps.clear()
      built.clear()
      t0 = time.perf_counter()
      tf.build_dagger_dataset = stop
      try:
        tf.run(args(tmp), eval_chunk=ENTRY_EVAL_CHUNK,
               eval_max_ticks=ENTRY_EVAL_TICKS)
        raise AssertionError("the resumed call did not reach DAgger")
      except ReachedDagger:
        pass
      assert resumed == [None, n_bc], resumed
      assert not built and not steps, (built, steps)
      log(f"  second call: every shard from the cache, train state resumed "
          f"at step {resumed[1]}, 0 BC steps until its DAgger round, where "
          f"it is stopped; {time.perf_counter() - t0:.1f} s")
    finally:
      tf.make_transfuser_train_step, tf.build_dataset = real_make, real_build
      tf.load_trainstate, tf.build_dagger_dataset = real_load, real_dagger
  return n, rc_err, fill_err


def imported_towns(root):
  """Phase 21: an asset root in the reference's layout under `root` with
  the IMPORTED_TOWNS. Each town's lanes are first recovered without route
  or signal hints, to sample its routes (routing.sample_lane_route) and
  place its scenario sites; then the route XML and the annotations are
  written and the town is built as the benchmark loads it: through
  load_town where h5py imports, else through town_from_layers and the
  port's cache writer."""
  import os

  from carla_garage_tpu_torch.maps import importer, routing

  try:
    import h5py  # noqa: F401
    have_h5 = True
  except ImportError:
    have_h5 = False
  log(f"  h5py {'imports' if have_h5 else 'does not import'}: the towns go "
      + ("through h5 files and load_town" if have_h5 else
         "through town_from_layers and the port's cache writer into "
         f"{os.environ['CGT_TOWN_CACHE']}"))
  layers, routes, public, junction = {}, [], {}, {}
  for ti, (name, spec) in enumerate(IMPORTED_TOWNS.items()):
    t0 = time.perf_counter()
    ppm, off = 4.0, np.zeros(2, np.float32)
    arrays = importer.grid_town_arrays(ppm=ppm, **spec)
    if have_h5:
      importer.write_town_h5(root, name, arrays, ppm, off)
    layers[name] = (arrays, ppm, off)
    t1 = time.perf_counter()
    pre = importer.town_from_layers(name, importer.layers_from_arrays(arrays),
                                    ppm, off, root)
    t2 = time.perf_counter()
    rng = np.random.default_rng(ti)
    n = 0
    while n < IMPORTED_ROUTES[name]:
      res = routing.sample_lane_route(pre.lane_polys, pre.lane_successors,
                                      rng, min_len_m=250.0, max_len_m=500.0,
                                      is_connector=pre.lane_is_connector)
      if res is not None and np.linalg.norm(res[0][-1] - res[0][0]) >= 40.0:
        routes.append((str(len(routes)), name, *res))
        n += 1
    # Scenario1/3/4 along every third real lane each; the lights' approach
    # points of every fourth junction as Scenario10 (unsignalized), the
    # others as Scenario7/8/9 (signalized)
    lanes = [p for p, c in zip(pre.lane_polys, pre.lane_is_connector)
             if not c]
    deg = lambda p: float(np.degrees(np.arctan2(*(p[-1] - p[0])[::-1])))
    public[name] = {k: [(float(x), float(y), deg(p)) for p in lanes[i::3]
                        for x, y in p[1:-1:4]]
                    for i, k in enumerate(("Scenario1", "Scenario3",
                                           "Scenario4"))}
    # a junction's lights: those within 25 m of its first light
    grp = np.full(len(pre.light_pos), -1)
    for k in range(len(grp)):
      if grp[k] < 0:
        grp[(np.linalg.norm(pre.light_pos - pre.light_pos[k], axis=1) < 25.0)
            & (grp < 0)] = grp.max() + 1
    sites = [(float(x), float(y), float(np.degrees(a)))
             for (x, y), a in zip(pre.light_pos, pre.light_yaw)]
    junction[name] = {f"Scenario{7 + m}": [
        x for x, j in zip(sites, grp) if j % 4 == m] for m in range(4)}
    log(f"  {name}: layers {arrays['road'].shape} at {ppm} px/m made in "
        f"{t1 - t0:.1f} s; lanes recovered without hints in {t2 - t1:.1f} s "
        f"(host): {len(pre.lane_polys)} lanes, {len(pre.light_pos)} lights;"
        f" {IMPORTED_ROUTES[name]} routes sampled")
  data = os.path.join(root, importer.ROUTES_DIR)
  importer.write_routes_xml(os.path.join(data, "longest6.xml"), routes)
  scen = os.path.join(data, "scenarios")
  importer.write_scenarios_json(
      os.path.join(scen, "all_towns_traffic_scenarios_public.json"), public)
  for name, sites in junction.items():
    importer.write_scenarios_json(
        os.path.join(scen, f"{name.lower()}_all_scenarios.json"),
        {name: sites})

  for name, (arrays, ppm, off) in layers.items():
    t0 = time.perf_counter()
    if have_h5:
      town = importer.load_town(name, root)
    else:
      town = importer.town_from_layers(
          name, importer.layers_from_arrays(arrays), ppm, off, root)
      importer.write_town_cache(town, root)
    dt = time.perf_counter() - t0
    hints = importer.signal_hints_for(name, root)
    log(f"  {name}: built with route and signal hints in {dt:.1f} s (host"
        f"): {len(town.lane_polys)} lanes ({int(town.lane_is_connector.sum())}"
        f" connectors), {len(town.light_pos)} lights, {len(town.stop_pos)} "
        f"stop signs; signal hints "
        f"{sorted((k, len(v)) for k, v in hints.items())}")
    assert len(town.light_pos) and len(town.stop_pos), name
  importer._TOWN_CACHE.clear()     # the benchmark reads the disk cache


def imported_reference(cfg, root):
  """Phase 22: 60 expert ticks with scenarios on an imported town at B=2,
  on the card and on the CPU from the same draws."""
  from carla_garage_tpu_torch.sim.scene_builder import make_town_batch

  t0 = time.perf_counter()
  _, maps, lanes, scene, state = make_town_batch(
      cfg, "Town01", batch=2, seed=1, n_vehicles=8, n_walkers=2,
      use_scenarios=True, assets_root=root, device="cpu")
  log(f"  Town01 scene at B=2 built on the host in "
      f"{time.perf_counter() - t0:.2f} s")
  final, worst = card_vs_cpu_expert(cfg, maps, lanes, scene, state, seed=7)
  log(f"  card vs CPU, {SCENARIO_TICKS} expert ticks with scenarios on "
      f"Town01 at B=2: max |diff| of float leaves {worst:.3g} (bar 1e-4 abs "
      f"+ 1e-4 rel), ints and bools equal; lights "
      f"{int(scene.lights.valid.sum())}"
      f", stop signs {int(scene.stops.valid.sum())}; rows triggered "
      f"(triggered/valid): {scenario_counts(scene, final)}")
  assert bool((final.tick == SCENARIO_TICKS).all() | final.done.any())


def random_checkpoint(path):
  """Save TransfuserConfig() with weights from torch seed 0 as a port
  checkpoint at `path`."""
  from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                        TransfuserConfig)
  from carla_garage_tpu_torch.utils.checkpoint import save_checkpoint
  with torch.random.fork_rng(devices=[]):
    torch.manual_seed(0)
    model = LidarCenterNet(TransfuserConfig())
  save_checkpoint(path, model, meta={"model": "transfuser", "config":
                                     dataclasses.asdict(TransfuserConfig())})
  return path


def carla_benchmark(path, argv, n_episodes, b1, root, kernels, card):
  """run_benchmarks on the imported towns of `root` with `argv` (phases
  22-23): the endpoint JSON and CSV read back, every state leaf finite,
  b1 raycast launches a tick and no box fill, every launch held against
  the plain versions as it runs (every_launch_checked) and the first of
  each shape timed against them; ms/tick, env-steps/s, DS. With a
  kernel, the check's replays run in that time: a window of
  UNCHECKED_TICKS from the same start and draws, unchecked, gives the
  tick's own ms/tick. Without a kernel (the expert), the host syncs: one
  a chunk on a short chunked run from the same start, none a tick.
  Returns (launches, ticks, raycast max|err|)."""
  import csv

  from carla_garage_tpu_torch.eval import benchmark
  from carla_garage_tpu_torch.scripts import run_benchmarks as rb
  from carla_garage_tpu_torch.sim import episode

  runs, chunks = [], []
  real_chunked, real_rollout = benchmark.rollout_chunked, episode.rollout

  def counted(*a, **kw):
    chunks.append(1)
    return real_rollout(*a, **kw)

  def timed(cfg, maps, lanes, scene, state, max_ticks, chunk, policy,
            generator):
    chunks.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = real_chunked(cfg, maps, lanes, scene, state, max_ticks,
                         chunk=chunk, policy=policy, generator=generator)
    torch.cuda.synchronize()
    runs.append(dict(cfg=cfg, maps=maps, lanes=lanes, scene=scene,
                     start=state, final=final, policy=policy,
                     ticks=len(chunks) * chunk,
                     dt=time.perf_counter() - t0))
    return final

  t0 = time.perf_counter()
  args = rb.parse_args(argv)
  benchmark.rollout_chunked, episode.rollout = timed, counted
  try:
    with every_launch_checked() as checked, \
        first_inputs_by_shape() as recorded:
      out, n = launches_during(kernels, lambda: rb.run(args,
                                                       assets_root=root))
  finally:
    benchmark.rollout_chunked, episode.rollout = real_chunked, real_rollout
  run, = runs
  res = out["longest6"]
  back = json.loads(pathlib.Path(res["json"]).read_text())
  assert back["_checkpoint"]["records"] == res["records"]
  assert len(res["records"]) == n_episodes == run["start"].tick.shape[0]
  with open(res["csv"]) as f:
    rows = list(csv.reader(f))
  assert [r[0] for r in rows[1:]] == [r["route_id"] for r in res["records"]]
  g = res["global"]
  n_leaves = finite_leaves(run["final"], path)
  log(f"  {args.cmdline}")
  log(f"  {path}: B={n_episodes}, {run['ticks']} ticks in "
      f"{run['ticks'] // benchmark.CARLA_CHUNK} chunk(s) of "
      f"{benchmark.CARLA_CHUNK}: {1e3 * run['dt'] / run['ticks']:.2f} "
      f"ms/tick, {n_episodes * run['ticks'] / run['dt']:.1f} env-steps/s "
      f"{'(every launch checked) ' if b1 else ''}({card}); DS {g['driving_score']:.3f}, RC "
      f"{g['route_completion']:.3f}, IS {g['infraction_score']:.3f}; "
      f"statuses {sorted({r['status'] for r in res['records']})}; launches "
      f"{n}; {n_leaves} state leaves finite; endpoint (meta "
      f"{sorted(back['meta'])}) and CSV read back; "
      f"{time.perf_counter() - t0:.1f} s with the set-up")
  log(f"  launches checked against the plain versions: {checked}")
  assert n == {"raycast_boxes": b1 * run["ticks"], "fill_boxes_bev": 0}, n
  assert checked["raycast"] == n["raycast_boxes"], checked
  rc_err = check_path_inputs(path, recorded)[0]
  if b1:
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    real_chunked(run["cfg"], run["maps"], run["lanes"], run["scene"],
                 run["start"], UNCHECKED_TICKS, chunk=UNCHECKED_TICKS,
                 policy=run["policy"], generator=gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    log(f"  {path}, unchecked: the first {UNCHECKED_TICKS} ticks again from "
        f"the same start and draws in one chunk, no launch checked: "
        f"{1e3 * dt / UNCHECKED_TICKS:.2f} ms/tick, "
        f"{n_episodes * UNCHECKED_TICKS / dt:.1f} env-steps/s ({card})")
  else:
    gen = torch.Generator(device="cuda").manual_seed(5)
    syncs = host_syncs(lambda: real_chunked(
        run["cfg"], run["maps"], run["lanes"], run["scene"], run["start"],
        16, chunk=8, policy=run["policy"], generator=gen))
    tick_syncs = host_syncs(lambda: episode.sim_step(
        run["cfg"], run["maps"], run["lanes"], run["scene"], run["final"],
        run["policy"], generator=gen))
    log(f"  host syncs in 16 ticks (2 chunks of 8): {len(syncs)} {syncs}; "
        f"in one tick: {len(tick_syncs)} {tick_syncs}")
    assert len(syncs) == 2 and all("episode.py" in x for x in syncs), \
        "one host sync a chunk, the done check"
    assert not tick_syncs, "a benchmark tick must not wait for the device"
  return n, run["ticks"], rc_err


def host_ms(fn):
  """Host milliseconds of fn: the median of CODEC_REPS calls."""
  times = []
  for _ in range(CODEC_REPS):
    t0 = time.perf_counter()
    out = fn()
    times.append(1e3 * (time.perf_counter() - t0))
  return statistics.median(times), out


def codecs(cfg, maps, scene, state):
  """Phase 25: the disk path's host codecs on the card's machine. Reports
  whether PIL imports there (information only: nothing uses it) and which
  .lzc library loaded; builds the JPEG codec, then round-trips one
  episode's full-width rendered camera frame (JPEG, quality 90), its
  semantic PNG and its 24-bit depth PNG."""
  import importlib.util

  from carla_garage_tpu_torch.sensors.camera import (camera_ray_grid,
                                                     render_camera)
  from carla_garage_tpu_torch.train import legacy_train
  from carla_garage_tpu_torch.utils import image_io, lidar_codec

  pil = importlib.util.find_spec("PIL") is not None
  t0 = time.perf_counter()
  lib = image_io.library_path()
  log(f"  PIL importable: {pil} (unused); .lzc codec "
      f"{lidar_codec.library_path()}; image codec {lib.name} ready in "
      f"{time.perf_counter() - t0:.1f} s")
  cam = render_camera(cfg, maps, scene, state, camera_ray_grid(cfg))
  rgb = (torch.clamp(cam["rgb"][0], 0, 1) * 255).to(torch.uint8).cpu().numpy()
  sem = cam["semantic"][0].to(torch.uint8).cpu().numpy()
  depth = legacy_train._encode_depth_24bit(cam["depth"][0].cpu().numpy() /
                                           85.0)
  for what, img, enc, dec in (
      ("camera JPEG q90", rgb, lambda a: image_io.encode_jpeg(a, 90),
       image_io.decode_jpeg),
      ("semantic PNG", sem, image_io.encode_png, image_io.decode_png),
      ("depth PNG", depth, image_io.encode_png, image_io.decode_png)):
    enc_ms, data = host_ms(lambda: enc(img))
    dec_ms, back = host_ms(lambda: dec(data))
    assert back.shape == img.shape, (what, back.shape)
    if what.startswith("camera"):
      mse = float(np.mean((back.astype(np.float64) - img) ** 2))
      psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
      quality = f"PSNR {psnr:.2f} dB"
      assert psnr >= JPEG_PSNR_MIN, (what, psnr)
    else:
      assert np.array_equal(back, img), what
      quality = "exact"
    log(f"  {what} {img.shape}: {len(data)} bytes, {quality}; host encode "
        f"{enc_ms:.2f} ms, decode {dec_ms:.2f} ms")


def json_close(got, want, where, atol=1e-5, rtol=1e-5):
  if isinstance(want, dict):
    assert set(got) == set(want), where
    for k in want:
      json_close(got[k], want[k], f"{where}/{k}", atol, rtol)
  elif isinstance(want, list):
    assert len(got) == len(want), where
    for i, (g, w) in enumerate(zip(got, want)):
      json_close(g, w, f"{where}[{i}]", atol, rtol)
  elif isinstance(want, float):
    assert abs(got - want) <= atol + rtol * abs(want), (where, got, want)
  else:
    assert got == want, (where, got, want)


def same_dataset(card_root, cpu_root):
  """Phase 26's card-vs-CPU comparison of two exported directories: the
  same files; JSON floats within 1e-5; semantic and BEV PNGs equal; depth
  PNGs as depths within the tick reference's 1e-4; .lzc points within
  1e-5 m plus one quantum; JPEGs within the CPU test's bound. Returns
  {kind: worst difference}."""
  import gzip

  from carla_garage_tpu_torch.utils import image_io, lidar_codec

  def files(d):
    return sorted(os.path.relpath(os.path.join(a, f), d)
                  for a, _, fs in os.walk(d) for f in fs)

  names = files(card_root)
  assert names == files(cpu_root), "card and CPU wrote different files"
  worst = {"json": 0, "png_exact": 0, "depth_m": 0.0, "lidar_m": 0.0,
           "jpeg_levels": 0}
  for name in names:
    a, b = os.path.join(card_root, name), os.path.join(cpu_root, name)
    kind = name.split(os.sep)[1]
    if name.endswith(".json.gz"):
      with gzip.open(a, "rt") as fa, gzip.open(b, "rt") as fb:
        json_close(json.load(fa), json.load(fb), name)
      worst["json"] += 1
    elif kind == "rgb":
      d = np.abs(image_io.read_jpeg(a).astype(np.int16) -
                 image_io.read_jpeg(b).astype(np.int16))
      assert d.max() <= JPEG_MAX and d.mean() <= JPEG_MEAN, (name, d.max())
      worst["jpeg_levels"] = max(worst["jpeg_levels"], int(d.max()))
    elif kind == "depth":
      code = lambda p: image_io.read_png(p).astype(np.int64) @ np.array(
          [1, 256, 65536])
      da, db = (code(p) * (85.0 / (256 ** 3 - 1)) for p in (a, b))
      np.testing.assert_allclose(da, db, rtol=1e-4, atol=1e-4, err_msg=name)
      worst["depth_m"] = max(worst["depth_m"], float(np.abs(da - db).max()))
    elif name.endswith(".png"):
      assert np.array_equal(image_io.read_png(a), image_io.read_png(b)), name
      worst["png_exact"] += 1
    else:
      pa, pb = (lidar_codec.decompress(pathlib.Path(p).read_bytes())
                for p in (a, b))
      assert pa.shape == pb.shape, (name, pa.shape, pb.shape)
      err = float(np.abs(pa - pb).max()) if len(pa) else 0.0
      assert err <= 1e-5 + lidar_codec.DEFAULT_SCALE, (name, err)
      worst["lidar_m"] = max(worst["lidar_m"], err)
  return len(names), worst


def disk_export(cfg, maps, scene, frames, kernels, card, root):
  """Phase 26: export_reference_layout of phase 5's first EXPORT_FRAMES
  frames at full width (B=16, 1024x256 camera, 59,904-ray sweep) into
  `root`, with every kernel launch held to its plain version; each
  kernel timed against its plain version at the export's shapes; the
  frames through save_frames / load_frames; then a card-vs-CPU reference
  of the written files at B=2 on a small grid. Returns (launches, the
  kernel times at the export's shapes)."""
  from carla_garage_tpu_torch.ops import bev_fill as ops_bev_fill
  from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
  from carla_garage_tpu_torch.sensors.lidar import full_lidar_grid
  from carla_garage_tpu_torch.structs import tree_items, tree_map
  from carla_garage_tpu_torch.train import dataset_io, legacy_train

  F = EXPORT_FRAMES
  B = frames.ego_yaw.shape[1]
  sub = tree_map(lambda x: x[:F].contiguous(), frames)
  render_s = []
  real_render = legacy_train._frame_on_host

  def timed_render(*a, **kw):
    t0 = time.perf_counter()
    out = real_render(*a, **kw)               # ends in copies to the host
    render_s.append(time.perf_counter() - t0)
    return out

  gen = torch.Generator(device="cuda").manual_seed(3)
  legacy_train._frame_on_host = timed_render
  try:
    with every_launch_checked() as checked, \
        first_inputs_by_shape() as recorded:
      t0 = time.perf_counter()
      routes, n = launches_during(kernels, lambda: legacy_train.
                                  export_reference_layout(
                                      root, cfg, maps, scene, sub,
                                      camera_ray_grid(cfg),
                                      full_lidar_grid(cfg), generator=gen))
      dt = time.perf_counter() - t0
  finally:
    legacy_train._frame_on_host = real_render
  n_files = sum(len(fs) for _, _, fs in os.walk(root))
  n_bytes = sum(os.path.getsize(os.path.join(a, f))
                for a, _, fs in os.walk(root) for f in fs)
  by_kind = {}
  for a, _, fs in os.walk(root):
    for f in fs:
      k = os.path.basename(a) if f[0].isdigit() else "results"
      by_kind[k] = by_kind.get(k, 0) + os.path.getsize(os.path.join(a, f))
  log(f"  {F} frames x {B} episodes: {n_files} files, {n_bytes / 1e6:.1f} "
      f"MB ({', '.join(f'{k} {v / 1e6:.1f}' for k, v in by_kind.items())} "
      f"MB); host {dt:.2f} s = render {sum(render_s):.2f} s + encode and "
      f"write {dt - sum(render_s):.2f} s ({card}); launches {n}")
  log(f"  launches checked against the plain versions: {checked}")
  assert len(routes) == B and n_files == B * (7 * F + 1), (routes, n_files)
  assert n == {"raycast_boxes": 3 * F, "fill_boxes_bev": F}, n
  assert checked["raycast"] == 3 * F and checked["fill"] == F, checked
  times = {}
  for inputs in recorded["raycast"]:
    label = "camera" if inputs[1].shape[1] == 256 * 1024 else "sweep"
    _, ms, plain_ms = check_raycast(f"raycast_boxes[disk_export {label}]",
                                    inputs)
    times[label] = (ms, plain_ms, raycast_pairs(f"disk_export {label}",
                                                inputs))
  (boxes, h, w), = recorded["fill"]
  _, ms, plain_ms = check_fill("fill_boxes_bev[disk_export]", boxes, h, w)
  times["fill"] = (ms, plain_ms,
                   ops_bev_fill.fill_boxes_bev_cost(boxes, h, w)[:2])
  assert set(times) == {"camera", "sweep", "fill"}, sorted(times)

  with tempfile.TemporaryDirectory() as tmp:
    path = f"{tmp}/frames.npz"
    t0 = time.perf_counter()
    dataset_io.save_frames(frames, path)
    back = dataset_io.load_frames(path)
    for (p, x), (_, y) in zip(tree_items(frames), tree_items(back)):
      assert x.dtype == y.dtype and torch.equal(x, y), p
    log(f"  save_frames / load_frames of the {frames.ego_yaw.shape[0]} "
        f"frames: bit-equal on the card, {os.path.getsize(path) / 1e6:.2f} "
        f"MB, {time.perf_counter() - t0:.2f} s")

    small_cam, small_lid = camera_ray_grid(cfg, scale=8), \
        full_lidar_grid(cfg, decimate=16)
    n_rays = small_lid.shape[0] * small_lid.shape[1]
    g = torch.Generator().manual_seed(4)
    draws = [torch.rand((2, n_rays), generator=g) for _ in range(2)]
    fr2 = tree_map(lambda x: x[:EXPORT_REF_FRAMES, :2].contiguous(), frames)
    sc2 = slice_batch(scene, 2)
    for dev in ("cuda", "cpu"):
      legacy_train.export_reference_layout(
          f"{tmp}/{dev}", cfg, maps.to(dev), sc2.to(dev), fr2.to(dev),
          small_cam, small_lid, uniform_render=draws[0].to(dev),
          uniform_points=draws[1].to(dev))
    n_ref, worst = same_dataset(f"{tmp}/cuda", f"{tmp}/cpu")
    log(f"  card vs CPU export at B=2, {EXPORT_REF_FRAMES} frames, "
        f"{small_cam.shape[0]}x{small_cam.shape[1]} camera, {n_rays} rays: "
        f"{n_ref} files agree; worst {worst}")
  return n, times


def disk_train(cfg, root, kernels, card):
  """Phase 27: load_disk_samples on phase 26's directory, then
  train_transfuser_from_disk at TransfuserConfig() in bf16, batch
  DISK_BATCH, a warm-up step and DISK_STEPS timed ones, each split into
  the host batch build (stacking and the copy to the card) and the rest
  of the step (forward, backward, clip, AdamW; each step ends in a host
  sync reading its loss). Returns the launches."""
  from carla_garage_tpu_torch.models.transfuser import TransfuserConfig
  from carla_garage_tpu_torch.train import legacy_train

  tcfg = TransfuserConfig()
  t0 = time.perf_counter()
  samples = legacy_train.load_disk_samples(root, cfg, tcfg)
  dt = time.perf_counter() - t0
  assert len(samples) >= DISK_BATCH, len(samples)
  log(f"  load_disk_samples: {len(samples)} samples in {dt:.2f} s of host "
      f"time, {len(samples) / dt:.1f} samples/s decoded")
  marks = []
  real_batch, real_load = (legacy_train.make_disk_batch,
                           legacy_train.load_disk_samples)

  def timed_batch(*a, **kw):
    t = time.perf_counter()
    out = real_batch(*a, **kw)
    marks.append((t, time.perf_counter()))
    return out

  legacy_train.make_disk_batch = timed_batch
  legacy_train.load_disk_samples = lambda *a, **kw: samples
  torch.cuda.reset_peak_memory_stats()
  try:
    (model, hist), n = launches_during(kernels, lambda: legacy_train.
                                       train_transfuser_from_disk(
                                           root, cfg, tcfg,
                                           steps=1 + DISK_STEPS,
                                           batch_size=DISK_BATCH,
                                           log_every=1, bf16=True))
    torch.cuda.synchronize()
    t_end = time.perf_counter()
  finally:
    legacy_train.make_disk_batch = real_batch
    legacy_train.load_disk_samples = real_load
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  starts = [a for a, _ in marks] + [t_end]
  step_ms = [1e3 * (b - a) for a, b in zip(starts[1:], starts[2:])]
  batch_ms = [1e3 * (b - a) for a, b in marks[1:]]
  ms = statistics.mean(step_ms)
  host = statistics.mean(batch_ms)
  losses = [h["loss"] for h in hist]
  log(f"  {DISK_STEPS} steps of batch {DISK_BATCH} (after a warm-up step): "
      f"{ms:.1f} ms/step = host batch build {host:.1f} ms + device step "
      f"{ms - host:.1f} ms; {DISK_BATCH * 1e3 / ms:.1f} samples/s; peak "
      f"memory {peak_gb:.2f} GB ({card})")
  log(f"  losses {[round(v, 4) for v in losses]}; launches {n}")
  assert len(marks) == 1 + DISK_STEPS and len(hist) == 1 + DISK_STEPS
  assert all(np.isfinite(losses)), losses
  assert n == {"raycast_boxes": 0, "fill_boxes_bev": 0}, n
  assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
  return n


# --- slice 9: the remaining models and the reference-checkpoint loader -------

def remaining_models(kernels, card):
  """Phase 28: each module of slice 9 at full width with seeded weights,
  card against CPU at B=2 in float32, then the timed bf16 forward at
  B=16. Returns the launches (none)."""
  import copy
  from carla_garage_tpu_torch.models.aim import AIMBackbone
  from carla_garage_tpu_torch.models.bev_encoder import (BevEncoder,
                                                         make_projection_grid)
  from carla_garage_tpu_torch.models.heads import \
      GRUWaypointsPredictorTransFuser
  from carla_garage_tpu_torch.models.video_nets import (SwinTransformer3D,
                                                        VideoResNet)

  rng = np.random.default_rng(28)

  def inputs(B):
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    return {"rgb": f32(rng.uniform(0, 1, (B, 3, 256, 1024))),
            "bev": f32(rng.integers(0, 6, (B, 2, 64, 64)) / 5.0),
            "seq": f32(rng.integers(0, 6, (B, 2, 4, 256, 256)) / 5.0),
            "z": f32(rng.normal(size=(B, 64))),
            "tp": f32(rng.normal(0, 10, (B, 2)))}

  cases = (("AIMBackbone()", AIMBackbone, ("rgb",)),
           ("BevEncoder(projection=make_projection_grid())",
            lambda: BevEncoder(projection=make_projection_grid()),
            ("rgb", "bev")),
           ("VideoResNet()", VideoResNet, ("seq",)),
           ("SwinTransformer3D()", SwinTransformer3D, ("seq",)),
           ("GRUWaypointsPredictorTransFuser(pred_len=8)",
            lambda: GRUWaypointsPredictorTransFuser(8), ("z", "tp")))
  small, big = inputs(2), inputs(MODELS_BATCH)
  total = {n: 0 for n in kernels}
  for seed, (name, make, keys) in enumerate(cases):
    torch.manual_seed(seed)
    m = make().eval()
    n_par = sum(p.numel() for p in m.parameters())
    t0 = time.perf_counter()
    with torch.no_grad():
      want = m(*(small[k] for k in keys))
      m_g = copy.deepcopy(m).cuda()
      got = m_g(*(small[k].cuda() for k in keys))
    err = leaves_close(got, want, name)
    ref_s = time.perf_counter() - t0
    mb = copy.deepcopy(m_g).to(torch.bfloat16)
    x = [big[k].cuda().to(torch.bfloat16) for k in keys]
    with torch.no_grad():
      _, launches = launches_during(kernels, lambda: mb(*x))
      out = mb(*x)
      ms = time_ms(lambda: mb(*x), reps=5, inner=2)
    outs = out if isinstance(out, tuple) else (out,)
    assert all(bool(torch.isfinite(o.float()).all()) for o in outs), name
    assert not any(launches.values()), (name, launches)
    for n in total:
      total[n] += launches[n]
    log(f"  {name}: {n_par / 1e6:.2f}M parameters; card vs CPU at B=2 "
        f"float32 max |diff| {err:.3g} (bar 1e-4 abs + 1e-4 rel; "
        f"{ref_s:.1f} s); bf16 forward at B={MODELS_BATCH} "
        f"{[tuple(o.shape) for o in outs]} {ms:.3f} ms, finite ({card})")
    del m, m_g, mb, x, out, outs
  torch.cuda.empty_cache()
  return total


class RefDraw:
  """A state dict in the reference's key layout, every value drawn from a
  numpy seed: Linear and conv weights N(0, 1/fan_in), BatchNorm and
  LayerNorm gains near 1, BatchNorm running means N(0, 0.2) and variances
  U(0.5, 2) (so no fold is the identity), biases and embeddings small."""

  def __init__(self, seed):
    self.rng = np.random.default_rng(seed)
    self.sd = {}

  def put(self, key, shape, kind):
    r = self.rng
    if kind == "weight":
      x = r.standard_normal(shape, np.float32) / np.float32(
          np.sqrt(max(np.prod(shape[1:]), 1)))
    elif kind == "gamma":
      x = 1.0 + 0.1 * r.standard_normal(shape, np.float32)
    elif kind == "mean":
      x = 0.2 * r.standard_normal(shape, np.float32)
    elif kind == "var":
      x = r.uniform(0.5, 2.0, shape)
    else:
      x = 0.05 * r.standard_normal(shape, np.float32)
    self.sd[key] = torch.from_numpy(np.asarray(x, np.float32))

  def linear(self, p, out, inp, k=None):
    self.put(f"{p}.weight", (out, inp) + ((k, k) if k else ()), "weight")
    self.put(f"{p}.bias", (out,), "bias")

  def layernorm(self, p, c):
    self.put(f"{p}.weight", (c,), "gamma")
    self.put(f"{p}.bias", (c,), "bias")

  def batchnorm(self, p, c, affine=True):
    if affine:
      self.layernorm(p, c)
    self.put(f"{p}.running_mean", (c,), "mean")
    self.put(f"{p}.running_var", (c,), "var")
    self.sd[f"{p}.num_batches_tracked"] = torch.tensor(1000)

  def conv_bn(self, p, out, inp, k):
    self.put(f"{p}.conv.weight", (out, inp, k, k), "weight")
    self.batchnorm(f"{p}.bn", out)

  def timm_regnet(self, p, in_chans, spec):
    """timm's RegNetY keys: stem.conv/bn, s{i}.b{j}.conv1-3.{conv,bn},
    se.fc1/fc2, downsample.{conv,bn}, 1-based."""
    self.conv_bn(f"{p}.stem", spec["stem_w"], in_chans, 3)
    cin = spec["stem_w"]
    for si, (d, w) in enumerate(zip(spec["depths"], spec["widths"])):
      for bi in range(d):
        b = f"{p}.s{si + 1}.b{bi + 1}"
        rd = max(int(cin * spec["se_ratio"]), 8)
        self.conv_bn(f"{b}.conv1", w, cin, 1)
        self.conv_bn(f"{b}.conv2", w, w // max(w // spec["group_w"], 1), 3)
        self.linear(f"{b}.se.fc1", rd, w, 1)
        self.linear(f"{b}.se.fc2", w, rd, 1)
        self.conv_bn(f"{b}.conv3", w, w, 1)
        if bi == 0:
          self.conv_bn(f"{b}.downsample", w, cin, 1)
        cin = w

  def mha(self, p, d):
    self.put(f"{p}.in_proj_weight", (3 * d, d), "weight")
    self.put(f"{p}.in_proj_bias", (3 * d,), "bias")
    self.linear(f"{p}.out_proj", d, d)

  def gru(self, p, inp, hidden, suffix):
    self.put(f"{p}.weight_ih{suffix}", (3 * hidden, inp), "weight")
    self.put(f"{p}.weight_hh{suffix}", (3 * hidden, hidden), "weight")
    self.put(f"{p}.bias_ih{suffix}", (3 * hidden,), "bias")
    self.put(f"{p}.bias_hh{suffix}", (3 * hidden,), "bias")


def reference_transfuser_sd(c, seed):
  """A reference LidarCenterNet state dict (TransFuser++ with the
  transformer-decoder join) for TransfuserConfig c, both branches timm
  RegNetYs of c's arch."""
  from carla_garage_tpu_torch.models.backbones import arch_spec
  r = RefDraw(seed)
  ispec, lspec = arch_spec(c.image_arch), arch_spec(c.lidar_arch)
  r.timm_regnet("backbone.image_encoder", 3, ispec)
  r.timm_regnet("backbone.lidar_encoder", c.lidar_channels, lspec)
  n_tok = c.img_anchors[0] * c.img_anchors[1] + \
      c.lidar_anchors[0] * c.lidar_anchors[1]
  for i, (wi, wl) in enumerate(zip(ispec["widths"], lspec["widths"])):
    g = f"backbone.transformers.{i}"
    r.put(f"{g}.pos_emb", (1, n_tok, wi), "bias")
    for j in range(c.n_fusion_layers):
      b = f"{g}.blocks.{j}"
      r.layernorm(f"{b}.ln1", wi)
      r.layernorm(f"{b}.ln2", wi)
      for name in ("query", "key", "value", "proj"):
        r.linear(f"{b}.attn.{name}", wi, wi)
      r.linear(f"{b}.mlp.0", 4 * wi, wi)
      r.linear(f"{b}.mlp.2", wi, 4 * wi)
    r.layernorm(f"{g}.ln_f", wi)
    r.linear(f"backbone.lidar_channel_to_img.{i}", wi, wl, 1)
    r.linear(f"backbone.img_channel_to_lidar.{i}", wl, wi, 1)
  ch, d = c.bev_features_channels, c.d_model
  last_l, last_i = lspec["widths"][-1], ispec["widths"][-1]
  r.linear("backbone.c5_conv", ch, last_l, 1)
  r.linear("backbone.up_conv5", ch, ch, 3)
  r.linear("backbone.up_conv4", ch, ch, 3)
  r.linear("change_channel", d, last_l, 1)
  r.linear("extra_sensor_encoder.0", 128, 7)
  r.linear("extra_sensor_encoder.2", d, 128)
  r.put("extra_sensor_pos_embed", (1, d), "bias")
  r.batchnorm("velocity_normalization", 1, affine=False)
  for i in range(c.n_decoder_layers):
    lp = f"join.layers.{i}"
    r.mha(f"{lp}.self_attn", d)
    r.mha(f"{lp}.multihead_attn", d)
    r.linear(f"{lp}.linear1", 2048, d)
    r.linear(f"{lp}.linear2", d, 2048)
    for k in (1, 2, 3):
      r.layernorm(f"{lp}.norm{k}", d)
  r.layernorm("join.norm", d)
  r.put("checkpoint_query", (1, c.checkpoint_len + 1, d), "bias")
  decoders = ["checkpoint_decoder"]
  if c.use_wp_gru:
    r.put("wp_query", (1, c.pred_len, d), "bias")
    decoders.append("wp_decoder")
  for p in decoders:
    r.gru(f"{p}.gru", d, c.gru_hidden, "_l0")
    r.linear(f"{p}.encoder", c.gru_hidden, 2)
    r.linear(f"{p}.decoder", 2, c.gru_hidden)
  r.linear("target_speed_network.0", d, d)
  r.linear("target_speed_network.2", c.target_speed_bins, d)
  for p, n in (("semantic_decoder", c.num_semantic), ("depth_decoder", 1)):
    for k, (o, i) in enumerate(((128, last_i), (64, 128), (32, 64),
                                (32, 32), (32, 32), (n, 32))):
      r.linear(f"{p}.deconv{k // 2 + 1}.{2 * (k % 2)}", o, i, 3)
  r.linear("bev_semantic_decoder.0", ch, ch, 3)
  r.linear("bev_semantic_decoder.2", c.num_bev_semantic, ch, 1)
  outs = {"heatmap": c.num_bb_classes, "wh": 2, "offset": 2,
          "yaw_class": c.num_dir_bins, "yaw_res": 1}
  if c.bb_velocity_brake:
    outs.update(velocity=1, brake=2)
  for name, n in outs.items():
    r.linear(f"head.{name}_head.0", ch, ch, 3)
    r.linear(f"head.{name}_head.2", n, ch, 1)
  return r.sd


def reference_plant_sd(pc, seed):
  """A reference PlanT state dict: HuggingFace BERT under 'model', the
  token, type, forecast, velocity, waypoint, target-speed and checkpoint
  modules by the reference's names."""
  r = RefDraw(seed)
  h, A = pc.hidden, pc.num_attributes
  e = "model.embeddings"
  r.put(f"{e}.position_embeddings.weight", (pc.max_positions, h), "bias")
  r.put(f"{e}.token_type_embeddings.weight", (2, h), "bias")
  r.layernorm(f"{e}.LayerNorm", h)
  for i in range(pc.n_layers):
    lp = f"model.encoder.layer.{i}"
    for name in ("query", "key", "value"):
      r.linear(f"{lp}.attention.self.{name}", h, h)
    r.linear(f"{lp}.attention.output.dense", h, h)
    r.layernorm(f"{lp}.attention.output.LayerNorm", h)
    r.linear(f"{lp}.intermediate.dense", pc.intermediate, h)
    r.linear(f"{lp}.output.dense", h, pc.intermediate)
    r.layernorm(f"{lp}.output.LayerNorm", h)
  r.put("cls_emb", (1, A + 1), "gamma")
  r.linear("tok_emb", h, A)
  for i in range(pc.num_types):
    r.put(f"obj_token.{i}", (1, A), "gamma")
    r.linear(f"obj_emb.{i}", h, A)
  for i, v in enumerate(pc.vocab_sizes):
    r.linear(f"heads.{i}", v, h)
  r.linear("velocity_encoder.0", 128, 1)
  r.linear("velocity_encoder.2", 128, 128)
  r.batchnorm("velocity_normalization", 1, affine=False)
  r.linear("wp_head", 64 + 2, h + 128)
  r.gru("wp_decoder", 2 + 3, 64, "")
  r.linear("wp_output", 2, 64)
  r.linear("target_speed_network.0", 128, h + 128 + 3)
  r.linear("target_speed_network.2", pc.target_speed_bins, 128)
  r.gru("checkpoint_decoder.gru", h, pc.gru_hidden, "_l0")
  r.linear("checkpoint_decoder.decoder", 2, pc.gru_hidden)
  return r.sd


def converted_ensemble(cfg, maps, lanes, scene, state0, kernels, card):
  """Phase 29: a reference-layout TransFuser++ ensemble directory written,
  loaded by load_ensemble_directory and served on the committed scene.
  Returns (launches in the served ticks, ticks)."""
  import copy
  import pickle
  from carla_garage_tpu_torch.agents.sensor_agent import (
      make_transfuser_policy, sensor_agent_reset)
  from carla_garage_tpu_torch.convert.assemble import (
      load_ensemble_directory, transfuser_config_from_reference)
  from carla_garage_tpu_torch.models.transfuser import LidarCenterNet
  from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
  from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
  from carla_garage_tpu_torch.sim.episode import rollout

  # a published TF++'s config.pickle as a dict: the reference's defaults
  # with the ground-plane LiDAR channel (the sensor agent's 2 channels)
  attrs = {"use_ground_plane": True}
  want_cfg = transfuser_config_from_reference(attrs)
  with tempfile.TemporaryDirectory() as d:
    t0 = time.perf_counter()
    with open(f"{d}/config.pickle", "wb") as f:
      pickle.dump(attrs, f)
    for k in range(ENSEMBLE_MEMBERS):
      torch.save(reference_transfuser_sd(want_cfg, seed=30 + k),
                 f"{d}/model_{30 + k:04d}.pth")
    write_s = time.perf_counter() - t0
    mb = sum(os.path.getsize(p) for p in pathlib.Path(d).iterdir()) / 1e6
    t0 = time.perf_counter()
    tcfg, sds = load_ensemble_directory(d)
    load_s = time.perf_counter() - t0
  assert tcfg == want_cfg and len(sds) == ENSEMBLE_MEMBERS, tcfg
  n_par = sum(v.numel() for v in sds[0].values())
  log(f"  wrote {ENSEMBLE_MEMBERS} reference-layout model_*.pth + "
      f"config.pickle ({mb:.1f} MB) in {write_s:.2f} s; "
      f"load_ensemble_directory {load_s:.2f} s ({len(sds[0])} tensors, "
      f"{n_par / 1e6:.2f}M parameters a member)")

  # member 0, card vs CPU at B=2 in float32
  rng = np.random.default_rng(29)
  f32 = lambda a: torch.tensor(a, dtype=torch.float32)
  x = (f32(rng.uniform(0, 255, (2, tcfg.img_h, tcfg.img_w, 3))),
       f32(rng.integers(0, 6, (2, tcfg.lidar_h, tcfg.lidar_w,
                               tcfg.lidar_channels)) / 5.0),
       f32(rng.normal(0, 10, (2, 2))), f32(np.eye(6)[[1, 3]]),
       f32(rng.uniform(0, 8, 2)))
  m_cpu = LidarCenterNet(tcfg, norm="bn_affine").eval()
  m_cpu.load_state_dict(sds[0], strict=True)
  with torch.no_grad():
    want = m_cpu(*x)
    got = copy.deepcopy(m_cpu).cuda()(*(t.cuda() for t in x))
  err = leaves_close(got, want, "converted member 0")
  log(f"  member 0 card vs CPU at B=2 float32: every output within 1e-4 "
      f"abs + 1e-4 rel, max |diff| {err:.3g}")
  del m_cpu

  B = state0.tick.shape[0]
  cam = camera_ray_grid(cfg)
  lid_f, lid_r = lidar_ray_grid(cfg, half=0), lidar_ray_grid(cfg, half=1)
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  t0 = time.perf_counter()
  policy = make_transfuser_policy(
      LidarCenterNet(tcfg, norm="bn_affine").cuda(), sds, tcfg, cam, lid_f,
      lid_r, direct=True, bf16=True)
  torch.cuda.synchronize()
  policy_s = time.perf_counter() - t0
  st = state0.replace(agent=sensor_agent_reset(cfg, B, n_lidar))
  gen = torch.Generator(device="cuda").manual_seed(29)
  st = rollout(cfg, maps, lanes, scene, st, WARMUP, policy, generator=gen)
  torch.cuda.synchronize()
  start = st
  with every_launch_checked() as checked:
    t0 = time.perf_counter()
    st, launches = launches_during(kernels, lambda: rollout(
        cfg, maps, lanes, scene, start, ENSEMBLE_TICKS, policy,
        generator=gen))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
  assert launches == {"raycast_boxes": 2 * ENSEMBLE_TICKS,
                      "fill_boxes_bev": 0}, launches
  assert checked["raycast"] == 2 * ENSEMBLE_TICKS and \
      checked["differing"] == 0, checked
  n_leaves = finite_leaves(st, "converted ensemble")
  assert bool((st.tick > start.tick).all() | start.done.all())
  log(f"  {ENSEMBLE_MEMBERS}-member converted ensemble (bf16) served "
      f"{ENSEMBLE_TICKS} ticks at B={B}: {1e3 * dt / ENSEMBLE_TICKS:.2f} "
      f"ms/tick with every B1 launch checked on a side stream "
      f"({checked['raycast']} launches bit-equal to the plain version, "
      f"{checked['host_s']:.2f} host s of checks); policy built in "
      f"{policy_s:.2f} s; launches {launches}; {n_leaves} state leaves "
      f"finite; brake share {float(st.agent.prev_control[:, 2].mean()):.3f}"
      f" ({card})")
  del policy
  torch.cuda.empty_cache()
  return launches, ENSEMBLE_TICKS


def converted_plant(cfg, maps, lanes, scene, state0, kernels, card):
  """Phase 30: an HF-BERT-layout PlanTConfig() state dict through
  convert_plant into the port's PlanT, card against CPU at B=2, then PlanT
  ticks on the committed scene. Returns the launches (none)."""
  import copy
  from carla_garage_tpu_torch.agents.plant_agent import (make_plant_policy,
                                                         plant_agent_reset)
  from carla_garage_tpu_torch.convert.torch_import import convert_plant
  from carla_garage_tpu_torch.models.plant import PlanT, PlanTConfig
  from carla_garage_tpu_torch.sim.episode import rollout

  pcfg = PlanTConfig()
  t0 = time.perf_counter()
  sd = convert_plant(reference_plant_sd(pcfg, seed=30), pcfg.n_layers)
  model = PlanT(pcfg).eval()
  model.load_state_dict(sd, strict=True)
  conv_s = time.perf_counter() - t0
  rng = np.random.default_rng(30)
  O, R = pcfg.max_objects, pcfg.num_route_points
  f32 = lambda a: torch.tensor(a, dtype=torch.float32)
  x = (f32(rng.normal(0, 5, (2, O, 7))),
       torch.tensor(rng.integers(0, 4, (2, O)), dtype=torch.int32),
       f32(rng.normal(0, 10, (2, R, 2))), f32([0, 1]), f32([1, 0]),
       f32([0, 1]), f32(rng.uniform(0, 8, 2)))
  with torch.no_grad():
    want = model(*x)
    model = model.cuda()
    got = model(*(t.cuda() for t in x))
  err = leaves_close(got, want, "converted PlanT")
  B = state0.tick.shape[0]
  policy = make_plant_policy(model, None, pcfg, direct=True, creep=True)
  st = state0.replace(agent=plant_agent_reset(cfg, B))
  gen = torch.Generator(device="cuda").manual_seed(30)
  st, launches = launches_during(kernels, lambda: rollout(
      cfg, maps, lanes, scene, st, PLANT_CONVERTED_TICKS, policy,
      generator=gen))
  torch.cuda.synchronize()
  assert not any(launches.values()), launches
  n_leaves = finite_leaves(st, "converted PlanT ticks")
  log(f"  PlanTConfig() from a reference-layout state dict "
      f"({len(sd)} tensors, converted and loaded strict in {conv_s:.2f} s); "
      f"card vs CPU at B=2 float32 max |diff| {err:.3g} (bar 1e-4 abs + "
      f"1e-4 rel); {PLANT_CONVERTED_TICKS} PlanT ticks at B={B} on "
      f"the committed scene, {n_leaves} state leaves finite, launches "
      f"{launches} ({card})")
  del model, policy
  return launches


def dp_micro_payload(cfg, maps, lanes, scene, state0, path):
  """Phase 31b's inputs, saved to `path`: the micro TransFuser++ step at
  the reduced sensor sizes on the committed scene's first 4 episodes,
  10 expert frames recorded on the card, with vehicles placed around
  three egos and episode 3 done at the step's frames. Returns (f_idx, [(sample-weight sum, CenterNet boxes) of each
  shard] per micro-batch)."""
  from carla_garage_tpu_torch.models.transfuser import LidarCenterNet
  from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
  from carla_garage_tpu_torch.sensors.lidar import full_lidar_grid
  from carla_garage_tpu_torch.sim.datagen import collect_expert_frames
  from carla_garage_tpu_torch.train.transfuser_train import make_train_batch

  B, f_idx = DP_MICRO_BATCH, [1, 3]
  rcfg, tcfg = reduced_sizes(cfg)
  cam, lid = camera_ray_grid(rcfg, scale=8), full_lidar_grid(rcfg,
                                                             decimate=16)
  n_lidar = lid.shape[0] * lid.shape[1]
  sc = slice_batch(scene, B)
  _, frames = collect_expert_frames(
      rcfg, maps, lanes, sc, slice_batch(state0, B), 10,
      generator=torch.Generator(device="cuda").manual_seed(3))
  # detection labels: two vehicles placed around the egos of episodes 0
  # and 1 and one around episode 2's in every frame (the LiDAR gate of a
  # label needs 8 points of a 16x-decimated sweep), episode 3 done at the
  # step's frames
  fw = frames.ego_yaw
  c, s_ = torch.cos(fw), torch.sin(fw)
  vp, vy = frames.veh_pos.clone(), frames.veh_yaw.clone()
  ve, vv = frames.veh_extent.clone(), frames.veh_valid.clone()
  for v, (dx, dy, dyaw, eps) in enumerate([(9.0, 0.5, 0.0, (0, 1, 2)),
                                           (6.0, -7.0, 1.4, (0, 1))]):
    for b in eps:
      vp[:, b, v] = frames.ego_pos[:, b] + torch.stack(
          [c[:, b] * dx - s_[:, b] * dy, s_[:, b] * dx + c[:, b] * dy], -1)
      vy[:, b, v] = fw[:, b] + dyaw
      ve[:, b, v] = torch.tensor([2.3, 0.95], device=ve.device)
      vv[:, b, v] = True
  alive = frames.alive.clone()
  alive[f_idx, B - 1] = False
  frames = frames.replace(veh_pos=vp, veh_yaw=vy, veh_extent=ve,
                          veh_valid=vv, alive=alive)
  gen = torch.Generator().manual_seed(4)
  draws = [{"lidar": torch.rand((B, n_lidar), generator=gen),
            "speed_drop": torch.rand((B,), generator=gen) < 0.15}
           for _ in f_idx]
  counts = []
  for f, dr in zip(f_idx, draws):
    b = make_train_batch(rcfg, tcfg, maps, sc, frames, f,
                         torch.as_tensor(cam, device="cuda"),
                         torch.as_tensor(lid, device="cuda").reshape(-1, 3),
                         {k: v.cuda() for k, v in dr.items()})
    sw = b["sample_w"]
    m = (b["centernet"]["mask"] & (sw[:, None] > 0)).sum(1)
    counts.append([(float(sw[h:h + 2].sum()), int(m[h:h + 2].sum()))
                   for h in (0, 2)])
  torch.manual_seed(1)
  torch.save(dict(cfg=rcfg, tcfg=tcfg,
                  state_dict=LidarCenterNet(tcfg).state_dict(),
                  maps=maps.to("cpu"), scene=sc.to("cpu"),
                  frames=frames.to("cpu"), camera_grid=cam, lidar_grid=lid,
                  f_idx=f_idx, draws=draws,
                  runs=[dict(optimizer="sgd", lr=1.0)]), path)
  return f_idx, counts


def dp_train_rank(mesh, cfg, maps, scene, frames, kernels):
  """Phase 31c on one rank: full-width bf16 training on its 8 of each
  micro-batch's 16 episodes, ZeRO-1 AdamW. A warm-up step with every
  launch checked, then DP_TRAIN_STEPS timed steps."""
  from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                        TransfuserConfig)
  from carla_garage_tpu_torch.parallel import mesh as mesh_lib
  from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
  from carla_garage_tpu_torch.sensors.lidar import full_lidar_grid
  from carla_garage_tpu_torch.train.transfuser_train import (
      make_optimizer, make_transfuser_train_step)

  K, dev = MICRO_BATCHES, mesh.device
  tcfg = TransfuserConfig()
  torch.manual_seed(0)
  model = LidarCenterNet(tcfg).to(dev)
  mesh_lib.replicate(mesh, model.state_dict())
  opt, sched = make_optimizer(model, lr=3e-4, steps=DP_TRAIN_STEPS + 3,
                              schedule="multistep", mesh=mesh)
  step, _, wp_valid = make_transfuser_train_step(
      cfg, tcfg, model, opt, maps, scene, frames, camera_ray_grid(cfg),
      full_lidar_grid(cfg), bf16=True, clip_norm=1.0, scheduler=sched,
      mesh=mesh)
  usable = np.nonzero(wp_valid.cpu().numpy().any(-1))[0]
  np_rng = np.random.default_rng(0)        # the same frames on every rank
  gen = torch.Generator(device=dev).manual_seed(2)
  draw = lambda: np_rng.choice(usable, size=K).tolist()
  with every_launch_checked() as checked:
    _, warm = launches_during(kernels, lambda: step(draw(), generator=gen))
  torch.cuda.synchronize()

  event = lambda: torch.cuda.Event(enable_timing=True)
  reduces, steps = [], []
  real = mesh_lib.all_reduce_grads

  def timed_all_reduce(*a, **kw):
    a0, b0 = event(), event()
    a0.record()
    real(*a, **kw)
    b0.record()
    reduces.append((a0, b0))

  torch.cuda.reset_peak_memory_stats()
  mesh_lib.all_reduce_grads = timed_all_reduce
  try:
    for k in kernels.values():
      k.launches = 0
    t0 = time.perf_counter()
    for _ in range(DP_TRAIN_STEPS):
      a0, b0 = event(), event()
      a0.record()
      aux = step(draw(), generator=gen)
      b0.record()
      steps.append((a0, b0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
  finally:
    mesh_lib.all_reduce_grads = real
  local = mesh_lib.optimizer_state_bytes(opt)
  return dict(
      ms_step=[a.elapsed_time(b) for a, b in steps],
      host_ms_step=1e3 * dt / DP_TRAIN_STEPS,
      all_reduce_ms=[a.elapsed_time(b) for a, b in reduces],
      peak_gb=torch.cuda.max_memory_allocated() / 1e9,
      opt_bytes=local, opt_bytes_all=int(mesh_lib.global_sum(
          mesh, torch.tensor(local, dtype=torch.int64, device=dev))),
      grad_bytes=sum(p.grad.numel() * p.grad.element_size()
                     for p in model.parameters() if p.grad is not None),
      n_params=sum(p.numel() for p in model.parameters()),
      launches=launches, warm_launches=warm, checked=dict(checked),
      aux={k: float(v) for k, v in aux.items()})


def dp_eval_rank(mesh, cfg, maps, lanes, scene, state0, kernels):
  """Phase 31d on one rank: its 8 of the committed scene's 16 episodes
  under the full-width bf16 TransFuser++ (weights from rank 0) with its
  slice of the batch's draws, every launch checked; then the expert on
  the same split, the records gathered."""
  from carla_garage_tpu_torch.agents.sensor_agent import (
      make_transfuser_policy, sensor_agent_reset)
  from carla_garage_tpu_torch.eval.benchmark import (_records,
                                                     _shard_episode_batch,
                                                     _sharded_draw_fn)
  from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                        TransfuserConfig)
  from carla_garage_tpu_torch.parallel import mesh as mesh_lib
  from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
  from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
  from carla_garage_tpu_torch.sim.episode import rollout, rollout_chunked
  from carla_garage_tpu_torch.sim.expert import expert_step

  dev, B = mesh.device, state0.tick.shape[0]
  tcfg = TransfuserConfig()
  torch.manual_seed(0)
  model = LidarCenterNet(tcfg).to(dev)
  mesh_lib.replicate(mesh, model.state_dict())
  lid_f, lid_r = lidar_ray_grid(cfg, half=0), lidar_ray_grid(cfg, half=1)
  policy = make_transfuser_policy(model, None, tcfg, camera_ray_grid(cfg),
                                  lid_f, lid_r, direct=True,
                                  uncertainty_weight=True, bf16=True)
  st = state0.replace(agent=sensor_agent_reset(
      cfg, B, lid_f.shape[0] * lid_f.shape[1], device=dev))
  draw_fn = _sharded_draw_fn(mesh, policy, scene, st,
                             torch.Generator(device=dev).manual_seed(31))
  _, _, sc, st = _shard_episode_batch(mesh, maps, lanes, scene, st)
  st = rollout(cfg, maps, lanes, sc, st, WARMUP, policy, draw_fn=draw_fn)
  torch.cuda.synchronize()
  with every_launch_checked() as checked:
    t0 = time.perf_counter()
    final, launches = launches_during(kernels, lambda: rollout_chunked(
        cfg, maps, lanes, sc, st, DP_EVAL_TICKS, chunk=DP_EVAL_TICKS,
        policy=policy, draw_fn=draw_fn))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
  n_leaves = finite_leaves(final, "sharded sensor eval")
  del policy, model
  torch.cuda.empty_cache()

  draw_e = _sharded_draw_fn(mesh, expert_step, scene, state0,
                            torch.Generator(device=dev).manual_seed(64))
  _, _, sc_e, st_e = _shard_episode_batch(mesh, maps, lanes, scene, state0)
  final_e = rollout_chunked(cfg, maps, lanes, sc_e, st_e, DP_EXPERT_TICKS,
                            chunk=DP_CHUNK, draw_fn=draw_e)
  part = mesh_lib.shard_slice(mesh, B)
  ids = [f"dp_{i}" for i in range(B)][part]
  recs = mesh_lib.gather_records(mesh, _records(
      cfg, sc_e, final_e, ids, "SynthTown", first_index=part.start))
  return dict(ms_tick=1e3 * dt / DP_EVAL_TICKS, launches=launches,
              checked=dict(checked), n_leaves=n_leaves,
              brake=float(final.agent.prev_control[:, 2].mean()),
              records=recs)


def dp_card_rank(mesh, d):
  """Phase 31b-d on one of the ranks sharing the card."""
  from carla_garage_tpu_torch.ops import bev_fill as ops_bev_fill
  from carla_garage_tpu_torch.ops import raycast as ops_raycast
  from carla_garage_tpu_torch.parallel import workers
  from carla_garage_tpu_torch.scene_io import load_scene

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  kernels = {"raycast_boxes": ops_raycast.raycast_boxes,
             "fill_boxes_bev": ops_bev_fill.fill_boxes}
  out = {"micro": workers.transfuser_step_rank(mesh, f"{d}/micro.pt")[0]}
  p = torch.load(f"{d}/full.pt", weights_only=False)
  maps, lanes, scene, state0 = load_scene(device=mesh.device)
  out["train"] = dp_train_rank(mesh, p["cfg"], maps, scene,
                               p["frames"].to(mesh.device), kernels)
  out["eval"] = dp_eval_rank(mesh, p["cfg"], maps, lanes, scene, state0,
                             kernels)
  return out


def multi_gpu(cfg, maps, lanes, scene, state0, frames, kernels, card):
  """Phase 31. Returns ({path: {kernel: launches summed over the ranks}},
  the numbers it measured)."""
  from carla_garage_tpu_torch.eval.benchmark import _records
  from carla_garage_tpu_torch.parallel import launch, workers
  from carla_garage_tpu_torch.parallel.dryrun import dryrun_multichip
  from carla_garage_tpu_torch.sim.episode import rollout_chunked
  from carla_garage_tpu_torch.structs import tree_map

  t0 = time.perf_counter()
  dry = dryrun_multichip(1)[0]
  assert dry["opt_bytes_per_rank"] == [dry["opt_bytes_replicated"]], dry
  log(f"  a. dryrun_multichip(1) over NCCL in {time.perf_counter() - t0:.1f}"
      f" s: launches {dry['launches']}, DS "
      f"{dry['global_record']['driving_score']:.3f}")

  with tempfile.TemporaryDirectory() as d:
    f_idx, counts = dp_micro_payload(cfg, maps, lanes, scene, state0,
                                     f"{d}/micro.pt")
    torch.save(dict(cfg=cfg, frames=frames.to("cpu")), f"{d}/full.pt")
    t0 = time.perf_counter()
    ranks = launch.spawn(dp_card_rank, DP_RANKS, "gloo", "cuda", d,
                         tmpdir=d)
    spawn_s = time.perf_counter() - t0
    one = tree_map(lambda x: x.cpu(), workers.transfuser_step_rank(
        None, f"{d}/micro.pt", device="cuda")[0])

  # b. the micro step, two ranks against one process on the card
  log(f"  two ranks over gloo on the card in {spawn_s:.1f} s")
  for f, c in zip(f_idx, counts):
    log(f"  b. frame {f}: (sample-weight sum, CenterNet boxes) of the two "
        f"shards {c}")
  assert all(a[0] != b[0] for a, b in counts), counts
  assert any(a[1] != b[1] for a, b in counts), counts
  r0, r1 = ranks[0]["micro"], ranks[1]["micro"]
  rel = {k: float((r0["aux"][k] - v).abs() / v.abs().clamp(min=1e-6))
         for k, v in one["aux"].items()}
  g0, g_one = r0["grads"], one["grads"]
  assert set(g0) == set(g_one) == set(r1["grads"])
  norm = sum(float((g.double() ** 2).sum()) for g in g_one.values()) ** 0.5
  g_err = sum(float(((g0[n].double() - g.double()) ** 2).sum())
              for n, g in g_one.items()) ** 0.5 / norm
  log(f"  b. 2 ranks vs one process, aux relative differences "
      f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} }; gradients "
      f"{g_err:.3g} of the norm")
  for k in one["aux"]:
    assert torch.equal(r0["aux"][k], r1["aux"][k]), k
  assert all(torch.equal(g0[n], r1["grads"][n]) for n in g0)
  # float32, TF32 off; cuDNN picks its algorithms by batch size (4 on one
  # process, 2 a rank)
  worst_aux = max(rel.values())
  assert worst_aux < 1e-4, rel
  assert g_err < 1e-4, g_err
  log(f"  b. micro step, 2 ranks vs one process on the card (float32, TF32 "
      f"off): loss {float(r0['aux']['loss']):.6f} vs "
      f"{float(one['aux']['loss']):.6f}, aux max relative difference "
      f"{worst_aux:.3g} (bar 1e-4); all-reduced gradients {len(g0)} tensors, "
      f"error {g_err:.3g} of the norm (bar 1e-4), equal on both ranks")

  # c. full-width DP training
  tr = [r["train"] for r in ranks]
  K = MICRO_BATCHES
  want = {"raycast_boxes": 2 * K * DP_TRAIN_STEPS,
          "fill_boxes_bev": K * DP_TRAIN_STEPS}
  for t in tr:
    assert t["launches"] == want, t["launches"]
    assert t["checked"]["raycast"] == 2 * K and \
        t["checked"]["fill"] == K and t["checked"]["differing"] == 0, \
        t["checked"]
    assert all(np.isfinite(v) for v in t["aux"].values()), t["aux"]
  assert tr[0]["aux"] == tr[1]["aux"]
  ms = statistics.median(tr[0]["ms_step"])
  ar = statistics.median(tr[0]["all_reduce_ms"])
  repl = tr[0]["opt_bytes_all"]
  per_rank = [t["opt_bytes"] for t in tr]
  log(f"  c. full-width DP training, {DP_RANKS} ranks x {K} micro-batches "
      f"of {frames.ego_yaw.shape[1] // DP_RANKS}, bf16, ZeRO-1 AdamW: "
      f"{ms:.1f} ms/step on rank 0 by CUDA events ({tr[0]['ms_step']}; host "
      f"{tr[0]['host_ms_step']:.1f} ms/step), all-reduce of "
      f"{tr[0]['grad_bytes'] / 1e6:.1f} MB of float32 gradients "
      f"({tr[0]['n_params'] / 1e6:.2f}M parameters) {ar:.1f} ms "
      f"({100 * ar / ms:.1f}% of the step; {tr[0]['all_reduce_ms']}), peak "
      f"memory {[round(t['peak_gb'], 2) for t in tr]} GB a rank; optimizer "
      f"state {[round(b / 1e6, 1) for b in per_rank]} MB a rank against "
      f"{repl / 1e6:.1f} MB replicated ({repl / max(per_rank):.2f}x); "
      f"every launch of the warm-up step bit-equal ({tr[0]['checked']}); "
      f"launches a rank in the timed steps {tr[0]['launches']}  ({card}; "
      f"two ranks share this one card, so this is not a multi-card speed)")
  log("  c. aux of the last step: " + ", ".join(
      f"{k[5:] if k.startswith('loss_') else k} {v:.4f}"
      for k, v in tr[0]["aux"].items()))

  # d. the sharded eval, then the expert against one process
  ev = [r["eval"] for r in ranks]
  for e in ev:
    assert e["launches"] == {"raycast_boxes": 2 * DP_EVAL_TICKS,
                             "fill_boxes_bev": 0}, e["launches"]
    assert e["checked"]["raycast"] == 2 * DP_EVAL_TICKS and \
        e["checked"]["differing"] == 0, e["checked"]
  B = state0.tick.shape[0]
  final = rollout_chunked(cfg, maps, lanes, scene, state0, DP_EXPERT_TICKS,
                          chunk=DP_CHUNK,
                          generator=torch.Generator(
                              device="cuda").manual_seed(64))
  want_recs = _records(cfg, scene, final, [f"dp_{i}" for i in range(B)],
                       "SynthTown")
  got = ev[0]["records"]
  assert got == ev[1]["records"]
  assert [r["route_id"] for r in got] == [r["route_id"] for r in want_recs]
  worst = 0.0
  for a, b in zip(got, want_recs):
    for k in ("route_id", "town", "index", "status", "infractions",
              "events", "meta"):
      assert a[k] == b[k], (k, a[k], b[k])
    for k, v in b["scores"].items():
      worst = max(worst, abs(a["scores"][k] - v))
  assert worst <= 1e-4, worst
  log(f"  d. sharded sensor eval, {B} episodes split {B // DP_RANKS} + "
      f"{B // DP_RANKS}, full-width bf16: {ev[0]['ms_tick']:.2f} / "
      f"{ev[1]['ms_tick']:.2f} ms/tick on ranks 0 / 1 over "
      f"{DP_EVAL_TICKS} ticks with every launch checked "
      f"({ev[0]['checked']['raycast']} + {ev[1]['checked']['raycast']} "
      f"bit-equal); {ev[0]['n_leaves']} state leaves finite; brake share "
      f"{ev[0]['brake']:.3f} / {ev[1]['brake']:.3f}  ({card})")
  log(f"  d. expert, {DP_EXPERT_TICKS} ticks on the same split: the "
      f"gathered {len(got)} records equal one process's (ids, statuses, "
      f"infractions, events, meta; scores within {worst:.3g}), DS "
      f"{sum(r['scores']['score_composed'] for r in got) / len(got):.3f}")
  total = lambda runs: {n: sum(r["launches"][n] for r in runs)
                        for n in kernels}
  numbers = dict(ms_step=ms, all_reduce_ms=ar, opt_bytes=per_rank,
                 opt_bytes_replicated=repl)
  return {"dp_train": total(tr), "dp_eval": total(ev)}, numbers


def bench_forward_main(argv):
  """``bench_forward.main(argv)`` on the card: its printed lines logged,
  its JSON record returned."""
  from carla_garage_tpu_torch.scripts import bench_forward
  buf = io.StringIO()
  with contextlib.redirect_stdout(buf):
    assert bench_forward.main(argv) == 0
  lines = buf.getvalue().strip().splitlines()
  log("\n".join(f"  {ln}" for ln in lines))
  return json.loads(lines[-1]), lines[:-1]


def remaining_entry_points(kernels, card):
  """Phase 32: ``bench_forward`` at full spec with both norms, profiled,
  and card against CPU at micro size; ``merge_seed_runs`` on the
  committed seed files. Returns ({kernel: launches} of the two full-spec
  runs, the numbers it measured)."""
  from carla_garage_tpu_torch.models.transfuser import TransfuserConfig
  from carla_garage_tpu_torch.scripts import bench_forward, merge_seed_runs

  # a. both norms at the default operating point, B=16 bf16
  argv = ["--batch", str(FWD_BATCH), "--iters", str(FWD_ITERS)]
  recs, launches = {}, {n: 0 for n in kernels}
  for norm in ("gn", "bn_affine"):
    t0 = time.perf_counter()
    recs[norm], got = launches_during(
        kernels, lambda: bench_forward_main(argv + ["--norm", norm])[0])
    launches = {n: launches[n] + got[n] for n in kernels}
    log(f"  a. {norm} run in {time.perf_counter() - t0:.1f} s")
  flops = bench_forward.forward_flops(TransfuserConfig(), "gn", FWD_BATCH)
  bound_ms = 1e3 * flops / H100_BF16_FLOP_PER_S
  for norm, r in recs.items():
    assert r["params_M"] == 120.3 and r["bf16"] and \
        r["batch"] == FWD_BATCH, r
    assert np.isfinite(r["ms_per_step"]) and r["ms_per_step"] > 0, r
    log(f"  a. {norm}: {r['ms_per_step']} ms/step, {r['frames_per_s']} "
        f"frames/s, first call {r['compile_s']} s; {flops / 1e9:.1f} GFLOP "
        f"a forward (FlopCounterMode), bound {bound_ms:.3f} ms at the bf16 "
        f"peak, {flops / r['ms_per_step'] / 1e9:.1f} TFLOP/s achieved, "
        f"{100 * bound_ms / r['ms_per_step']:.2f}% of the peak  ({card})")
  gn_ms, bn_ms = recs["gn"]["ms_per_step"], recs["bn_affine"]["ms_per_step"]
  log(f"  a. GroupNorm's cost against the folded BatchNorm: "
      f"{gn_ms - bn_ms:.2f} ms of {gn_ms} ms "
      f"({100 * (gn_ms - bn_ms) / gn_ms:.1f}%)")
  assert launches == {n: 0 for n in kernels}, launches

  # b. one profiled run with gn: the top device kernels and the busy share
  t0 = time.perf_counter()
  with tempfile.TemporaryDirectory() as d:
    args = bench_forward.parse_args(
        argv[:2] + ["--iters", str(FWD_PROFILE_ITERS), "--profile",
                    f"{d}/trace"])
    rec, extra = bench_forward.run(args, "cuda")
    prof = extra["profile"]
    assert os.path.getsize(f"{d}/trace/trace.json") > 0
  assert prof["top"] and 0 < prof["busy"] <= 1.0, prof
  dev_ms = prof["total_ms"] / bench_forward.PROFILE_CALLS
  log(f"  b. profiled gn run: {json.dumps(rec)}; device busy "
      f"{100 * prof['busy']:.1f}% of {prof['wall_ms']:.1f} ms over "
      f"{bench_forward.PROFILE_CALLS} profiled calls; {dev_ms:.2f} ms of "
      f"device time and "
      f"{prof['launches'] / bench_forward.PROFILE_CALLS:.0f} kernels, "
      f"memsets and copies a forward, {100 * dev_ms / gn_ms:.1f}% of a.'s "
      f"unprofiled {gn_ms} ms/step; kernel time by class "
      f"{ {k: round(v, 3) for k, v in prof['by_class'].items()} } ms  "
      f"({card}); {time.perf_counter() - t0:.1f} s")

  # c. card against CPU at micro size, float32 (TF32 off)
  micro = bench_forward.parse_args(["--micro", "--no-bf16", "--batch", "2",
                                    "--iters", "1"])
  on_card = bench_forward.run(micro, "cuda")[1]["out"]
  on_cpu = bench_forward.run(micro, "cpu")[1]["out"]
  rel = abs(on_card - on_cpu) / abs(on_cpu)
  assert np.isfinite(on_card) and rel <= 1e-4, (on_card, on_cpu)
  log(f"  c. micro forward's output sum, card {on_card!r} vs CPU "
      f"{on_cpu!r}: {rel:.3g} relative (bar 1e-4)")

  # d. merge_seed_runs against the committed merged files
  with tempfile.TemporaryDirectory() as d:
    for bench in MERGED_RUNS:
      stem = f"results/{bench}_plant_r5_honest"
      out = f"{d}/{bench}.json"
      with contextlib.redirect_stdout(io.StringIO()) as buf:
        assert merge_seed_runs.main(
            [f"{stem}_seed{s}.json" for s in range(3)] + ["--out", out]) == 0
      got = json.loads(pathlib.Path(out).read_text())
      want = json.loads(pathlib.Path(f"{stem}.json").read_text())
      for k in ("_checkpoint", "values"):
        json_close(got[k], want[k], k, atol=1e-12, rtol=0.0)
      log(f"  d. {buf.getvalue().strip()} equals {stem}.json (_checkpoint, "
          f"values within 1e-12)")
  numbers = dict(gn_ms=gn_ms, bn_affine_ms=bn_ms, busy=prof["busy"],
                 flops=flops, bound_ms=bound_ms)
  return launches, numbers


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--profile", metavar="PATH",
                  help="write torch.profiler's tables of two ticks and one "
                       "train step here")
  args = ap.parse_args()

  if not torch.cuda.is_available():
    log("chip_smoke: torch.cuda.is_available() is False; this script runs "
        "only on an NVIDIA card")
    return 1

  from carla_garage_tpu_torch.config import DEFAULT_CONFIG
  from carla_garage_tpu_torch.eval import benchmark
  from carla_garage_tpu_torch.ops import bev_fill as ops_bev_fill
  from carla_garage_tpu_torch.ops import build, kernel_cases
  from carla_garage_tpu_torch.ops import raycast as ops_raycast
  from carla_garage_tpu_torch.scene_io import load_scene
  from carla_garage_tpu_torch.structs import tree_items

  # float32 comparisons below run without TF32 (matmuls and cuDNN convs)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  t_script = time.perf_counter()
  card = card_line()
  kind = torch.cuda.get_device_name(0)
  clock = PhaseClock()
  clock.start(f"card {card}; torch {torch.__version__} cuda "
              f"{torch.version.cuda}")
  t0 = time.perf_counter()
  texts = build.build_all()
  log(f"  built {sorted(texts)} in {time.perf_counter() - t0:.1f} s "
      f"(one nvcc per source, in parallel)")
  for name, text in texts.items():
    for line in text.splitlines():
      if "registers" in line or "spill" in line:
        log(f"  nvcc {name}: {line.strip()}")

  cfg = DEFAULT_CONFIG.replace(sim=dataclasses.replace(
      DEFAULT_CONFIG.sim, max_vehicles=100))
  maps, lanes, scene, state0 = load_scene(device="cuda")
  kernels = {"raycast_boxes": ops_raycast.raycast_boxes,
             "fill_boxes_bev": ops_bev_fill.fill_boxes}

  clock.start("tick reference, card vs CPU")
  small_reference_check(cfg, maps, lanes, scene, state0)
  clock.start("training reference, card vs CPU")
  small_train_reference(cfg, maps, lanes, scene, state0)

  clock.start("sensor-on tick, full width")
  state, start, tick_inputs, tick_launches = sensor_tick(
      cfg, maps, lanes, scene, state0, kernels, args, card)

  clock.start("expert datagen on the card")
  frames = datagen(cfg, maps, lanes, scene, state0, card)

  clock.start("training at full width")
  train_inputs, train_launches = train_full_width(
      cfg, maps, scene, frames, kernels, args, card)

  clock.start("kernels against their plain versions on the card")
  for name in build.KERNELS:
    log(f"  {name} SASS loops: {sass_loops(build.library_path(name))}")
  rc_err, rc_ms, rc_plain, n_bytes, n_flops = 0.0, 0.0, 0.0, 0, 0
  for label, inputs in zip(("camera", "lidar half sweep"), tick_inputs):
    err, ms, plain_ms = check_raycast(f"raycast_boxes[tick {label}]",
                                      inputs)
    by, fl = raycast_pairs(f"tick {label}", inputs)
    rc_err, rc_ms, rc_plain = max(rc_err, err), rc_ms + ms, \
        rc_plain + plain_ms
    n_bytes, n_flops = n_bytes + by, n_flops + fl
  rc_bound, rc_by = bound(n_bytes, n_flops)
  log(f"  one tick's two launches: {rc_ms:.4f} ms; bound {rc_bound:.4f} ms "
      f"by {rc_by} ({n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.3f} GFLOP); "
      f"plain {rc_plain:.3f} ms")
  tr_lidar = train_inputs["raycast"][1]
  err, ms, plain_ms = check_raycast("raycast_boxes[training full sweep]",
                                    tr_lidar)
  rc_err = max(rc_err, err)
  lb, lby = bound(*raycast_pairs("training full sweep", tr_lidar))
  log(f"  training LiDAR launch: {ms:.4f} ms; bound {lb:.4f} ms by {lby}; "
      f"plain {plain_ms:.3f} ms")
  rng = np.random.default_rng(0)
  o = torch.tensor(rng.uniform(-5, 5, (3, 3)), dtype=torch.float32)
  d = torch.nn.functional.normalize(torch.tensor(
      rng.normal(size=(3, 10007, 3)), dtype=torch.float32), dim=-1)
  bx = tick_inputs[0][2][:3].cpu().clone()
  bx[..., :2] = o[:, None, :2] + torch.tensor(
      rng.uniform(-30, 30, (3, bx.shape[1], 2)), dtype=torch.float32)
  err, _, _ = check_raycast("raycast_boxes[random, ragged N]",
                            tuple(x.cuda() for x in (o, d, bx)))
  rc_err = max(rc_err, err)
  for name, inputs in kernel_cases.raycast_cases().items():
    err, _, _ = check_raycast(f"raycast_boxes[{name}]",
                              tuple(x.cuda() for x in inputs), timed=False)
    rc_err = max(rc_err, err)

  boxes, h, w = train_inputs["fill"][0]
  fill_err, fill_ms, fill_plain = check_fill(
      "fill_boxes_bev[training]", boxes, h, w)
  f_bytes, f_flops, f_tests = ops_bev_fill.fill_boxes_bev_cost(boxes, h, w)
  fill_bound, fill_by = bound(f_bytes, f_flops)
  n_valid = int((boxes[..., 7] > 0).sum())
  kept = ops_bev_fill.fill_tile_candidates_plain(boxes, h, w)
  log(f"  training launch: {fill_ms:.4f} ms; bound {fill_bound:.6f} ms by "
      f"{fill_by} ({f_bytes / 1e6:.2f} MB; {f_tests} pixel-box tests in the "
      f"footprints of {n_valid} valid boxes, {f_flops / 1e6:.3f} MFLOP); "
      f"plain {fill_plain:.3f} ms; box-tile pairs kept by the cull "
      f"{int(kept.sum())} of {n_valid * kept.shape[2] * kept.shape[3]} "
      f"(valid boxes x {kept.shape[2] * kept.shape[3]} tiles), tiles that "
      f"keep none {int((~kept.any(1)).sum())} of "
      f"{kept.shape[0] * kept.shape[2] * kept.shape[3]}")
  V = 37
  cx = rng.uniform(-10, 338, (3, V))
  cy = rng.uniform(-10, 210, (3, V))
  cx[:, 1::4], cy[:, 1::4] = cx[:, 0:4 * 9:4], cy[:, 0:4 * 9:4]
  yaw = torch.tensor(rng.uniform(-np.pi, np.pi, (3, V)), dtype=torch.float32)
  f32 = lambda a: torch.tensor(a, dtype=torch.float32)
  ragged = ops_bev_fill.pack_boxes(
      f32(cx), f32(cy), torch.cos(yaw), torch.sin(yaw),
      f32(rng.uniform(2, 14, (3, V))), f32(rng.uniform(1, 7, (3, V))),
      torch.tensor(rng.integers(1, 11, (3, V))),
      torch.tensor(rng.uniform(size=(3, V)) > 0.25)).cuda()
  err, _, _ = check_fill("fill_boxes_bev[random, ragged 200x328, V=37]",
                         ragged, 200, 328)
  fill_err = max(fill_err, err)
  for name, (bx, h, w) in kernel_cases.fill_cases().items():
    err, _, _ = check_fill(f"fill_boxes_bev[{name}]", bx.cuda(), h, w,
                           timed=False)
    fill_err = max(fill_err, err)

  clock.start("scenario tick reference, card vs CPU")
  scenario_reference(cfg)

  clock.start("closed-loop evaluation with scenarios, full width")
  e_maps, e_lanes, e_scene, e_start, policy, eval_launches, eval_ticks = \
      closed_loop_eval(cfg, kernels, args, card)

  clock.start("DAgger datagen on the card")
  dagger_launches, dagger_ticks = dagger(cfg, e_maps, e_lanes, e_scene,
                                         e_start, policy, kernels, card)
  del policy

  clock.start("PlanT reference, card vs CPU")
  plant_reference(cfg)

  clock.start("PlanT datagen and dataset on the card")
  plant_ds = plant_datagen(cfg, e_maps, e_lanes, e_scene, e_start, card)

  clock.start("PlanT training at full width")
  plant_model, plant_train_launches = plant_train_full(cfg, plant_ds,
                                                       kernels, card)

  clock.start("PlanT closed-loop eval and DAgger")
  (plant_eval_launches, plant_eval_ticks, plant_dagger_launches,
   plant_dagger_ticks) = plant_eval_dagger(cfg, e_maps, e_lanes, e_scene,
                                           e_start, plant_model, plant_ds,
                                           kernels, card)

  clock.start("the sensor agent's operating points, full width")
  op_launches, op_ticks = op_points(cfg, maps, lanes, scene, state0, kernels,
                                    card)

  clock.start("bench.py's operating points on the port")
  bench_launches, bench_ticks, err = bench_points(kernels, card)
  rc_err = max(rc_err, err)

  clock.start("checkpoints: save and load at full width")
  checkpoints_round_trip()

  clock.start("train_plant end to end at plant_config()")
  plant_entry_launches = entry_plant(kernels, card)

  clock.start("dagger_ab end to end")
  dagger_ab_launches = entry_dagger_ab(kernels, card)

  assets = tempfile.TemporaryDirectory()
  root = f"{assets.name}/reference"
  os.environ["CGT_TOWN_CACHE"] = f"{assets.name}/town_cache"
  clock.start("imported towns: asset root, lane-graph recovery")
  imported_towns(root)

  clock.start("imported-town reference, card vs CPU")
  imported_reference(cfg, root)

  common = ["--honest", "--benchmarks", "longest6", "--max-ticks",
            str(CARLA_TICKS), "--results-dir", f"{assets.name}/results"]
  carla_launches, carla_ticks = {}, {}
  # phases 22-23 in one chunk of CARLA_TICKS, as the CPU tests patch it
  runner_chunk, benchmark.CARLA_CHUNK = benchmark.CARLA_CHUNK, CARLA_TICKS
  clock.start("run_benchmarks, the expert, one batch over Town01 and "
              "Town02")
  carla_launches["bench_carla_expert"], carla_ticks["bench_carla_expert"], \
      err = carla_benchmark(
          "bench_carla_expert", common + ["--single-batch", "--towns",
                                          "Town01", "Town02"],
          sum(IMPORTED_ROUTES.values()), 0, root, kernels, card)
  clock.start("run_benchmarks, the sensor agent at full width on Town01")
  ckpt = random_checkpoint(f"{assets.name}/tf_random")
  carla_launches["bench_carla_sensor"], carla_ticks["bench_carla_sensor"], \
      err = carla_benchmark(
          "bench_carla_sensor", common + [
              "--agent", "transfuser", "--checkpoint", ckpt, "--reps", "2",
              "--towns", "Town01"],
          2 * IMPORTED_ROUTES["Town01"], 2, root, kernels, card)
  rc_err = max(rc_err, err)
  benchmark.CARLA_CHUNK = runner_chunk

  clock.start("train_transfuser end to end at full width on Town01 and "
              "synth, then resumed")
  transfuser_entry_launches, err, f_err = entry_transfuser(kernels, card,
                                                           root)
  rc_err, fill_err = max(rc_err, err), max(fill_err, f_err)
  assets.cleanup()

  clock.start("the disk path's codecs on the card's machine")
  codecs(cfg, maps, scene, state0)

  disk = tempfile.TemporaryDirectory()
  clock.start("export to the reference layout at full width")
  export_launches, export_times = disk_export(cfg, maps, scene, frames,
                                              kernels, card, disk.name)

  clock.start("train_transfuser_from_disk at full width")
  disk_train_launches = disk_train(cfg, disk.name, kernels, card)
  disk.cleanup()

  clock.start("the remaining models at full width: AIM, the BEV encoder, "
              "R(2+1)D, Video Swin 3D, the TransFuser GRU head")
  models_launches = remaining_models(kernels, card)

  clock.start("a reference-layout TransFuser++ ensemble converted and "
              "served")
  ensemble_launches, ensemble_ticks = converted_ensemble(
      cfg, maps, lanes, scene, state0, kernels, card)

  clock.start("PlanT from a reference-layout state dict")
  plant_conv_launches = converted_plant(cfg, maps, lanes, scene, state0,
                                        kernels, card)

  clock.start("multi-GPU: dryrun_multichip(1) over NCCL; two ranks over "
              "gloo sharing the card: the micro step against one "
              "process, full-width DP training with ZeRO-1, the sharded "
              "sensor eval and expert")
  dp_launches, _ = multi_gpu(cfg, maps, lanes, scene, state0, frames,
                             kernels, card)

  clock.start("the remaining entry points: bench_forward at full spec with "
              "both norms, profiled, card vs CPU; merge_seed_runs")
  fwd_launches, _ = remaining_entry_points(kernels, card)

  clock.start("output")
  n_leaves = 0
  for path, x in tree_items(state):
    if x.dtype.is_floating_point:
      assert bool(torch.isfinite(x).all()), path
    n_leaves += 1
  ctl = state.agent.prev_control
  assert ctl.shape == (state.tick.shape[0], 3)
  assert bool(torch.isfinite(ctl).all())
  advanced = (state.tick > start.tick) | start.done
  assert bool(advanced.all()), (start.tick, state.tick)
  log(f"  {n_leaves} tick-state leaves finite; ticks {state.tick.tolist()}; "
      f"route completion max "
      f"{float(state.criteria.route_completion.max()):.4f}")
  by_path = {name: {"tick": tick_launches[name],
                    "train_step": train_launches[name],
                    "eval": eval_launches[name],
                    "dagger": dagger_launches[name],
                    "plant_eval": plant_eval_launches[name],
                    "plant_train": plant_train_launches[name],
                    "plant_dagger": plant_dagger_launches[name],
                    "op_points": op_launches[name],
                    "bench_object": bench_launches["bench_object"][name],
                    "bench_sensor_reduced":
                        bench_launches["bench_sensor_reduced"][name],
                    "entry_plant": plant_entry_launches[name],
                    "entry_dagger_ab": dagger_ab_launches[name],
                    "entry_transfuser": transfuser_entry_launches[name],
                    "bench_carla_expert":
                        carla_launches["bench_carla_expert"][name],
                    "bench_carla_sensor":
                        carla_launches["bench_carla_sensor"][name],
                    "disk_export": export_launches[name],
                    "disk_train": disk_train_launches[name],
                    "models_extra": models_launches[name],
                    "converted_ensemble": ensemble_launches[name],
                    "converted_plant": plant_conv_launches[name],
                    "dp_train": dp_launches["dp_train"][name],
                    "dp_eval": dp_launches["dp_eval"][name],
                    "bench_forward": fwd_launches[name]}
             for name in kernels}
  log(f"  launches: {by_path} (tick: {TICKS} ticks, train_step: "
      f"{TRAIN_STEPS} steps, eval: {eval_ticks} ticks, dagger: "
      f"{dagger_ticks} ticks, plant_eval: {plant_eval_ticks} ticks, "
      f"plant_train: {PLANT_STEPS} steps, plant_dagger: "
      f"{plant_dagger_ticks} ticks, op_points: {op_ticks} ticks, "
      f"bench_object: {bench_ticks['bench_object']} ticks, "
      f"bench_sensor_reduced: {bench_ticks['bench_sensor_reduced']} ticks, "
      f"bench_carla_expert: {carla_ticks['bench_carla_expert']} ticks, "
      f"bench_carla_sensor: {carla_ticks['bench_carla_sensor']} ticks, "
      f"disk_export: {EXPORT_FRAMES} frames, disk_train: {1 + DISK_STEPS} "
      f"steps, models_extra: 5 forwards, converted_ensemble: "
      f"{ensemble_ticks} ticks, converted_plant: {PLANT_CONVERTED_TICKS} "
      f"ticks, dp_train: {DP_TRAIN_STEPS} steps on each of {DP_RANKS} "
      f"ranks, dp_eval: {DP_EVAL_TICKS} ticks on each of {DP_RANKS} ranks, "
      f"bench_forward: 2 runs of {FWD_ITERS} timed forwards, entry_*: "
      f"whole runs)")
  (c_ms, c_plain, c_cost), (s_ms, s_plain, s_cost), (f_ms, f_plain,
                                                     f_cost) = (
      export_times[k] for k in ("camera", "sweep", "fill"))
  frame_bound = bound(c_cost[0] + 2 * s_cost[0], c_cost[1] + 2 * s_cost[1])
  log(f"  disk_export, a frame's kernels at its shapes: raycast_boxes "
      f"camera + 2 sweeps {c_ms + 2 * s_ms:.4f} ms (bound "
      f"{frame_bound[0]:.4f} ms by {frame_bound[1]}; plain "
      f"{c_plain + 2 * s_plain:.3f} ms), fill_boxes_bev {f_ms:.4f} ms "
      f"(bound {bound(*f_cost)[0]:.6f} ms by {bound(*f_cost)[1]}; plain "
      f"{f_plain:.3f} ms)")
  clock.stop()
  log(f"chip_smoke.py wall time {time.perf_counter() - t_script:.1f} s")

  log(card)
  log(json.dumps({"kernels": [
      {"name": "raycast_boxes", "route": "cuda",
       "source": "carla_garage_tpu_torch/csrc/raycast_boxes.cu",
       "replaces": "carla_garage_tpu/ops/pallas/raycast.py:85",
       "launches": sum(by_path["raycast_boxes"].values()),
       "launches_by_path": by_path["raycast_boxes"],
       "max_abs_err": rc_err, "ms": rc_ms, "plain_ms": rc_plain,
       "bound_ms": rc_bound, "bound_by": rc_by, "library_ms": None},
      {"name": "fill_boxes_bev", "route": "cuda",
       "source": "carla_garage_tpu_torch/csrc/fill_boxes_bev.cu",
       "replaces": "carla_garage_tpu/ops/pallas/bev_fill.py:53",
       "launches": sum(by_path["fill_boxes_bev"].values()),
       "launches_by_path": by_path["fill_boxes_bev"],
       "max_abs_err": fill_err, "ms": fill_ms, "plain_ms": fill_plain,
       "bound_ms": fill_bound, "bound_by": fill_by, "library_ms": None}]}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
