"""Start data-parallel ranks as processes (port-only: the JAX package runs
one controller over its mesh).

``spawn(fn, world_size, backend, device, *args)`` starts `world_size`
processes with the ``spawn`` start method (a caller that has initialized
CUDA must not fork), joins them into one process group through a
``file://`` store in a temporary directory (no TCP port to fight over),
builds each rank's ``Mesh`` and calls ``fn(mesh, *args)`` there. It
returns the ranks' results in rank order, moved to the CPU.

- Each rank runs on ``cuda:{rank % device_count}``, or on the CPU when
  `device` names it. NCCL takes one rank a card: ``backend="nccl"`` with
  more ranks than cards raises (gloo runs several ranks on one card).
- A rank that raises makes ``spawn`` raise in the caller, with the rank's
  traceback. ``init_process_group`` gets TIMEOUT_S, so a rank stuck in a
  collective fails within it; ``spawn`` stops every rank still running
  once the run has taken TIMEOUT_S beyond start-up.
- `fn` is pickled by its import path: it lives in a module that a fresh
  interpreter can import (the port's workers live in the port package).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import torch

TIMEOUT_S = 600.0


def rank_device(rank: int, device="cuda") -> torch.device:
  """The device of a rank: the CPU when asked for, else the card
  ``rank % device_count``."""
  dev = torch.device(device)
  if dev.type == "cpu":
    return dev
  n = torch.cuda.device_count()
  if n == 0:
    raise RuntimeError(f"device {device!r} requested but no card is "
                       "present; pass device='cpu' to run on the CPU")
  return torch.device("cuda", rank % n)


def check_backend(backend: str, world_size: int, device) -> None:
  """Raise where the backend cannot run the ranks: NCCL needs a card per
  rank."""
  if backend != "nccl":
    return
  if torch.device(device).type != "cuda":
    raise ValueError("backend 'nccl' runs on cards only; use backend="
                     "'gloo' on the CPU")
  n = torch.cuda.device_count()
  if world_size > n:
    raise ValueError(
        f"backend 'nccl' needs one card per rank: {world_size} ranks, "
        f"{n} card(s); use backend='gloo' to run several ranks on one card")


def _rank_main(rank, fn, world_size, backend, device, store, out_dir,
               threads, args):
  import torch.distributed as dist
  from carla_garage_tpu_torch.parallel.mesh import make_mesh
  from carla_garage_tpu_torch.structs import tree_map
  if threads:
    torch.set_num_threads(threads)
  dev = rank_device(rank, device)
  if dev.type == "cuda":
    torch.cuda.set_device(dev)
  dist.init_process_group(backend, init_method=f"file://{store}",
                          world_size=world_size, rank=rank,
                          timeout=datetime.timedelta(seconds=TIMEOUT_S))
  try:
    out = fn(make_mesh(world_size, device=dev), *args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
      pickle.dump(tree_map(lambda x: x.detach().cpu(), out), f)
  finally:
    dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str | None = None, device="cuda",
          *args, tmpdir: str | None = None, threads: int | None = None):
  """Run ``fn(mesh, *args)`` on `world_size` ranks; their results in rank
  order. backend: "nccl" or "gloo" (default: NCCL on cards, gloo on the
  CPU). tmpdir: where the rendezvous store and the results go (a new
  temporary directory by default). threads: torch's thread count in each
  rank (unchanged when None)."""
  import torch.multiprocessing as mp
  backend = backend or ("nccl" if torch.device(device).type == "cuda"
                        else "gloo")
  check_backend(backend, world_size, device)
  with tempfile.TemporaryDirectory(dir=tmpdir, prefix="ranks_") as d:
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, backend, device,
                          os.path.join(d, "store"), d, threads, args),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S + 120.0
    try:
      while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
          raise TimeoutError(f"{world_size} ranks still running after "
                             f"{TIMEOUT_S + 120.0:.0f} s")
    finally:
      for p in ctx.processes:
        if p.is_alive():
          p.terminate()
          p.join(10)
    out = []
    for r in range(world_size):
      with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
        out.append(pickle.load(f))
  return out
