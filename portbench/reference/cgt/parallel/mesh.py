"""Device mesh and sharding helpers over ``torch.distributed`` ranks (port
of carla_garage_tpu/parallel/mesh.py).

The JAX package runs one controller over a ``dp`` mesh axis: every array
is global, and XLA inserts the all-reduces. PyTorch runs one process per
rank, so here each rank holds its own contiguous slice of the batch and
the collectives are explicit:

- ``shard_leading`` keeps the rank's slice of every batched leaf (JAX's
  sharded ``device_put``), ``replicate`` broadcasts rank 0's values (its
  replicated ``device_put``);
- ``global_sum`` all-reduces a detached count, so that a loss divided by
  it is the rank's share of the global loss; ``all_reduce_grads`` sums
  the ranks' gradients into the global gradient, and ``all_reduce_aux``
  the ranks' loss shares into the global losses;
- ``gather_records`` concatenates every rank's records in rank order,
  which is the global episode order;
- ``zero1_optimizer`` shards the AdamW state over the ranks with
  ``ZeroRedundancyOptimizer`` (the reference's own choice,
  train.py:527-531). Its per-parameter partition fills the role of the
  JAX package's per-leaf ``zero1_spec`` layout; AdamW is elementwise, so
  the update is the same.

Collectives on tensors are ``all_reduce`` and ``broadcast`` only, which
both NCCL and gloo take on CUDA tensors, so the same code runs over NCCL
(one rank a card) and over gloo (several ranks sharing one card, or CPU
processes). Records travel as Python objects. ``mesh=None`` everywhere
means one process and no collective.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from portbench.reference.cgt.structs import tree_map

GRAD_BUCKET_BYTES = 64 << 20     # gradients all-reduced per flat buffer


@dataclasses.dataclass(frozen=True)
class Mesh:
  """One rank's view of a 1-D data-parallel mesh."""
  group: object                  # the mesh axis' process group
  rank: int                      # this process' index on the axis
  size: int                      # ranks on the axis
  device: torch.device           # where this rank's tensors live


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              device=None) -> Mesh:
  """The mesh over every rank of the initialized default process group,
  built with ``init_device_mesh`` (its one dimension named `axis`).
  n_devices, when given, must equal the world size. device: this rank's
  device (default: the current card when one is present, else the
  CPU)."""
  from torch.distributed.device_mesh import init_device_mesh
  if not dist.is_initialized():
    raise RuntimeError("make_mesh needs an initialized process group "
                       "(parallel.launch.spawn starts one per rank)")
  world = dist.get_world_size()
  n = n_devices or world
  if n != world:
    raise ValueError(f"a mesh of {n} devices in a world of {world} ranks")
  if device is None:
    device = (f"cuda:{torch.cuda.current_device()}"
              if torch.cuda.is_available() else "cpu")
  dev = torch.device(device)
  dm = init_device_mesh(dev.type, (n,), mesh_dim_names=(axis,))
  return Mesh(group=dm.get_group(axis), rank=dist.get_rank(), size=n,
              device=dev)


def shard_slice(mesh: Mesh, batch: int) -> slice:
  """The rank's contiguous rows [r*B/n, (r+1)*B/n) of a batch of B."""
  if batch % mesh.size:
    raise ValueError(f"a batch of {batch} does not split over "
                     f"{mesh.size} ranks")
  n = batch // mesh.size
  return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_leading(mesh: Mesh, tree, batch: int, dim: int = 0):
  """The rank's slice of every tensor leaf whose dimension `dim` has size
  `batch`; every other leaf whole (JAX's heuristic: a leaf of another
  size is replicated). dim=1 shards [T,B,...] time-major leaves such as
  recorded frames."""
  s = shard_slice(mesh, batch)
  index = (slice(None),) * dim + (s,)

  def put(x):
    if x.ndim > dim and x.shape[dim] == batch:
      return x[index]
    return x

  return tree_map(put, tree)


def replicate(mesh: Mesh, tree):
  """Broadcast every tensor leaf from rank 0, in place: every rank then
  holds rank 0's values. Returns the tree."""
  src = dist.get_global_rank(mesh.group, 0)

  def bcast(x):
    buf = x if x.is_contiguous() else x.contiguous()
    dist.broadcast(buf, src=src, group=mesh.group)
    if buf is not x:
      x.copy_(buf)
    return x

  with torch.no_grad():
    return tree_map(bcast, tree)


def global_sum(mesh: Mesh | None, x: torch.Tensor) -> torch.Tensor:
  """The sum of a detached count over the ranks (x itself without a
  mesh). Counts of labels and weights carry no gradient."""
  if mesh is None:
    return x
  y = x.detach().clone()
  dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
  return y


def share_mean(mesh: Mesh | None, x: torch.Tensor) -> torch.Tensor:
  """The rank's share of the mean over the global batch: the shards have
  equal sizes, so it is the local mean over the rank count."""
  m = torch.mean(x)
  return m if mesh is None else m / mesh.size


def all_reduce_grads(mesh: Mesh, params) -> None:
  """Sum the ranks' gradients in place, in flat buffers of at most
  GRAD_BUCKET_BYTES per dtype. Every rank holds the same parameters with
  gradients (one model and one graph), so the buffers line up."""
  grads = [p.grad for p in params if p.grad is not None]
  buckets, cur, size = [], [], 0
  for g in grads:
    nbytes = g.numel() * g.element_size()
    if cur and (size + nbytes > GRAD_BUCKET_BYTES or g.dtype != cur[0].dtype
                or g.device != cur[0].device):
      buckets.append(cur)
      cur, size = [], 0
    cur.append(g)
    size += nbytes
  if cur:
    buckets.append(cur)
  for bucket in buckets:
    flat = torch.cat([g.reshape(-1) for g in bucket])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
      g.copy_(part.view_as(g))


def all_reduce_aux(mesh: Mesh | None, aux: dict) -> dict:
  """The ranks' loss shares summed into the global losses, in one
  all-reduce of the stacked scalars."""
  if mesh is None or not aux:
    return aux
  keys = list(aux)
  flat = torch.stack([aux[k].detach().to(torch.float32).reshape(())
                      for k in keys])
  dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
  return dict(zip(keys, flat.unbind()))


def gather_objects(mesh: Mesh, obj) -> list:
  """Every rank's object, in rank order (through the CPU under gloo)."""
  out = [None] * mesh.size
  dist.all_gather_object(out, obj, group=mesh.group)
  return out


def gather_shards(mesh: Mesh, tree, dim: int = 0):
  """The whole batch from every rank's slice: each tensor leaf
  concatenated over the ranks along `dim` (through the CPU), back on the
  leaf's device."""
  parts = gather_objects(mesh, tree_map(lambda x: x.cpu(), tree))
  return tree_map(lambda x, *xs: torch.cat(xs, dim).to(x.device), tree,
                  *parts)


def gather_records(mesh: Mesh | None, records: list) -> list:
  """Every rank's records in global episode order: the shards are
  contiguous, so rank order is episode order."""
  if mesh is None:
    return list(records)
  return [r for part in gather_objects(mesh, list(records)) for r in part]


def zero1_optimizer(mesh: Mesh, params, **adamw):
  """AdamW with its state sharded over the ranks (ZeRO-1): each rank
  keeps the moments of its partition of the parameters, steps them and
  broadcasts them to the others."""
  from torch.distributed.optim import ZeroRedundancyOptimizer
  return ZeroRedundancyOptimizer(list(params),
                                 optimizer_class=torch.optim.AdamW,
                                 process_group=mesh.group, **adamw)


def optimizer_state_bytes(optimizer) -> int:
  """The bytes of optimizer state this rank holds (the local partition
  of a ZeRO optimizer)."""
  inner = getattr(optimizer, "optim", optimizer)
  return sum(v.numel() * v.element_size() for st in inner.state.values()
             for v in st.values() if torch.is_tensor(v))
