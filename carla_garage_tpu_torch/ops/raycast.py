"""Ray vs box-set intersection: the CUDA kernel's wrapper and its plain version.

Port of carla_garage_tpu/ops/pallas/raycast.py ``raycast_boxes``. The
kernel is ``csrc/raycast_boxes.cu`` (its header says what bounds it on an
H100 and what its design does about that). Box model: upright oriented
boxes standing on the ground, z in [0, 2*ez]; box fields
cx, cy, cos, sin, ex, ey, ez, cls, valid.
"""

from __future__ import annotations

import ctypes

import torch

from carla_garage_tpu_torch.utils.profiling import span

NFIELDS = 9
MISS_T = 1e9
# floating-point operations the function needs, for the bound that
# ``raycast_boxes_cost`` counts. Per ray and box: the ray's rotation into
# the box frame (6), three slabs (guard, two divisions, min, max: 5 each =
# 15), the entry/exit reductions (4), the hit test and selection (5). Per
# box and episode, whatever the ray: the origin in the box frame (px, py, lx, ly
# with -sin, lz: 10) and the slab numerators -e-p, e-p of three axes (9).
RAY_BOX_FLOPS = 30
BOX_FLOPS = 19
# the kernel's cull (csrc/raycast_boxes.cu, which derives them): the planar
# rule only for rays with |(dx, dy)| >= CULL_MIN_PLANAR, and the disc radius
# R' = (R * CULL_GROW + CULL_REL * |q| + CULL_ABS) / |(cos, sin)|. They must
# equal the source's kMinPlanar, kGrow, kRel and kAbs.
CULL_MIN_PLANAR = 0.01
CULL_GROW = 1.00001
CULL_REL = 1e-5
CULL_ABS = 1e-3


def _box_tests(origins: torch.Tensor, dirs: torch.Tensor,
               boxes: torch.Tensor):
  """For each box slot in order: (hit [B,N] bool, t_hit [B,N] f32, cls
  [B,1] int32), the exact ray-box test in the kernel's fp32 order of
  operations (invalid boxes hit nothing)."""
  dx, dy, dz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
  ox, oy, oz = (origins[:, i:i + 1].to(torch.float32) for i in range(3))

  def slab(p, r, e):
    r_safe = torch.where(torch.abs(r) < 1e-9, 1e-9, r)
    ta = (-e - p) / r_safe
    tb = (e - p) / r_safe
    return torch.minimum(ta, tb), torch.maximum(ta, tb)

  for v in range(boxes.shape[1]):
    bx = boxes[:, v].to(torch.float32)
    cx, cy, cs, sn, ex, ey, ez = (bx[:, i:i + 1] for i in range(7))
    valid = bx[:, 8:9] > 0
    px = ox - cx
    py = oy - cy
    lx = cs * px + sn * py
    ly = -sn * px + cs * py
    lz = oz - ez
    rdx = cs * dx + sn * dy
    rdy = -sn * dx + cs * dy
    tx0, tx1 = slab(lx, rdx, ex)
    ty0, ty1 = slab(ly, rdy, ey)
    tz0, tz1 = slab(lz, dz, ez)
    tmin = torch.maximum(torch.maximum(tx0, ty0), tz0)
    tmax = torch.minimum(torch.minimum(tx1, ty1), tz1)
    hit = (tmax >= tmin) & (tmax > 0) & valid
    yield hit, torch.where(tmin > 0, tmin, tmax), bx[:, 7:8].to(torch.int32)


def raycast_boxes_plain(origins: torch.Tensor, dirs: torch.Tensor,
                        boxes: torch.Tensor):
  """Plain PyTorch version: loops over the K boxes doing [B,N] elementwise
  work, in the kernel's order of operations and with its tie-break (a box
  replaces the best only when strictly nearer). Never builds [B,N,K].

  origins [B,3], dirs [B,N,3], boxes [B,K,9] -> (t [B,N] f32, 1e9 = miss;
  cls [B,N] int32)."""
  B, N, _ = dirs.shape
  t_best = torch.full((B, N), MISS_T, dtype=torch.float32,
                      device=dirs.device)
  c_best = torch.zeros((B, N), dtype=torch.int32, device=dirs.device)
  for hit, t_hit, cls_v in _box_tests(origins, dirs, boxes):
    closer = hit & (t_hit < t_best)
    t_best = torch.where(closer, t_hit, t_best)
    c_best = torch.where(closer, cls_v, c_best)
  return t_best, c_best


def raycast_hits_plain(origins: torch.Tensor, dirs: torch.Tensor,
                       boxes: torch.Tensor) -> torch.Tensor:
  """[B,N,K] bool: the (ray, box) pairs the exact test accepts."""
  B, N, _ = dirs.shape
  hits = [h for h, _, _ in _box_tests(origins, dirs, boxes)]
  return torch.stack(hits, -1) if hits else \
      torch.zeros((B, N, 0), dtype=torch.bool, device=dirs.device)


def raycast_candidates_plain(origins: torch.Tensor, dirs: torch.Tensor,
                             boxes: torch.Tensor) -> torch.Tensor:
  """[B,N,K] bool: the (ray, box) pairs the kernel's cull lets through to
  the exact test, in the kernel's fp32 operations (a valid box that
  neither rule (a) nor rule (b) of csrc/raycast_boxes.cu skips). Used by
  the tests, which hold it against ``raycast_hits_plain``; the main path
  does not call it."""
  B, N, _ = dirs.shape
  dx, dy, dz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
  ox, oy, oz = (origins[:, i:i + 1].to(torch.float32) for i in range(3))
  length = torch.sqrt(dx * dx + dy * dy)
  planar = length >= CULL_MIN_PLANAR
  rising = dz >= 0
  out = []
  for v in range(boxes.shape[1]):
    bx = boxes[:, v].to(torch.float32)
    cx, cy, cs, sn, ex, ey, ez = (bx[:, i:i + 1] for i in range(7))
    px = ox - cx
    py = oy - cy
    lz = oz - ez
    above = ((-ez - lz) < 0) & ((ez - lz) < 0)
    kk = cs * cs + sn * sn
    r = torch.sqrt(ex * ex + ey * ey)
    q = torch.sqrt(px * px + py * py)
    reach_r = torch.where((kk >= 0.25) & (kk <= 4.0),
                          (r * CULL_GROW + CULL_REL * q + CULL_ABS)
                          / torch.sqrt(kk), torch.inf)
    qx, qy = -px, -py
    cross = qx * dy - qy * dx
    dot = qx * dx + qy * dy
    reach = reach_r * length
    skip = (planar & ((torch.abs(cross) > reach) | (dot < -reach))) | \
        (rising & above)
    out.append((bx[:, 8:9] > 0) & ~skip)
  return torch.stack(out, -1) if out else \
      torch.zeros((B, N, 0), dtype=torch.bool, device=dirs.device)


_LAUNCH = None


def _launcher():
  """The kernel's C entry point, built and typed on first use."""
  global _LAUNCH
  if _LAUNCH is None:
    from carla_garage_tpu_torch.ops.build import load_kernel
    fn = load_kernel("raycast_boxes").raycast_boxes_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _LAUNCH = fn
  return _LAUNCH


def raycast_boxes(origins: torch.Tensor, dirs: torch.Tensor,
                  boxes: torch.Tensor):
  """origins [B,3] f32, dirs [B,N,3] f32, boxes [B,K,9] f32 ->
  (t [B,N] f32 with 1e9 = miss, cls [B,N] int32).

  On CUDA tensors it launches the kernel on the current stream (and counts
  the launch in ``raycast_boxes.launches``) or raises; on CPU tensors it
  runs ``raycast_boxes_plain``. Any N works: there is no tile padding."""
  with span("ops.raycast_boxes"):
    if dirs.device.type == "cpu":
      return raycast_boxes_plain(origins, dirs, boxes)
    if dirs.device.type != "cuda":
      raise ValueError(f"raycast_boxes: unsupported device {dirs.device}")
    B, N, three = dirs.shape
    K = boxes.shape[1]
    if three != 3 or tuple(origins.shape) != (B, 3) or \
        tuple(boxes.shape) != (B, K, NFIELDS):
      raise ValueError(f"raycast_boxes: shapes origins "
                       f"{tuple(origins.shape)}, dirs {tuple(dirs.shape)}, "
                       f"boxes "
                       f"{tuple(boxes.shape)} do not match [B,3], [B,N,3], "
                       f"[B,K,{NFIELDS}]")
    for name, x in (("origins", origins), ("dirs", dirs), ("boxes", boxes)):
      if x.device != dirs.device:
        raise ValueError(f"raycast_boxes: {name} on {x.device}, dirs on "
                         f"{dirs.device}")
      if x.dtype != torch.float32:
        raise TypeError(f"raycast_boxes: {name} is {x.dtype}, needs float32")
      if not x.is_contiguous():
        raise ValueError(f"raycast_boxes: {name} is not contiguous")
    t = torch.empty((B, N), dtype=torch.float32, device=dirs.device)
    cls = torch.empty((B, N), dtype=torch.int32, device=dirs.device)
    if B == 0 or N == 0:
      return t, cls
    fn = _launcher()
    with torch.cuda.device(dirs.device):
      stream = torch.cuda.current_stream(dirs.device).cuda_stream
      err = fn(origins.data_ptr(), dirs.data_ptr(), boxes.data_ptr(),
               t.data_ptr(), cls.data_ptr(), B, N, K, stream)
    if err != 0:
      raise RuntimeError(f"raycast_boxes kernel launch failed: CUDA error "
                         f"{err}")
    raycast_boxes.launches += 1
    return t, cls


raycast_boxes.launches = 0


def raycast_boxes_cost(origins: torch.Tensor, dirs: torch.Tensor,
                       boxes: torch.Tensor):
  """(bytes, flops, valid pairs, footprint pairs) the function must spend on
  these inputs: each input read once and each output written once; one
  ray-box test for each (ray, valid box) pair whose planar half-line from
  the origin meets the box's footprint rectangle or starts inside it (no
  other pair can hit: the test's x and y slabs are that footprint), and
  each valid box's ray-independent terms once. The pairs are counted in
  float64 from the inputs, independent of any kernel; ``valid pairs`` is
  the brute-force count, N times the valid boxes."""
  B, N, _ = dirs.shape
  K = boxes.shape[1]
  n_bytes = 4 * (B * 3 + B * N * 3 + B * K * NFIELDS + 2 * B * N)
  n_valid = int((boxes[..., 8] > 0).sum())
  d = dirs.double()
  dx, dy = d[..., 0], d[..., 1]
  ox, oy = (origins[:, i:i + 1].double() for i in range(2))

  def interval(p, r, e):
    """t >= -inf with |p + t r| <= e: [lo, hi] (empty when lo > hi)."""
    moving = r != 0
    r1 = torch.where(moving, r, 1.0)
    ta, tb = (-e - p) / r1, (e - p) / r1
    inside = torch.abs(p) <= e
    lo = torch.where(moving, torch.minimum(ta, tb),
                     torch.where(inside, -torch.inf, torch.inf))
    hi = torch.where(moving, torch.maximum(ta, tb),
                     torch.where(inside, torch.inf, -torch.inf))
    return lo, hi

  footprint = 0
  for v in range(K):
    bx = boxes[:, v].double()
    cx, cy, cs, sn, ex, ey = (bx[:, i:i + 1] for i in range(6))
    px, py = ox - cx, oy - cy
    x_lo, x_hi = interval(cs * px + sn * py, cs * dx + sn * dy, ex)
    y_lo, y_hi = interval(-sn * px + cs * py, -sn * dx + cs * dy, ey)
    lo = torch.clamp(torch.maximum(x_lo, y_lo), min=0.0)
    meets = (lo <= torch.minimum(x_hi, y_hi)) & (bx[:, 8:9] > 0)
    footprint += int(meets.sum())
  flops = footprint * RAY_BOX_FLOPS + n_valid * BOX_FLOPS
  return n_bytes, flops, n_valid * N, footprint
