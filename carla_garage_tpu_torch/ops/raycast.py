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

NFIELDS = 9
MISS_T = 1e9
# floating-point operations the function needs, for the bound that
# chip_smoke.py reports. Per ray and box: the ray's rotation into the box
# frame (6), three slabs (guard, two divisions, min, max: 5 each = 15), the
# entry/exit reductions (4), the hit test and selection (5). Per box and
# episode, whatever the ray: the origin in the box frame (px, py, lx, ly
# with -sin, lz: 10) and the slab numerators -e-p, e-p of three axes (9).
RAY_BOX_FLOPS = 30
BOX_FLOPS = 19


def raycast_boxes_plain(origins: torch.Tensor, dirs: torch.Tensor,
                        boxes: torch.Tensor):
  """Plain PyTorch version: loops over the K boxes doing [B,N] elementwise
  work, in the kernel's order of operations and with its tie-break (a box
  replaces the best only when strictly nearer). Never builds [B,N,K].

  origins [B,3], dirs [B,N,3], boxes [B,K,9] -> (t [B,N] f32, 1e9 = miss;
  cls [B,N] int32)."""
  B, N, _ = dirs.shape
  dx, dy, dz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
  ox, oy, oz = (origins[:, i:i + 1].to(torch.float32) for i in range(3))
  t_best = torch.full((B, N), MISS_T, dtype=torch.float32,
                      device=dirs.device)
  c_best = torch.zeros((B, N), dtype=torch.int32, device=dirs.device)

  def slab(p, r, e):
    r_safe = torch.where(torch.abs(r) < 1e-9, 1e-9, r)
    ta = (-e - p) / r_safe
    tb = (e - p) / r_safe
    return torch.minimum(ta, tb), torch.maximum(ta, tb)

  for v in range(boxes.shape[1]):
    bx = boxes[:, v].to(torch.float32)
    cx, cy, cs, sn, ex, ey, ez = (bx[:, i:i + 1] for i in range(7))
    cls_v = bx[:, 7:8].to(torch.int32)
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
    t_hit = torch.where(tmin > 0, tmin, tmax)
    closer = hit & (t_hit < t_best)
    t_best = torch.where(closer, t_hit, t_best)
    c_best = torch.where(closer, cls_v, c_best)
  return t_best, c_best


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
  if dirs.device.type == "cpu":
    return raycast_boxes_plain(origins, dirs, boxes)
  if dirs.device.type != "cuda":
    raise ValueError(f"raycast_boxes: unsupported device {dirs.device}")
  B, N, three = dirs.shape
  K = boxes.shape[1]
  if three != 3 or tuple(origins.shape) != (B, 3) or \
      tuple(boxes.shape) != (B, K, NFIELDS):
    raise ValueError(f"raycast_boxes: shapes origins {tuple(origins.shape)}"
                     f", dirs {tuple(dirs.shape)}, boxes "
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


def raycast_boxes_cost(N: int, boxes: torch.Tensor):
  """(bytes, flops) the function must spend on these inputs: each input
  read once and each output written once; one ray-box test per ray and
  VALID box of its episode (invalid boxes need no test), and each valid
  box's ray-independent terms once."""
  B, K, _ = boxes.shape
  n_bytes = 4 * (B * 3 + B * N * 3 + B * K * NFIELDS + 2 * B * N)
  n_valid = int((boxes[..., 8] > 0).sum())
  return n_bytes, n_valid * (N * RAY_BOX_FLOPS + BOX_FLOPS)
