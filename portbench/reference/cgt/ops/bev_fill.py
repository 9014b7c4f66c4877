"""Oriented-box rasterization into the BEV grid: the plain version only
(``fill_boxes`` runs it on every device in the frozen reference;
``fill_boxes_bev_cost`` is the benchmark's count of B2's bytes and
operations).

Port of carla_garage_tpu/ops/pallas/bev_fill.py ``fill_boxes_bev``. The
kernel is ``csrc/fill_boxes_bev.cu`` (its header says what bounds it on an
H100 and what its design does about that). Boxes are packed as [B,V,8]
rows of cx, cy, cos, sin, ex, ey, cls, valid in grid-pixel units (x =
column, y = row; ex, ey half-sizes). ``cos`` and ``sin`` are computed
outside the kernel, as the JAX package does, so that a test can feed in
the reference's own values: one ulp of difference flips edge pixels.
"""

from __future__ import annotations

import torch

NFIELDS = 8
# floating-point operations of one pixel-box test, for the bound that
# chip_smoke.py reports: dx, dy (2 subtractions) and the rotation
# c*dx + s*dy, -s*dx + c*dy with -s taken once per box (4 multiplies, 2
# adds); the absolute values are free operand modifiers of the compares
TEST_FLOPS = 8
# the kernel's tiles and its footprint margins (csrc/fill_boxes_bev.cu
# kTileH, kTileW, kGrow, kRel; they must be equal)
TILE_H, TILE_W = 16, 64
CULL_GROW = 1.00001
CULL_REL = 1e-5


def pack_boxes(cx, cy, cs, sn, ex, ey, cls, valid) -> torch.Tensor:
  """[B,V] box fields -> the kernel's [B,V,8] float32 layout."""
  return torch.stack([cx, cy, cs, sn, ex, ey, cls.to(torch.float32),
                      valid.to(torch.float32)], -1).to(torch.float32)


def _box_masks(boxes: torch.Tensor, h: int, w: int):
  """For each box in order: its [B,h,w] bool mask of the pixels it holds
  (the exact test in the kernel's fp32 order; invalid boxes hold none),
  and its class [B,1,1] int32."""
  dev = boxes.device
  rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
  cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
  for v in range(boxes.shape[1]):
    cx, cy, c, s, ex, ey, cls, valid = (boxes[:, v, i, None, None]
                                        for i in range(NFIELDS))
    dx = cols[None] - cx
    dy = rows[None] - cy
    lx = c * dx + s * dy
    ly = -s * dx + c * dy
    yield (torch.abs(lx) <= ex) & (torch.abs(ly) <= ey) & (valid > 0), \
        cls.to(torch.int32)


def fill_boxes_bev_plain(boxes: torch.Tensor, h: int, w: int):
  """Plain PyTorch version (the JAX package's fill_boxes_bev_reference):
  one [B,h,w] elementwise pass per box in order, later boxes overwriting
  earlier ones, in the kernel's order of operations. boxes [B,V,8] ->
  [B,h,w] uint8."""
  out = torch.zeros((boxes.shape[0], h, w), dtype=torch.int32,
                    device=boxes.device)
  for inside, cls in _box_masks(boxes, h, w):
    out = torch.where(inside, cls, out)
  return out.to(torch.uint8)


def fill_hits_plain(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
  """[B,V,h,w] bool: the (box, pixel) pairs the exact test accepts."""
  masks = [m for m, _ in _box_masks(boxes, h, w)]
  return torch.stack(masks, 1) if masks else torch.zeros(
      (boxes.shape[0], 0, h, w), dtype=torch.bool, device=boxes.device)


def fill_tile_candidates_plain(boxes: torch.Tensor, h: int, w: int):
  """[B,V,tiles_y,tiles_x] bool: the (box, tile) pairs the kernel's
  footprint cull keeps, in its fp32 operations (csrc/fill_boxes_bev.cu
  derives the margins), for its TILE_H x TILE_W tiles. Used by the tests,
  which hold it against ``fill_hits_plain``, and by chip_smoke.py; the
  main path does not call it."""
  dev = boxes.device
  x0 = torch.arange(0, w, TILE_W, device=dev).to(torch.float32)
  y0 = torch.arange(0, h, TILE_H, device=dev).to(torch.float32)
  first_col, last_col = x0, torch.clamp(x0 + TILE_W, max=w) - 1
  first_row, last_row = y0, torch.clamp(y0 + TILE_H, max=h) - 1
  cx, cy, c, s, ex, ey = (boxes[..., i, None, None] for i in range(6))
  kk = c * c + s * s
  ac, as_, aex, aey = (torch.abs(x) for x in (c, s, ex, ey))
  slack = CULL_REL * (aex + aey)
  ax = (ac * aex + as_ * aey) * CULL_GROW
  ax = (ax + slack) / kk + 1.0
  ay = (as_ * aex + ac * aey) * CULL_GROW
  ay = (ay + slack) / kk + 1.0
  drop = (cx - ax > last_col) | (cx + ax < first_col) | \
      (cy - ay > last_row[:, None]) | (cy + ay < first_row[:, None])
  cull = (kk >= 0.5) & (kk <= 2.0)
  return (boxes[..., 7, None, None] > 0) & ~(cull & drop)


def fill_boxes(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
  """boxes [B,V,8] f32 packed by ``pack_boxes`` -> [B,h,w] uint8 class
  map: the plain version on every device (the reference has no kernel)."""
  return fill_boxes_bev_plain(boxes, h, w)


def fill_boxes_bev(cx, cy, yaw, ex, ey, cls, valid, h: int = 256,
                   w: int = 256) -> torch.Tensor:
  """The JAX signature: box fields [B,V] in grid-pixel units (yaw in
  radians, cls int, valid bool) -> [B,h,w] uint8."""
  boxes = pack_boxes(cx, cy, torch.cos(yaw), torch.sin(yaw), ex, ey, cls,
                     valid)
  return fill_boxes(boxes.contiguous(), h, w)


def fill_boxes_bev_cost(boxes: torch.Tensor, h: int, w: int):
  """(bytes, flops, tests) the function must spend on these boxes: the box
  array read once and the uint8 map written once; a test of each valid
  box against the grid pixels of its footprint, the box's axis-aligned
  extent (half-sizes |c|*ex + |s|*ey and |s|*ex + |c|*ey) widened to
  whole pixels and clipped to the grid. No pixel outside its footprint can
  lie in a box, so a box off the grid needs no test. Pixels that a later
  box already holds are counted again: the tests are an upper estimate,
  which can only raise the bound, and the bound is exact wherever the
  bytes decide it."""
  B, V, _ = boxes.shape
  n_bytes = 4 * B * V * NFIELDS + B * h * w
  b = boxes.double()
  cx, cy, c, s, ex, ey = (b[..., i] for i in range(6))
  ax = c.abs() * ex + s.abs() * ey
  ay = s.abs() * ex + c.abs() * ey

  def span(lo, hi, n):
    lo = torch.floor(lo).clamp(0, n)
    hi = torch.ceil(hi).clamp(-1, n - 1)
    return (hi - lo + 1).clamp(min=0)

  area = span(cx - ax, cx + ax, w) * span(cy - ay, cy + ay, h)
  tests = int(torch.where(b[..., 7] > 0, area, 0.0).sum())
  return n_bytes, tests * TEST_FLOPS, tests
