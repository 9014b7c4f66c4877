"""The two kernels' culls are conservative: on the CPU, with no card.

``raycast_boxes`` and ``fill_boxes_bev`` skip the (ray, box) and (tile,
box) pairs that cannot pass the exact test, and keep that test's fp32
arithmetic for the pairs they do not skip, so that each kernel equals its
plain version bit for bit. Each cull has a plain fp32 mirror beside its
plain version; these tests require the mirror to admit every pair the
exact test accepts, on seeded random and adversarial inputs
(``ops/kernel_cases.py``), and check the recounted bound of
``raycast_boxes``. The kernels themselves run in
``tests/test_torch_port_cuda.py`` on the card.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from carla_garage_tpu_torch.ops import bev_fill, kernel_cases, raycast

CSRC = pathlib.Path(raycast.__file__).resolve().parents[1] / "csrc"
RAY_CASES = kernel_cases.raycast_cases()
FILL_CASES = kernel_cases.fill_cases()


def _source_constant(name, source):
  m = re.search(rf"\b{name} = ([-+0-9.e]+)f;", (CSRC / source).read_text())
  assert m, name
  return np.float32(m.group(1))


def test_mirror_constants_equal_the_kernel_sources():
  for name, value in (("kMinPlanar", raycast.CULL_MIN_PLANAR),
                      ("kGrow", raycast.CULL_GROW),
                      ("kRel", raycast.CULL_REL),
                      ("kAbs", raycast.CULL_ABS)):
    assert _source_constant(name, "raycast_boxes.cu") == np.float32(value)
  for name, value in (("kGrow", bev_fill.CULL_GROW),
                      ("kRel", bev_fill.CULL_REL)):
    assert _source_constant(name, "fill_boxes_bev.cu") == np.float32(value)
  src = (CSRC / "fill_boxes_bev.cu").read_text()
  assert f"kTileW = {bev_fill.TILE_W};" in src
  assert "kTileH = kThreads * 4 / kTileW;" in src and \
      bev_fill.TILE_H == 256 * 4 // bev_fill.TILE_W


def _assert_ray_cull_admits_hits(o, d, b):
  hits = raycast.raycast_hits_plain(o, d, b)
  cand = raycast.raycast_candidates_plain(o, d, b)
  assert hits.shape == cand.shape == (d.shape[0], d.shape[1], b.shape[2 - 1])
  missed = hits & ~cand
  assert not bool(missed.any()), torch.nonzero(missed)[:10]
  return hits, cand


@pytest.mark.parametrize("name", list(RAY_CASES))
def test_raycast_cull_admits_every_hit_adversarial(name):
  hits, cand = _assert_ray_cull_admits_hits(*RAY_CASES[name])
  assert bool(hits.any())
  if name == "rising rays, poles":
    # vehicles are skipped for every rising ray, poles are still hit
    o, d, b = RAY_CASES[name]
    vehicle = (b[0, :, 7] == 1) & (b[0, :, 8] > 0)
    rising = d[0, :, 2] >= 0
    assert not bool(cand[0][rising][:, vehicle].any())
    assert bool(hits[0][rising][:, b[0, :, 7] == 3].any())


def town_case(seed, B=2, N=3000, K=48):
  """Camera-like rays (most falling, some rising) from an origin at town
  coordinates against vehicles, walkers and 5 m poles within 60 m, with a
  fifth of the slots invalid."""
  rng = np.random.default_rng(seed)
  o = np.c_[rng.uniform(-700, 700, (B, 2)), np.full(B, 2.0)]
  d = np.c_[rng.normal(size=(B * N, 2)),
            rng.uniform(-0.6, 0.3, B * N)].reshape(B, N, 3)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  kind = rng.integers(0, 3, (B, K))
  boxes = np.stack([
      o[:, :1] + rng.uniform(-60, 60, (B, K)),
      o[:, 1:2] + rng.uniform(-60, 60, (B, K)),
      np.zeros((B, K)), np.zeros((B, K)),
      np.choose(kind, [2.4, 0.3, 0.3]), np.choose(kind, [1.0, 0.3, 0.3]),
      np.choose(kind, [0.775, 0.9, 2.5]), np.choose(kind, [1, 4, 3]),
      rng.uniform(size=(B, K)) > 0.2], -1)
  yaw = torch.tensor(rng.uniform(-np.pi, np.pi, (B, K)), dtype=torch.float32)
  f = lambda a: torch.tensor(a, dtype=torch.float32)
  b = f(boxes)
  b[..., 2], b[..., 3] = torch.cos(yaw), torch.sin(yaw)
  return f(o), f(d), b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_raycast_cull_admits_every_hit_random(seed):
  o, d, b = town_case(seed)
  hits, cand = _assert_ray_cull_admits_hits(o, d, b)
  n_valid = int((b[..., 8] > 0).sum()) * d.shape[1]
  # the cull lets few pairs through: a ray's half-line meets few of 48
  assert bool(hits.any()) and int(cand.sum()) < 0.3 * n_valid


def test_raycast_cost_counts_footprint_pairs():
  """The recounted bound: footprint pairs against a brute-force numpy count
  (the half-line from the origin crosses an edge of the footprint
  rectangle, or starts inside it), and the valid pairs."""
  o, d, b = town_case(3, B=2, N=400, K=12)
  n_bytes, flops, valid_pairs, foot = raycast.raycast_boxes_cost(o, d, b)
  B, N, K = d.shape[0], d.shape[1], b.shape[1]
  on, dn, bn = (x.numpy().astype(np.float64) for x in (o, d, b))
  want = 0
  for e in range(B):
    ray = dn[e, :, :2]
    for v in range(K):
      cx, cy, c, s, ex, ey = bn[e, v, :6]
      if bn[e, v, 8] <= 0:
        continue
      kk = c * c + s * s
      loc = np.array([[ex, ey], [ex, -ey], [-ex, -ey], [-ex, ey]])
      # |M (p - c)| <= e with M = [[c, s], [-s, c]]: p = c + M^T l / k^2
      cor = np.c_[cx + (c * loc[:, 0] - s * loc[:, 1]) / kk,
                  cy + (s * loc[:, 0] + c * loc[:, 1]) / kk]
      rel = cor - on[e, :2]
      crosses = np.zeros(N, dtype=bool)
      for i in range(4):
        a, g = rel[i], rel[(i + 1) % 4] - rel[i]
        den = ray[:, 0] * (-g[1]) - ray[:, 1] * (-g[0])
        with np.errstate(divide="ignore", invalid="ignore"):
          t = (a[0] * (-g[1]) - a[1] * (-g[0])) / den
          u = (ray[:, 0] * a[1] - ray[:, 1] * a[0]) / den
        crosses |= (den != 0) & (t >= 0) & (u >= 0) & (u <= 1)
      edge = np.roll(rel, -1, 0) - rel
      side = edge[:, 0] * (-rel[:, 1]) - edge[:, 1] * (-rel[:, 0])
      inside = (side >= 0).all() or (side <= 0).all()
      want += int((crosses | inside).sum())
  n_valid = int((b[..., 8] > 0).sum())
  assert valid_pairs == n_valid * N
  assert 0 < foot == want < valid_pairs
  assert flops == foot * raycast.RAY_BOX_FLOPS + n_valid * raycast.BOX_FLOPS
  assert n_bytes == 4 * (B * 3 + B * N * 3 + B * K * 9 + 2 * B * N)
  # no pair outside the footprint count hits
  assert int(raycast.raycast_hits_plain(o, d, b).sum()) <= foot


def _tile_hits(hits, tiles_y, tiles_x):
  """[B,V,h,w] pixel hits -> [B,V,tiles_y,tiles_x]: a tile holds a hit."""
  B, V, h, w = hits.shape
  pad = torch.nn.functional.pad(
      hits, (0, tiles_x * bev_fill.TILE_W - w, 0,
             tiles_y * bev_fill.TILE_H - h))
  return pad.reshape(B, V, tiles_y, bev_fill.TILE_H, tiles_x,
                     bev_fill.TILE_W).any(5).any(3)


def _assert_fill_cull_admits_hits(boxes, h, w):
  hits = bev_fill.fill_hits_plain(boxes, h, w)
  cand = bev_fill.fill_tile_candidates_plain(boxes, h, w)
  ty, tx = -(-h // bev_fill.TILE_H), -(-w // bev_fill.TILE_W)
  assert cand.shape == (boxes.shape[0], boxes.shape[1], ty, tx)
  missed = _tile_hits(hits, ty, tx) & ~cand
  assert not bool(missed.any()), torch.nonzero(missed)[:10]
  return hits, cand


@pytest.mark.parametrize("name", list(FILL_CASES))
def test_fill_cull_admits_every_hit_adversarial(name):
  hits, cand = _assert_fill_cull_admits_hits(*FILL_CASES[name])
  if name == "no survivor":
    assert not bool(cand.any()) and not bool(hits.any())
  else:
    assert bool(hits.any())


@pytest.mark.parametrize("seed", [0, 1])
def test_fill_cull_admits_every_hit_random(seed):
  """Random poses and sizes over a 256x256 grid and around it."""
  rng = np.random.default_rng(seed)
  B, V, h, w = 2, 90, 256, 256
  f = lambda a: torch.tensor(a, dtype=torch.float32)
  yaw = f(rng.uniform(-np.pi, np.pi, (B, V)))
  boxes = bev_fill.pack_boxes(
      f(rng.uniform(-40, w + 40, (B, V))), f(rng.uniform(-40, h + 40, (B, V))),
      torch.cos(yaw), torch.sin(yaw), f(rng.uniform(0.2, 20, (B, V))),
      f(rng.uniform(0.2, 8, (B, V))), torch.tensor(rng.integers(1, 11, (B, V))),
      torch.tensor(rng.uniform(size=(B, V)) > 0.25))
  hits, cand = _assert_fill_cull_admits_hits(boxes, h, w)
  # a tile keeps few boxes: at most a few times the tiles a box covers
  assert bool(hits.any()) and int(cand.sum()) < 0.25 * cand.numel()
