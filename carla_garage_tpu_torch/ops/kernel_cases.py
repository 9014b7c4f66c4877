"""Adversarial inputs for the two kernels' culls, made from a seed.

The tests hold each cull's plain mirror against the exact test on these
inputs on the CPU (``tests/test_torch_port_kernel_cull.py``), and each
kernel against its plain version on the card
(``tests/test_torch_port_cuda.py``). They aim at the places where the
exact fp32 test and a cull can disagree: rays grazing box
corners and running along edges, rays parallel to a box axis (the
``r_safe`` branch), vertical rays, origins inside boxes, boxes far away,
boxes of zero extent, rising rays against tall poles; BEV boxes on tile
corners, narrower than a pixel, at 45 degrees, partly off the grid, and
ragged edge tiles. Nothing on the main path imports this module.
"""

from __future__ import annotations

import numpy as np
import torch

POLE_EZ = 2.5          # light poles are 5 m tall (sensors/raycast.py)
VEHICLE_EZ = 0.775     # vehicles 1.55 m


def _f32(a) -> torch.Tensor:
  return torch.tensor(np.asarray(a), dtype=torch.float32)


def _ray_boxes(cx, cy, yaw, ex, ey, ez, cls, valid):
  """[B,K] fields (float64 yaw) -> [B,K,9] f32 in the kernel's layout;
  cos and sin are taken in float32, as the sensors take them."""
  y = _f32(yaw)
  return torch.stack([_f32(cx), _f32(cy), torch.cos(y), torch.sin(y),
                      _f32(ex), _f32(ey), _f32(ez), _f32(cls),
                      _f32(valid)], -1)


def _unit(d):
  d = np.asarray(d, dtype=np.float64)
  return d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-300)


def _corners(box):
  """The 4 footprint corners [4,2] of one float32 box row (float64)."""
  cx, cy, c, s, ex, ey = (float(v) for v in box[:6])
  lx = np.array([1, 1, -1, -1]) * ex
  ly = np.array([1, -1, -1, 1]) * ey
  # local = M (p - c) with M = [[c, s], [-s, c]]; p = c + M^T local
  return np.stack([cx + c * lx - s * ly, cy + s * lx + c * ly], -1)


def raycast_cases(seed: int = 0) -> dict:
  """name -> (origins [B,3], dirs [B,N,3], boxes [B,K,9]), f32 on the CPU."""
  rng = np.random.default_rng(seed)
  cases = {}

  # boxes around an origin at town coordinates of some hundreds of metres;
  # rays aimed at each box's corners at heights inside the box, each
  # direction also turned by a few float32 ulps either way, and rays along
  # each edge's line from an origin on that line
  B, K = 2, 24
  o = np.stack([rng.uniform(-600, 600, B), rng.uniform(-600, 600, B),
                np.full(B, 2.0)], -1)
  yaw = rng.uniform(-np.pi, np.pi, (B, K))
  yaw[:, :6] = np.array([0, np.pi / 2, np.pi, -np.pi / 2, np.pi / 4,
                         3 * np.pi / 4])
  boxes = _ray_boxes(o[:, :1] + rng.uniform(-40, 40, (B, K)),
                     o[:, 1:2] + rng.uniform(-40, 40, (B, K)), yaw,
                     rng.uniform(0.2, 2.5, (B, K)), rng.uniform(0.2, 1.2,
                                                                (B, K)),
                     np.full((B, K), VEHICLE_EZ), rng.integers(1, 9, (B, K)),
                     np.ones((B, K)))
  dirs = []
  for e in range(B):
    d = []
    for v in range(K):
      for cxy in _corners(boxes[e, v].numpy()):
        for z in (0.0, 0.8, 1.55):
          base = np.array([cxy[0] - o[e, 0], cxy[1] - o[e, 1], z - o[e, 2]])
          for turn in (-3e-7, -6e-8, 0.0, 6e-8, 3e-7):
            c, s = np.cos(turn), np.sin(turn)
            d.append([c * base[0] - s * base[1], s * base[0] + c * base[1],
                      base[2]])
    dirs.append(d)
  cases["grazing corners"] = (_f32(o), _f32(_unit(dirs)), boxes)

  # along edges: the origin on an edge's line 5-30 m out, rays along it
  # and turned by up to 1e-6 rad either way
  turns = np.linspace(-1e-6, 1e-6, 65)
  o2, d2 = [], []
  bx = boxes[:1].clone()
  for v in range(K):
    cor = _corners(bx[0, v].numpy())
    a, b = cor[v % 4], cor[(v + 1) % 4]
    u = _unit(b - a)
    o2.append(np.r_[a - u * rng.uniform(5, 30), 1.0])
    d2.append(np.stack([np.cos(turns) * u[0] - np.sin(turns) * u[1],
                        np.sin(turns) * u[0] + np.cos(turns) * u[1],
                        np.zeros_like(turns)], -1))
  cases["along edges"] = (_f32(o2), _f32(d2),
                          bx.expand(K, K, 9).contiguous())

  # axis-parallel: axis-aligned boxes and rays with dy = 0 or dx = 0
  # exactly, some passing the boxes' faces at an ulp; at yaw 0 sin is 0 and
  # a rotated component falls under r_safe's 1e-9, at yaw pi/2 float32's
  # cos is -4.4e-8 and it does not
  K3 = 16
  cx = rng.uniform(5, 40, (1, K3))
  cy = rng.uniform(-10, 10, (1, K3))
  ex, ey = rng.uniform(0.3, 2, (1, K3)), rng.uniform(0.3, 2, (1, K3))
  yaw3 = np.where(np.arange(K3) % 2 == 0, 0.0, np.pi / 2)[None]
  b3 = _ray_boxes(cx, cy, yaw3, ex, ey, np.full((1, K3), VEHICLE_EZ),
                  np.full((1, K3), 1), np.ones((1, K3)))
  ys = np.concatenate([np.linspace(-12, 12, 241),
                       (cy + ey).ravel(), (cy - ey).ravel(),
                       np.nextafter((cy + ey).astype(np.float32),
                                    np.float32(np.inf)).ravel()])
  o3 = np.stack([np.zeros_like(ys), ys, np.full_like(ys, 1.0)], -1)
  d3 = np.tile([1.0, 0.0, 0.0], (len(ys), 1))
  d3[1::3] = [1.0, 0.0, -0.01]
  d3[2::3] = [0.0, 1.0, 0.0]
  cases["axis parallel"] = (_f32(o3), _f32(d3)[:, None].contiguous(),
                            b3.expand(len(ys), K3, 9).contiguous())

  # vertical and near-vertical rays from above and inside boxes
  K4 = 12
  o4 = np.array([[0.0, 0.0, 10.0], [0.0, 0.0, 0.5]])
  b4 = _ray_boxes(rng.uniform(-2, 2, (2, K4)), rng.uniform(-2, 2, (2, K4)),
                  rng.uniform(-np.pi, np.pi, (2, K4)),
                  rng.uniform(0.1, 2, (2, K4)), rng.uniform(0.1, 2, (2, K4)),
                  rng.uniform(0.1, 3, (2, K4)), rng.integers(1, 9, (2, K4)),
                  np.ones((2, K4)))
  tilt = np.array([0.0, 1e-10, 1e-9, 5e-9, 1e-6, 1e-3, 0.009, 0.011])
  az = rng.uniform(-np.pi, np.pi, (len(tilt), 8))
  d4 = np.stack([tilt[:, None] * np.cos(az), tilt[:, None] * np.sin(az),
                 -np.ones_like(az)], -1).reshape(-1, 3)
  d4 = np.concatenate([d4, d4 * [1, 1, -1]])
  cases["vertical"] = (_f32(o4), _f32(d4)[None].expand(2, -1, 3)
                       .contiguous(), b4)

  # the origin inside a box, on its faces and at its corners
  b5 = _ray_boxes(np.zeros((1, 4)), np.zeros((1, 4)),
                  np.array([[0.3, 0.0, np.pi / 4, 2.0]]),
                  np.array([[2.0, 1.0, 0.5, 0.0]]),
                  np.array([[1.0, 1.0, 0.5, 0.0]]),
                  np.full((1, 4), VEHICLE_EZ), np.arange(1, 5)[None],
                  np.ones((1, 4)))
  inner = np.concatenate([[[0.0, 0.0]], _corners(b5[0, 0].numpy()),
                          _corners(b5[0, 2].numpy())])
  o5 = np.concatenate([inner, np.full((len(inner), 1), 0.5)], -1)
  d5 = _unit(rng.normal(size=(len(inner), 200, 3)))
  cases["origin inside"] = (_f32(o5), _f32(d5),
                            b5.expand(len(inner), 4, 9).contiguous())

  # boxes 1,000 m away at town coordinates, rays aimed at their centres
  # and corners
  K6 = 8
  ang = rng.uniform(-np.pi, np.pi, K6)
  o6 = np.array([[812.3, -437.9, 2.0]])
  cx6 = o6[0, 0] + 1000.0 * np.cos(ang)
  cy6 = o6[0, 1] + 1000.0 * np.sin(ang)
  b6 = _ray_boxes(cx6[None], cy6[None], rng.uniform(-np.pi, np.pi, (1, K6)),
                  np.full((1, K6), 2.2), np.full((1, K6), 0.9),
                  np.full((1, K6), VEHICLE_EZ), np.full((1, K6), 1),
                  np.ones((1, K6)))
  aims = np.concatenate([b6[0, :, :2].numpy().astype(np.float64)] +
                        [_corners(b6[0, v].numpy()) for v in range(K6)])
  d6 = []
  for a in aims:
    for z in (0.01, 0.7, 1.5):
      for turn in (-2e-7, 0.0, 2e-7):
        base = np.array([a[0] - o6[0, 0], a[1] - o6[0, 1], z - 2.0])
        c, s = np.cos(turn), np.sin(turn)
        d6.append([c * base[0] - s * base[1], s * base[0] + c * base[1],
                   base[2]])
  cases["1000 m away"] = (_f32(o6), _f32(_unit(d6))[None], b6)

  # zero-extent boxes (a point, a segment, a flat box) and rays through
  # their centres
  b7 = _ray_boxes(np.array([[10.0, 12.0, 8.0, 15.0]]),
                  np.array([[0.0, 3.0, -4.0, 1.0]]),
                  np.array([[0.0, 0.7, 0.0, 1.1]]),
                  np.array([[0.0, 2.0, 0.0, 1.0]]),
                  np.array([[0.0, 0.0, 1.0, 1.0]]),
                  np.array([[0.0, 0.5, 0.0, 0.0]]), np.arange(1, 5)[None],
                  np.ones((1, 4)))
  o7 = np.array([[0.0, 0.0, 0.0]])
  d7 = []
  for v in range(4):
    for z in (0.0, 0.5, 1.0):
      d7.append([float(b7[0, v, 0]), float(b7[0, v, 1]), z])
  d7 = np.concatenate([d7, rng.normal(size=(100, 3))])
  cases["zero extent"] = (_f32(o7), _f32(_unit(d7))[None], b7)

  # rising rays from a camera at 2 m: 5 m light poles must still be hit,
  # 1.55 m vehicles cannot be; a few invalid boxes
  K8 = 16
  pole = np.arange(K8) % 2 == 0
  b8 = _ray_boxes(rng.uniform(3, 40, (1, K8)), rng.uniform(-15, 15, (1, K8)),
                  rng.uniform(-np.pi, np.pi, (1, K8)),
                  np.where(pole, 0.3, 2.3)[None], np.where(pole, 0.3,
                                                           1.0)[None],
                  np.where(pole, POLE_EZ, VEHICLE_EZ)[None],
                  np.where(pole, 3, 1)[None],
                  (np.arange(K8) % 7 != 3)[None].astype(float))
  o8 = np.array([[0.0, 0.0, 2.0]])
  d8 = []
  for v in range(K8):
    for z in (2.0, 3.0, 4.99, 5.0, 5.01):
      d8.append([float(b8[0, v, 0]), float(b8[0, v, 1]), z - 2.0])
  d8 = np.concatenate([d8, np.c_[rng.normal(size=(200, 2)),
                                 rng.uniform(0, 0.5, 200)]])
  cases["rising rays, poles"] = (_f32(o8), _f32(_unit(d8))[None], b8)
  return cases


def _bev(cx, cy, yaw, ex, ey, cls, valid):
  y = _f32(yaw)
  return torch.stack([_f32(cx), _f32(cy), torch.cos(y), torch.sin(y),
                      _f32(ex), _f32(ey), _f32(cls), _f32(valid)], -1)


def fill_cases(seed: int = 0) -> dict:
  """name -> (boxes [B,V,8] f32 on the CPU, h, w), boxes in grid pixels."""
  rng = np.random.default_rng(seed)
  cases = {}

  # centres on tile corners (multiples of 64 x 16) and half a pixel off
  gx, gy = np.meshgrid(np.arange(0, 257, 64), np.arange(0, 257, 16))
  cx = (gx.ravel() + rng.choice([-0.5, 0.0, 0.5], gx.size))[None]
  cy = (gy.ravel() + rng.choice([-0.5, 0.0, 0.5], gy.size))[None]
  V = cx.shape[1]
  cases["tile corners"] = (_bev(cx, cy, rng.choice([0.0, 0.3, np.pi / 2],
                                                   (1, V)),
                                rng.uniform(0.0, 3.0, (1, V)),
                                rng.uniform(0.0, 3.0, (1, V)),
                                rng.integers(1, 11, (1, V)), np.ones((1, V))),
                           256, 256)

  # narrower than a pixel, on pixel centres and halfway between
  V = 120
  cx = rng.integers(0, 130, (1, V)) + rng.choice([0.0, 0.5, 0.25], (1, V))
  cy = rng.integers(0, 70, (1, V)) + rng.choice([0.0, 0.5, 0.25], (1, V))
  cases["sub-pixel"] = (_bev(cx, cy, rng.uniform(-np.pi, np.pi, (1, V)),
                             rng.uniform(0.0, 0.5, (1, V)),
                             rng.uniform(0.0, 0.5, (1, V)),
                             rng.integers(1, 11, (1, V)), np.ones((1, V))),
                        70, 130)

  # 45 degrees, corners on whole pixels
  V = 60
  yaw = rng.choice([np.pi / 4, 3 * np.pi / 4, -np.pi / 4], (1, V))
  cases["45 degrees"] = (_bev(rng.integers(0, 128, (1, V)),
                              rng.integers(0, 128, (1, V)), yaw,
                              np.sqrt(2) * rng.integers(1, 6, (1, V)),
                              np.sqrt(2) * rng.integers(1, 6, (1, V)),
                              rng.integers(1, 11, (1, V)), np.ones((1, V))),
                         128, 128)

  # partly off the grid, on a ragged grid whose width is not a multiple of
  # 4 (single-byte stores) and whose edge tiles are partial
  V = 80
  side = rng.integers(0, 4, V)
  h, w = 45, 131
  cx = np.where(side == 0, rng.uniform(-6, 2, V),
                np.where(side == 1, rng.uniform(w - 3, w + 6, V),
                         rng.uniform(0, w, V)))
  cy = np.where(side == 2, rng.uniform(-6, 2, V),
                np.where(side == 3, rng.uniform(h - 3, h + 6, V),
                         rng.uniform(0, h, V)))
  cases["off grid, ragged"] = (
      _bev(cx[None], cy[None], rng.uniform(-np.pi, np.pi, (1, V)),
           rng.uniform(0.5, 8, (1, V)), rng.uniform(0.5, 4, (1, V)),
           rng.integers(1, 11, (1, V)), rng.uniform(size=(1, V)) > 0.1),
      h, w)

  # no tile keeps a box: boxes far off the grid, and near ones invalid
  V = 40
  far = np.arange(V) % 2 == 0
  cases["no survivor"] = (
      _bev(np.where(far, 900.0, 60.0)[None].repeat(2, 0),
           np.where(far, -700.0, 60.0)[None].repeat(2, 0),
           rng.uniform(-np.pi, np.pi, (2, V)), np.full((2, V), 9.0),
           np.full((2, V), 4.0), np.full((2, V), 1),
           np.where(far, 1.0, 0.0)[None].repeat(2, 0)), 128, 256)
  return cases
