"""On-card tests of the port's CUDA kernels (B1, B2 and the GroupNorm
kernel) against their plain versions, of the models' forwards replayed as CUDA graphs
(``utils/cuda_graph.GraphedForward``) against their eager forwards, of
the simulator's tick after the policy replayed as CUDA graphs
(``GraphedStages`` in ``sim/episode.sim_step``) against its eager tick,
of the PlanT policy's spans around its forward replayed as CUDA graphs
(``GraphedStages`` in ``agents/plant_agent.make_plant_policy``) against
the eager policy, and of Kimi-VL (``models/kimi_vl.py``): its whole
forward as one graph replay with no host sync, bit-equal to the eager
forward, and its grouped expert GEMMs against the loop over experts at
the published widths.

They need an NVIDIA card with nvcc (Hopper, sm_90a) and skip elsewhere.
This file imports no JAX, so it runs on a machine without it:

  python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py

(--noconftest because tests/conftest.py configures JAX.)
"""

import contextlib
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from carla_garage_tpu_torch.agents import plant_agent as pa
from carla_garage_tpu_torch.agents import sensor_agent as sa
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.models.plant import PlanT, PlanTConfig
from carla_garage_tpu_torch.models import moe
from carla_garage_tpu_torch.models.kimi_vl import KimiVL, KimiVLConfig
from carla_garage_tpu_torch.models.vla import SimLingo, SimLingoConfig
from carla_garage_tpu_torch.ops import kernel_cases
from carla_garage_tpu_torch.ops.bev_fill import (fill_boxes,
                                                 fill_boxes_bev_plain,
                                                 pack_boxes)
from carla_garage_tpu_torch.ops.norm import group_norm, group_norm_plain
from carla_garage_tpu_torch.ops.raycast import (raycast_boxes,
                                                raycast_boxes_plain)
from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
from carla_garage_tpu_torch.sim import episode
from carla_garage_tpu_torch.sim.expert import expert_step
from carla_garage_tpu_torch.sim.scene_builder import make_town_batch
from carla_garage_tpu_torch.structs import tree_items, tree_map
from carla_garage_tpu_torch.utils import cuda_graph, profiling


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
  # the plain version is elementwise fp32 on the card: no TF32 anywhere
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device("cuda")


def random_box_case(B, N, K, seed):
  """Rays from one origin per episode against boxes around it, with a
  duplicated box (a tie the earlier box must win), an origin inside a box,
  and invalid boxes."""
  rng = np.random.default_rng(seed)
  origins = np.concatenate([rng.uniform(-5, 5, (B, 2)),
                            rng.uniform(0.5, 2.5, (B, 1))], -1)
  d = rng.normal(size=(B, N, 3))
  d[..., 2] = -np.abs(d[..., 2]) * 0.3
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  yaw = rng.uniform(-np.pi, np.pi, (B, K))
  boxes = np.stack([
      origins[:, :1] + rng.uniform(-30, 30, (B, K)),
      origins[:, 1:2] + rng.uniform(-30, 30, (B, K)),
      np.cos(yaw), np.sin(yaw),
      rng.uniform(0.3, 3.0, (B, K)), rng.uniform(0.3, 1.5, (B, K)),
      rng.uniform(0.5, 2.5, (B, K)),
      rng.integers(1, 9, (B, K)).astype(np.float64),
      (rng.uniform(size=(B, K)) > 0.2).astype(np.float64)], -1)
  if K >= 3:
    boxes[:, 1] = boxes[:, 0]               # exact duplicate ...
    boxes[:, 1, 7] = 5.0                    # ... of another class: a tie
    boxes[:, 0, 7] = 1.0
    boxes[:, 0, 8] = boxes[:, 1, 8] = 1.0
    boxes[0, 2, :2] = origins[0, :2]        # episode 0 starts inside box 2
    boxes[0, 2, 8] = 1.0
  f = lambda a: torch.tensor(a, dtype=torch.float32)
  return f(origins), f(d), f(boxes)


RAY_CASES = kernel_cases.raycast_cases()
FILL_CASES = kernel_cases.fill_cases()


@pytest.mark.parametrize("B,N,K", [(3, 1000, 13), (2, 257, 48), (1, 5, 0),
                                   (16, 262144, 48), (16, 29952, 48),
                                   (16, 59904, 48), (2, 3000, 1000)])
def test_raycast_kernel_matches_plain(cuda, B, N, K):
  """Random cases, the full-width shapes of the main paths with the
  scene's 48 box slots (16 x 262,144 camera rays, 16 x 29,952 rays of a
  LiDAR half sweep, 16 x 59,904 of the training sweep), and 1,000 boxes:
  64 KB of staged records, past the 48 KB that needs no opt-in."""
  o, d, bx = (x.to(cuda) for x in random_box_case(B, N, K, seed=N))
  _raycast_equals_plain(o, d, bx)


@pytest.mark.parametrize("name", list(RAY_CASES))
def test_raycast_kernel_matches_plain_adversarial(cuda, name):
  """The cull's adversarial cases: grazing corners, edges, axis-parallel
  and vertical rays, origins inside boxes, boxes 1,000 m away, zero
  extents, rising rays against poles."""
  _raycast_equals_plain(*(x.to(cuda) for x in RAY_CASES[name]))


def _raycast_equals_plain(o, d, bx):
  before = raycast_boxes.launches
  t, cls = raycast_boxes(o, d, bx)
  torch.cuda.synchronize()
  assert raycast_boxes.launches == before + 1
  t_ref, cls_ref = raycast_boxes_plain(o, d, bx)
  # built with -fmad=false and IEEE division, the kernel repeats the plain
  # version's fp32 operations in its order: equal bit for bit
  assert torch.equal(t, t_ref)
  assert torch.equal(cls, cls_ref)
  if bx.shape[1]:
    assert bool((t < 1e9).any())


def test_raycast_kernel_rejects_bad_input(cuda):
  o, d, bx = (x.to(cuda) for x in random_box_case(1, 16, 4, seed=0))
  with pytest.raises(TypeError):
    raycast_boxes(o, d.double(), bx)
  with pytest.raises(ValueError):
    raycast_boxes(o, d.transpose(0, 1), bx)
  with pytest.raises(ValueError):
    raycast_boxes(o, d, bx[..., :8].contiguous())


def random_bev_boxes(B, V, h, w, seed):
  """Boxes over an h x w grid: random poses, a quarter invalid, and pairs
  of boxes of other classes at one center (the later one must win)."""
  rng = np.random.default_rng(seed)
  cx = rng.uniform(-10, w + 10, (B, V))
  cy = rng.uniform(-10, h + 10, (B, V))
  k = cx[:, 1::4].shape[1]              # boxes 4i+1 sit on boxes 4i
  cx[:, 1::4], cy[:, 1::4] = cx[:, 0:4 * k:4], cy[:, 0:4 * k:4]
  yaw = rng.uniform(-np.pi, np.pi, (B, V))
  f = lambda a: torch.tensor(a, dtype=torch.float32)
  return pack_boxes(f(cx), f(cy), torch.cos(f(yaw)), torch.sin(f(yaw)),
                    f(rng.uniform(2, 14, (B, V))), f(rng.uniform(1, 7, (B, V))),
                    torch.tensor(rng.integers(1, 11, (B, V))),
                    torch.tensor(rng.uniform(size=(B, V)) > 0.25))


@pytest.mark.parametrize("B,V,h,w", [(16, 172, 256, 256), (3, 37, 200, 328),
                                     (2, 0, 64, 64), (1, 2000, 130, 7)])
def test_fill_kernel_matches_plain(cuda, B, V, h, w):
  """The training shape (16 episodes, 172 boxes, 256x256), a ragged grid,
  no boxes, and 2,000 boxes: 64 KB of staged survivors where a tile keeps
  them all, past the 48 KB that needs no opt-in."""
  bx = random_bev_boxes(B, V, h, w, seed=V).to(cuda)
  out = _fill_equals_plain(bx, h, w)
  if V:
    assert bool((out > 0).any())


@pytest.mark.parametrize("name", list(FILL_CASES))
def test_fill_kernel_matches_plain_adversarial(cuda, name):
  """Boxes on tile corners, narrower than a pixel, at 45 degrees, partly
  off a ragged grid (width not a multiple of 4), and a grid where no tile
  keeps a box."""
  boxes, h, w = FILL_CASES[name]
  out = _fill_equals_plain(boxes.to(cuda), h, w)
  assert bool((out > 0).any()) == (name != "no survivor")


def _fill_equals_plain(bx, h, w):
  B = bx.shape[0]
  before = fill_boxes.launches
  out = fill_boxes(bx, h, w)
  torch.cuda.synchronize()
  assert fill_boxes.launches == before + 1
  ref = fill_boxes_bev_plain(bx, h, w)
  # built with -fmad=false, the kernel repeats the plain version's fp32
  # operations in order: the maps are equal pixel for pixel
  assert out.dtype == torch.uint8 and out.shape == (B, h, w)
  assert torch.equal(out, ref)
  return out


def test_fill_kernel_rejects_bad_input(cuda):
  bx = random_bev_boxes(2, 4, 8, 8, seed=0).to(cuda)
  with pytest.raises(TypeError):
    fill_boxes(bx.double(), 8, 8)
  with pytest.raises(ValueError):
    fill_boxes(bx[..., :7].contiguous(), 8, 8)
  with pytest.raises(ValueError):
    fill_boxes(bx.transpose(0, 1).contiguous().transpose(0, 1), 8, 8)
  with pytest.raises(ValueError):
    fill_boxes(bx, 0, 8)


# --- the GroupNorm kernel -------------------------------------------------

GN_SHAPES = sorted({(s, g) for _, s, g, _ in kernel_cases.tfpp_group_norms(16)})
# S = 49 (no whole 16-byte loads: one element a load), groups equal to
# channels, a 5-D NCTHW map, a contiguous group of 1,048,576 elements (43
# CTAs of the second kernel in bf16), 3 channels and 63 positions, a
# 1,512-channel sample
GN_EDGE = [((2, 16, 7, 7), 16), ((2, 64, 4, 8, 8), 32), ((2, 8, 512, 512), 2),
           ((3, 6, 7, 9), 3), ((2, 1512, 3, 5), 28)]
LAYOUTS = {4: torch.channels_last, 5: torch.channels_last_3d}


def gn_case(shape, dtype, layout, seed=0):
  """(x, scale, bias) on the card: x normal with mean 0.7 and deviation 2,
  in `layout` ("contiguous" or "channels_last"); scale in [-1.5, 2], bias
  in [-0.5, 0.5], both in x's dtype as a bf16 model's are."""
  g = torch.Generator(device="cuda").manual_seed(seed)
  x = (torch.randn(shape, device="cuda", generator=g) * 2.0 + 0.7).to(dtype)
  if layout == "channels_last":
    x = x.contiguous(memory_format=LAYOUTS[len(shape)])
  C = shape[1]
  return (x, torch.linspace(-1.5, 2.0, C, device="cuda").to(dtype),
          torch.linspace(0.5, -0.5, C, device="cuda").to(dtype))


# The kernel sums a group's elements in another order than the plain
# version (a thread's share of a CTA's rows, the block, then the CTAs;
# torch's channel means, then their mean): each version adds at most a few
# hundred terms in a chain, so each float32 sum lies within SUM_ORDER of
# the sum of |x| (of x^2). F32_EPS: float32's machine epsilon.
SUM_ORDER = 1e-5
F32_EPS = 2.0 ** -23


def gn_within_plain(x, y, scale, bias, groups, eps, relu):
  """A bool on the card: True where the kernel's output y of x lies within
  what the plain version's float32 arithmetic gives with the group's sums
  taken in another order. With the group's mean m, E[x^2] q and variance v
  from the plain version, sums off by SUM_ORDER move the mean by up to
  SUM_ORDER sqrt(q) and 1 / sqrt(v + eps) by up to 2 SUM_ORDER q / (v + eps)
  of itself (to first order), so y = x a + b by up to SUM_ORDER |a| (sqrt(q)
  + 2 |x - m| q / (v + eps)), plus a few float32 roundings of x a and b.
  The bound thus widens where the group's mean is large against its
  deviation, where E[x^2] - E[x]^2 loses digits in both versions alike.
  The output is then the rounding to x's dtype (monotone), after the ReLU
  (monotone): between the roundings of the bounds. In bf16 an element can
  differ from the plain version's only by one bf16 unit, and only where
  its float32 value lies that close to a rounding boundary."""
  B, C = x.shape[:2]
  shape = (B, C) + (1,) * (x.ndim - 2)
  spatial = tuple(range(2, x.ndim))
  xf = x.float()

  def per_group(m):
    return m.reshape(B, groups, -1).mean(-1).repeat_interleave(
        C // groups, -1).reshape(shape)

  mean = per_group(xf.mean(spatial))
  sq = per_group(xf.square().mean(spatial))
  var = torch.clamp(sq - mean.square(), min=0.0)
  a = torch.rsqrt(var + eps) * scale.float().reshape(shape[1:])
  b = bias.float().reshape(shape[1:]) - mean * a
  z = xf * a + b
  slack = SUM_ORDER * a.abs() * (
      sq.sqrt() + 2.0 * (xf - mean).abs() * sq / (var + eps)) + \
      4.0 * F32_EPS * ((xf * a).abs() + b.abs() + (mean * a).abs())
  lo, hi = z - slack, z + slack
  if relu:
    lo, hi = torch.relu(lo), torch.relu(hi)
  yf = y.float()
  return ((yf >= lo.to(x.dtype).float()) & (yf <= hi.to(x.dtype).float())
          ).all()


def _gn_equals_plain(x, scale, bias, groups, relu):
  before = group_norm.launches
  y = group_norm(x, scale, bias, groups, 1e-6, relu)
  torch.cuda.synchronize()
  assert group_norm.launches == before + 1
  ref = group_norm_plain(x, scale, bias, groups, 1e-6, relu)
  assert y.dtype == x.dtype and y.shape == x.shape
  assert y.stride() == x.stride()
  assert bool(gn_within_plain(x, y, scale, bias, groups, 1e-6, relu))
  # The kernel sums a group's elements in another order than the plain
  # version's channel means and their mean, so the float32 moments, and the
  # outputs before rounding, differ by a few units in the last place: in
  # float32 within 1e-5 relative. In bf16 a value that close to a rounding
  # boundary then rounds one bf16 unit (2^-8 to 2^-7 relative) the other
  # way: within 2^-7 relative, on at most 0.1% of the elements.
  y, ref = y.float(), ref.float()
  gap = (y - ref).abs()
  rel = 2.0 ** -7 if x.dtype == torch.bfloat16 else 1e-5
  assert bool((gap <= rel * ref.abs() + 1e-5).all()), float(gap.max())
  assert float((gap > 0).float().mean()) <= (
      1e-3 if x.dtype == torch.bfloat16 else 1.0)
  if relu:
    assert float(y.min()) == 0.0


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("shape,groups", GN_SHAPES)
def test_group_norm_kernel_matches_plain(cuda, shape, groups, layout):
  """Every GroupNorm shape of both full-spec RegNetY-032 branches at B=16
  (the camera's and the LiDAR's), in the main path's channels-last layout
  and contiguous, in bf16 and float32, with the ReLU off and on."""
  for dtype in (torch.bfloat16, torch.float32):
    x, scale, bias = gn_case(shape, dtype, layout, seed=shape[1])
    for relu in (False, True):
      _gn_equals_plain(x, scale, bias, groups, relu)


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("shape,groups", GN_EDGE)
def test_group_norm_kernel_edge_shapes(cuda, shape, groups, layout):
  for dtype in (torch.bfloat16, torch.float32):
    x, scale, bias = gn_case(shape, dtype, layout, seed=1)
    for relu in (False, True):
      _gn_equals_plain(x, scale, bias, groups, relu)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_kernel_unaligned(cuda, dtype):
  """A map that starts off a 16-byte boundary runs one element a load."""
  x, scale, bias = gn_case((2, 72, 16, 32), dtype, "contiguous")
  flat = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
  shifted = flat[1:].view(x.shape)
  shifted.copy_(x)
  assert shifted.data_ptr() % 16
  _gn_equals_plain(shifted, scale, bias, 24, True)


@pytest.mark.parametrize("shape,groups,layout", [
    ((16, 72, 128, 512), 24, "channels_last"),   # the largest map
    ((2, 1512, 3, 5), 28, "channels_last"),      # one row of C a CTA
    ((16, 72, 128, 512), 24, "contiguous"),      # 8 CTAs a group
    ((2, 16, 7, 7), 16, "contiguous")])          # one element a load
def test_group_norm_kernel_graph_replay(cuda, shape, groups, layout):
  """A replay under torch.cuda.graph equals the eager call on the same
  input, bit for bit: the kernel's sums run in a fixed order."""
  x, scale, bias = gn_case(shape, torch.bfloat16, layout)
  static = x.clone()
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(2):
      group_norm(static, scale, bias, groups, 1e-6, True)
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out = group_norm(static, scale, bias, groups, 1e-6, True)
  fresh, _, _ = gn_case(shape, torch.bfloat16, layout, seed=7)
  static.copy_(fresh)
  graph.replay()
  eager = group_norm(fresh, scale, bias, groups, 1e-6, True)
  torch.cuda.synchronize()
  assert torch.equal(out, eager)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_group_norm_kernel_gradients(cuda, layout, relu):
  """The autograd.Function's backward differentiates the plain version on
  the saved input: its gradients are the plain version's, to the order of
  the atomic additions in the plain version's own backward."""
  x0, s0, b0 = gn_case((4, 72, 32, 48), torch.float32, layout)
  dy = torch.randn(x0.shape, device="cuda").contiguous(
      memory_format=LAYOUTS[4] if layout == "channels_last" else
      torch.contiguous_format)
  grads = []
  for fn in (group_norm, group_norm_plain):
    leaves = [t.clone().requires_grad_(True) for t in (x0, s0, b0)]
    fn(*leaves, 24, 1e-6, relu).backward(dy)
    grads.append([t.grad for t in leaves])
  for got, want in zip(*grads):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_group_norm_kernel_rejects_bad_input(cuda):
  x, scale, bias = gn_case((2, 72, 16, 32), torch.bfloat16, "contiguous")
  with pytest.raises(ValueError):              # neither layout
    group_norm(x[:, :, ::2], scale, bias, 24)
  with pytest.raises(ValueError):
    group_norm(x.transpose(2, 3), scale, bias, 24)
  with pytest.raises(TypeError):
    group_norm(x.double(), scale.double(), bias.double(), 24)
  with pytest.raises(TypeError):
    group_norm(x.half(), scale.half(), bias.half(), 24)
  with pytest.raises(TypeError):
    group_norm(x, scale.float(), bias, 24)
  with pytest.raises(ValueError):              # parameters on the host
    group_norm(x, scale.cpu(), bias.cpu(), 24)
  with pytest.raises(ValueError):
    group_norm(x, scale, bias, 25)
  with pytest.raises(ValueError):
    group_norm(x, scale[:-1], bias[:-1], 24)


@pytest.mark.parametrize("kind,want", [("tfpp", 136), ("tfpp_vswin", 68)])
def test_group_norm_launches_a_forward(cuda, kind, want):
  """One launch for each GroupNorm of the full-spec bf16 forward: both
  RegNetY-032 branches of TransFuser++, the camera branch alone with the
  Video Swin-T LiDAR branch (LayerNorms)."""
  torch.manual_seed(0)
  c = ttf.VideoTransfuserConfig() if kind == "tfpp_vswin" else \
      ttf.TransfuserConfig()
  model = ttf.LidarCenterNet(c).to(cuda, torch.bfloat16).eval()
  K = ttf.lidar_history(c)
  x = (torch.rand(2, c.img_h, c.img_w, 3) * 255,
       torch.rand(2, c.lidar_h, c.lidar_w, c.lidar_channels * K),
       torch.zeros(2, 2), torch.eye(6)[[1, 2]], torch.zeros(2))
  before = group_norm.launches
  with torch.no_grad():
    model(*(t.to(cuda, torch.bfloat16) for t in x))
  torch.cuda.synchronize()
  assert group_norm.launches - before == want


# --- the forward as a CUDA graph ------------------------------------------

GRAPH_B = 2
GRAPH_PCFG = PlanTConfig(hidden=64, n_layers=2, n_heads=2, intermediate=256,
                         max_positions=64, max_objects=10,
                         num_route_points=6)
# the benchmark's small SimLingo: two 56-pixel tiles and the thumbnail,
# 14 query and 2 key-value heads
GRAPH_VCFG = SimLingoConfig(**json.loads(
    (pathlib.Path(__file__).resolve().parents[1] /
     "portbench/configs/simlingo.json").read_text())["test_small"]["model"])


def graph_model(kind, dev):
  """(module on the card in eval mode, inputs(seed, batch)): the micro
  TransFuser++ in float32 ("tfpp"), in bfloat16 ("tfpp_bf16"), with the
  ImageNet normalisation ("tfpp_imagenet"), the micro PlanT, or the small
  SimLingo in float32 ("simlingo") or bfloat16 ("simlingo_bf16")."""
  torch.manual_seed(0)
  if kind.startswith("simlingo"):
    c = GRAPH_VCFG
    dt = torch.bfloat16 if kind == "simlingo_bf16" else torch.float32

    def inputs(seed, b=GRAPH_B):
      g = torch.Generator().manual_seed(seed)
      x = (torch.randn(b, c.n_tiles, 3, c.tile, c.tile, generator=g),
           torch.randn(b, 2, 2, generator=g) * 10,
           torch.rand(b, generator=g) * 8,
           torch.eye(6)[torch.randint(0, 6, (b,), generator=g)])
      return tuple(t.to(dev, dt) for t in x)
    return SimLingo(c).to(dev, dt).eval(), inputs
  if kind == "plant":
    c = GRAPH_PCFG

    def inputs(seed, b=GRAPH_B):
      g = torch.Generator().manual_seed(seed)
      O, R = c.max_objects, c.num_route_points
      x = (torch.randn(b, O, 7, generator=g),
           torch.randint(0, 4, (b, O), generator=g, dtype=torch.int32),
           torch.randn(b, R, 2, generator=g),
           torch.randint(0, 2, (b,), generator=g).float(), torch.zeros(b),
           torch.ones(b), torch.rand(b, generator=g) * 8)
      return tuple(t.to(dev) for t in x)
    return PlanT(c).to(dev).eval(), inputs
  c = dataclasses.replace(ttf.micro_config(),
                          normalize_imagenet=kind == "tfpp_imagenet")
  dt = torch.bfloat16 if kind == "tfpp_bf16" else torch.float32

  def inputs(seed, b=GRAPH_B):
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand(b, c.img_h, c.img_w, 3, generator=g) * 255,
         torch.rand(b, c.lidar_h, c.lidar_w, c.lidar_channels, generator=g),
         torch.randn(b, 2, generator=g) * 10,
         torch.eye(6)[torch.randint(0, 6, (b,), generator=g)],
         torch.rand(b, generator=g) * 8)
    return tuple(t.to(dev, dt) for t in x)
  return ttf.LidarCenterNet(c).to(dev, dt).eval(), inputs


def rel_gap(a, b):
  """The largest relative difference over the outputs' tensors (each: the
  largest difference over the largest value)."""
  la, lb = list(tree_items(a)), list(tree_items(b))
  assert la and [k for k, _ in la] == [k for k, _ in lb]
  worst = 0.0
  for (k, x), (_, y) in zip(la, lb):
    assert x.dtype == y.dtype and x.shape == y.shape, k
    x, y = x.float(), y.float()
    worst = max(worst, float((x - y).abs().max() /
                             y.abs().max().clamp(min=1e-30)))
  return worst


def count_captures(monkeypatch):
  n = [0]
  real = cuda_graph._Graph

  def counted(*a, **kw):
    n[0] += 1
    return real(*a, **kw)
  monkeypatch.setattr(cuda_graph, "_Graph", counted)
  return n


@pytest.mark.parametrize("kind", ["tfpp", "tfpp_bf16", "tfpp_imagenet",
                                  "plant", "simlingo", "simlingo_bf16"])
def test_graph_replays_the_eager_forward(cuda, kind, monkeypatch):
  """Three calls with fresh inputs: one capture; the outputs equal the
  eager forward's (float32 within 1e-6 relative, bf16 within the eager
  forward's own run-to-run spread); the hook fires once a call, never in
  warm-up or capture, with the call's inputs and outputs; and a call's
  outputs survive the next replay."""
  m, inputs = graph_model(kind, cuda)
  seen = []
  clone = lambda t: tree_map(torch.clone, t)
  m.register_forward_hook(
      lambda mod, args, out: seen.append((clone(args), clone(out))))
  captures = count_captures(monkeypatch)
  g = cuda_graph.GraphedForward(m)
  with torch.no_grad():
    eager = [m.forward(*inputs(k)) for k in range(3)]
    again = [m.forward(*inputs(k)) for k in range(3)]
    outs, kept = [], []
    for k in range(3):
      outs.append(g(*inputs(k)))
      kept.append(clone(outs[-1]))
      assert len(seen) == k + 1
  torch.cuda.synchronize()
  assert captures[0] == 1 and len(g.graphs) == 1
  spread = max(rel_gap(a, b) for a, b in zip(again, eager))
  tol = spread if kind.endswith("_bf16") else 1e-6
  for k in range(3):
    assert rel_gap(outs[k], eager[k]) <= tol, (k, spread)
    assert rel_gap(outs[k], kept[k]) == 0.0          # untouched since
    args, out = seen[k]
    assert all(torch.equal(a, b) for a, b in zip(args, inputs(k)))
    assert rel_gap(out, outs[k]) == 0.0
  assert "forward" not in m.__dict__


def test_graph_follows_weights_shapes_and_storage(cuda, monkeypatch):
  """An in-place weight update shows in the next replay without a new
  capture; a new batch size captures once more; a parameter whose storage
  was replaced drops the graphs and captures again."""
  m, inputs = graph_model("plant", cuda)
  captures = count_captures(monkeypatch)
  g = cuda_graph.GraphedForward(m)
  x = inputs(0)
  with torch.no_grad():
    g(*x)
    m.target_speed_head.weight.mul_(1.5)
    assert rel_gap(g(*x), m.forward(*x)) <= 1e-6
    assert captures[0] == 1
    y = inputs(1, b=GRAPH_B + 1)
    assert rel_gap(g(*y), m.forward(*y)) <= 1e-6
    assert captures[0] == 2 and len(g.graphs) == 2
    assert rel_gap(g(*x), m.forward(*x)) <= 1e-6
    assert captures[0] == 2
    w = m.target_speed_head.weight
    w.data = w.data * -2.0
    assert rel_gap(g(*x), m.forward(*x)) <= 1e-6
    assert captures[0] == 3 and len(g.graphs) == 1
  with torch.enable_grad():
    out = g(*x)
  assert out["pred_wp"].requires_grad and captures[0] == 3


def test_graph_spans(cuda):
  """``graph.capture`` once, outside the replay; ``graph.replay`` once a
  call; both timed by CUDA events outside the capture."""
  m, inputs = graph_model("plant", cuda)
  g = cuda_graph.GraphedForward(m)
  profiling.record(True)
  try:
    with torch.no_grad():
      for k in range(3):
        with profiling.span("agent.model"):
          g(*inputs(k))
    torch.cuda.synchronize()
    spans = profiling.recorded()
  finally:
    profiling.record(False)
    profiling.clear()
  names = [s.name for s in spans]
  assert names.count("graph.capture") == 1
  assert names.count("graph.replay") == 3
  models = {s.id for s in spans if s.name == "agent.model"}
  assert all(s.parent in models for s in spans if s.name.startswith("graph."))
  assert all(s.elapsed_ms() >= 0 for s in spans)


class _SpanInside(torch.nn.Module):
  """A forward that opens a span around part of its work."""

  def __init__(self):
    super().__init__()
    self.lin = torch.nn.Linear(8, 8)

  def forward(self, x):
    with profiling.span("test.inside"):
      x = torch.relu(self.lin(x))
    return x * 2


def test_graph_span_markers(cuda):
  """A span opened inside a captured forward is a pair of marker kernels
  in every replay, and the replay still equals the eager forward; a
  forward that opens no span gets no marker."""
  marked = _SpanInside().to(cuda).eval()
  plain = torch.nn.Linear(8, 8).to(cuda).eval()
  x = torch.randn(4, 8, device=cuda)
  gm = cuda_graph.GraphedForward(marked)
  gp = cuda_graph.GraphedForward(plain)
  profiling.record(True)
  try:
    with torch.no_grad():
      gm(x), gp(x)                      # the captures
      torch.cuda.synchronize()
      acts = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]
      with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
          got = gm(x)
          gp(x)
        torch.cuda.synchronize()
      want = marked.forward(x)
  finally:
    profiling.record(False)
    profiling.clear()
  assert torch.equal(got, want)
  mid = profiling.marker_ids()["test.inside"]
  names = [e.name for e in prof.events() if "cgt_span_" in e.name]
  assert sum(f"cgt_span_begin<{mid}>" in n for n in names) == 3, names
  assert sum(f"cgt_span_end<{mid}>" in n for n in names) == 3, names
  assert len(names) == 6, names



# --- the simulator's tick after the policy as CUDA graphs ------------------

SIM_TICKS = 16
SIM_LAYERS = ("sim.scenarios", "sim.dynamics", "sim.traffic", "sim.criteria")


@pytest.fixture
def fresh_sim_graphs(monkeypatch):
  """sim_step with a cache of graphs of its own (the test's captures are
  counted from none)."""
  monkeypatch.setattr(episode, "_GRAPHS", cuda_graph.GraphedStages())
  return episode._GRAPHS


def sim_scene(dev, batch=GRAPH_B):
  _, maps, lanes, scene, state = make_town_batch(
      CFG, "synth", batch=batch, seed=0, n_vehicles=8, n_walkers=2,
      use_scenarios=True, device=dev)
  return maps, lanes, scene, state


def sim_policy(kind, state, dev):
  """(policy, state with its agent) at the tests' small sizes: the
  expert, the micro PlanT, or the micro TransFuser++ with B1's sensors."""
  torch.manual_seed(0)
  B = state.tick.shape[0]
  if kind == "expert":
    return expert_step, state
  if kind == "plant":
    policy = pa.make_plant_policy(PlanT(GRAPH_PCFG).to(dev), None,
                                  GRAPH_PCFG, direct=True)
    return policy, state.replace(agent=pa.plant_agent_reset(CFG, B,
                                                            device=dev))
  c = dataclasses.replace(ttf.micro_config(), img_h=32, img_w=128,
                          lidar_h=256, lidar_w=256, img_anchors=(1, 4),
                          lidar_anchors=(8, 8))
  lid_f = lidar_ray_grid(CFG, half=0, decimate=16)
  lid_r = lidar_ray_grid(CFG, half=1, decimate=16)
  policy = sa.make_transfuser_policy(
      ttf.LidarCenterNet(c).to(dev), None, c, camera_ray_grid(CFG, scale=8),
      lid_f, lid_r, direct=True)
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  return policy, state.replace(agent=sa.sensor_agent_reset(
      CFG, B, n_lidar, device=dev))


def sim_run(sim, policy, state, ticks=SIM_TICKS, drawn=False, kept=None):
  """The states after each of `ticks` ticks, from fixed seeds: the
  scenario engine's draws from the generator, or given (`drawn`); a copy
  of each, taken before the next tick runs, is appended to `kept`."""
  maps, lanes, scene, _ = sim
  gen = torch.Generator(device=state.tick.device).manual_seed(7)
  loss = torch.Generator(device=state.tick.device).manual_seed(11)
  K = scene.scenarios.kind.shape[1]
  out = []
  for _ in range(ticks):
    draws = {"control_loss": torch.randn(
        (state.tick.shape[0], K), generator=loss,
        device=state.tick.device)} if drawn else None
    state = episode.sim_step(CFG, maps, lanes, scene, state, policy,
                             generator=gen, draws=draws)
    out.append(state)
    if kept is not None:
      kept.append(tree_map(torch.clone, state))
  return out


def equal_states(a, b):
  la, lb = list(tree_items(a)), list(tree_items(b))
  assert la and [k for k, _ in la] == [k for k, _ in lb]
  for (k, x), (_, y) in zip(la, lb):
    assert x.dtype == y.dtype and x.shape == y.shape, k
    assert torch.equal(x, y), k


@contextlib.contextmanager
def sim_eager(monkeypatch):
  """sim_step runs its layers eagerly inside (the policy's forward stays a
  graph)."""
  with monkeypatch.context() as mp:
    mp.setattr(cuda_graph, "_eager_mode", lambda: True)
    yield


@pytest.mark.parametrize("kind,drawn", [("expert", False), ("expert", True),
                                        ("plant", False), ("tfpp", False)])
def test_sim_graphs_replay_the_eager_tick(cuda, kind, drawn, monkeypatch,
                                          fresh_sim_graphs):
  """16 ticks with the graphs and 16 eager from the same state and seeds
  are bit-equal at every tick; the graphs are captured in the first two
  ticks at most (the reset state's strides, then the tick's own) and
  replayed after; a state returned at a tick is untouched by every later
  tick."""
  graphs = fresh_sim_graphs
  sim = sim_scene(cuda)
  policy, state = sim_policy(kind, sim[3], cuda)
  held = []

  def call(*a, **kw):
    out = graphs(*a, **kw)
    held.append(len(graphs.graphs))
    return out
  monkeypatch.setattr(episode, "_GRAPHS", call)
  with torch.no_grad():
    kept = []
    graphed = sim_run(sim, policy, state, drawn=drawn, kept=kept)
    with sim_eager(monkeypatch):
      eager = sim_run(sim, policy, state, drawn=drawn)
  torch.cuda.synchronize()
  assert 1 <= held[0] and held[1] <= 2
  assert held == held[:2] + [held[1]] * (2 * SIM_TICKS - 2)
  for g, e, k in zip(graphed, eager, kept):
    equal_states(g, e)
    equal_states(g, k)
  assert int(graphed[-1].tick.min()) == SIM_TICKS
  if kind == "tfpp":
    # the policy's LiDAR history is frozen outside the graphs: no buffer
    # of theirs holds it
    history = tuple(state.agent.prev_lidar.shape)
    for g in graphs.graphs.values():
      assert all(tuple(t.shape) != history for t in g.inputs + g._outs)


def test_sim_graphs_follow_shapes_and_storage(cuda, monkeypatch,
                                              fresh_sim_graphs):
  """Another run on the same scene only replays; a new batch size (a new
  scene) captures again, as does a scene whose storage was replaced, each
  dropping the graphs before; every run is bit-equal to the eager tick."""
  graphs = fresh_sim_graphs
  captures = count_captures(monkeypatch)

  def both(sim, ticks=3):
    with torch.no_grad():
      got = sim_run(sim, expert_step, sim[3], ticks)
      with sim_eager(monkeypatch):
        want = sim_run(sim, expert_step, sim[3], ticks)
    for g, e in zip(got, want):
      equal_states(g, e)

  a = sim_scene(cuda)
  both(a)
  n = captures[0]
  assert 1 <= n <= 2 and len(graphs.graphs) == n
  both(a)
  assert captures[0] == n
  b = sim_scene(cuda, batch=GRAPH_B + 1)
  both(b)
  assert 1 <= captures[0] - n <= 2
  assert len(graphs.graphs) == captures[0] - n
  n = captures[0]
  maps, lanes, scene, state = b
  both((maps, lanes, tree_map(torch.clone, scene), state))
  assert 1 <= captures[0] - n <= 2
  assert len(graphs.graphs) == captures[0] - n


def test_sim_graph_spans(cuda, fresh_sim_graphs):
  """Each layer's span holds one ``graph.replay`` a tick, timed by CUDA
  events outside the capture; ``graph.capture`` opens inside ``sim.tick``
  in the capturing ticks only."""
  sim = sim_scene(cuda)
  profiling.record(True)
  try:
    with torch.no_grad():
      sim_run(sim, expert_step, sim[3], ticks=4)
    torch.cuda.synchronize()
    spans = profiling.recorded()
  finally:
    profiling.record(False)
    profiling.clear()
  by_id = {s.id: s for s in spans}
  ticks = [s for s in spans if s.name == "sim.tick"]
  assert len(ticks) == 4
  for name in SIM_LAYERS:
    layer = [s for s in spans if s.name == name]
    assert len(layer) == 4, name
    for s in layer:
      inside = [r for r in spans if r.parent == s.id]
      assert [r.name for r in inside] == ["graph.replay"], name
      assert by_id[s.parent].name == "sim.tick"
  caps = [s for s in spans if s.name == "graph.capture"]
  assert 1 <= len(caps) <= 2
  assert all(by_id[s.parent].name == "sim.tick" for s in caps)
  assert all(s.elapsed_ms() >= 0 for s in spans)


# --- the PlanT policy's eager spans as CUDA graphs -------------------------

AGENT_STAGES = ("agent.localize", "agent.inputs", "agent.control")


def agent_policy(monkeypatch, dev, direct=True):
  """(the micro PlanT policy with creep, its two ``GraphedStages``)."""
  made = []

  class Kept(cuda_graph.GraphedStages):
    def __init__(self):
      super().__init__()
      made.append(self)
  torch.manual_seed(0)
  with monkeypatch.context() as mp:
    mp.setattr(pa, "GraphedStages", Kept)
    policy = pa.make_plant_policy(PlanT(GRAPH_PCFG).to(dev), None,
                                  GRAPH_PCFG, direct=direct, creep=True)
  return policy, made


def stuck_agent(state):
  """`state` with the reset PlanT agent, episode 0 stuck, so that a creep
  begins at once."""
  B, dev = state.tick.shape[0], state.tick.device
  ag = pa.plant_agent_reset(CFG, B, device=dev)
  stuck = torch.zeros(B, dtype=torch.int32, device=dev)
  stuck[0] = CFG.expert.stuck_threshold
  return state.replace(agent=ag.replace(stuck_count=stuck))


def watched(policy, captures, controls, per_tick):
  """`policy`, keeping a copy of each control and agent state as soon as
  it returns, and the captures each call made (the forward's included)."""
  def call(*a, **kw):
    n = captures[0]
    out = policy(*a, **kw)
    controls.append(tree_map(torch.clone, out))
    per_tick.append(captures[0] - n)
    return out
  return call


@pytest.mark.parametrize("direct", [True, False])
def test_agent_graphs_replay_the_eager_policy(cuda, direct, monkeypatch,
                                              fresh_sim_graphs):
  """16 ticks with the policy's graphs and 16 eager from the same state
  and seeds are bit-equal at every tick, states and controls, each state
  and control copied as soon as its tick returned; the policy captures
  in its first tick only (its two stage calls and the forward) and
  replays after."""
  captures = count_captures(monkeypatch)
  sim = sim_scene(cuda)
  policy, made = agent_policy(monkeypatch, cuda, direct)
  state = stuck_agent(sim[3])
  runs = []
  for eager in (False, True):
    controls, per_tick, kept = [], [], []
    call = watched(policy, captures, controls, per_tick)
    with torch.no_grad(), contextlib.ExitStack() as stack:
      if eager:
        stack.enter_context(sim_eager(monkeypatch))
      states = sim_run(sim, call, state, kept=kept)
    runs.append((states, controls, per_tick, kept))
  torch.cuda.synchronize()
  (g_states, g_controls, g_caps, g_kept), (e_states, e_controls, e_caps,
                                           _) = runs
  assert g_caps == [3] + [0] * (SIM_TICKS - 1)
  assert e_caps == [0] * SIM_TICKS
  assert [len(g.graphs) for g in made] == [1, 1]
  for g, e, k in zip(g_states, e_states, g_kept):
    equal_states(g, e)
    equal_states(g, k)
  for g, e in zip(g_controls, e_controls):
    equal_states(g, e)
  assert int(g_states[-1].tick.min()) == SIM_TICKS
  assert any(int(c[1]["agent"].force_move[0]) > 0 for c in g_controls)


def test_agent_graphs_follow_shapes_and_storage(cuda, monkeypatch,
                                                fresh_sim_graphs):
  """Another run on the same scene only replays; a new batch size (a new
  scene) captures the two stage calls again, as does a scene whose
  storage was replaced, each dropping the graphs before; every run is
  bit-equal to the eager policy."""
  captures = count_captures(monkeypatch)
  policy, made = agent_policy(monkeypatch, cuda)

  def both(sim, ticks=3):
    state = stuck_agent(sim[3])
    controls, per_tick = [], []
    call = watched(policy, captures, controls, per_tick)
    with torch.no_grad():
      got = sim_run(sim, call, state, ticks)
      with sim_eager(monkeypatch):
        want = sim_run(sim, call, state, ticks)
    for g, e in zip(got, want):
      equal_states(g, e)
    for g, e in zip(controls[:ticks], controls[ticks:]):
      equal_states(g, e)
    return sum(per_tick)

  a = sim_scene(cuda)
  assert both(a) == 3
  assert both(a) == 0
  b = sim_scene(cuda, batch=GRAPH_B + 1)
  assert both(b) == 3                  # the forward's new shapes too
  assert [len(g.graphs) for g in made] == [1, 1]
  maps, lanes, scene, state = b
  assert both((maps, lanes, tree_map(torch.clone, scene), state)) == 2
  assert [len(g.graphs) for g in made] == [1, 1]


def test_agent_graph_spans(cuda, fresh_sim_graphs):
  """Each of the policy's spans holds one ``graph.replay`` a tick, the
  forward's ``agent.model`` too; the policy's three ``graph.capture``
  spans (its two stage calls', the forward's) open in the first tick
  only."""
  sim = sim_scene(cuda)
  policy, state = sim_policy("plant", sim[3], cuda)
  profiling.record(True)
  try:
    with torch.no_grad():
      sim_run(sim, policy, state, ticks=4)
    torch.cuda.synchronize()
    spans = profiling.recorded()
  finally:
    profiling.record(False)
    profiling.clear()
  by_id = {s.id: s for s in spans}

  def up(s, name):
    while s.parent is not None:
      s = by_id[s.parent]
      if s.name == name:
        return s
    return None

  for name in AGENT_STAGES + ("agent.model",):
    stage = [s for s in spans if s.name == name]
    assert len(stage) == 4, name
    for s in stage:
      inside = [r.name for r in spans if r.parent == s.id]
      assert inside.count("graph.replay") == 1, name
      assert set(inside) <= {"graph.replay", "graph.capture"}, name
      assert by_id[s.parent].name == "sim.policy"
  first = [s for s in spans if s.name == "sim.tick"][0]
  caps = [s for s in spans if s.name == "graph.capture" and
          up(s, "sim.policy") is not None]
  assert len(caps) == 3
  assert all(up(s, "sim.tick") is first for s in caps)


# --- Kimi-VL: the forward as one graph, the grouped expert GEMMs ------------

KIMI_SMALL = KimiVLConfig(**json.loads(
    (pathlib.Path(__file__).resolve().parents[1] /
     "portbench/configs/kimi_vl.json").read_text())["test_small"]["model"])


def kimi_model(c: KimiVLConfig, dev, seed: int = 0) -> KimiVL:
  """A Kimi-VL built on the meta device and loaded in bf16 on `dev` with
  random weights (matrices at variance 1/fan-in, norms' gains near 1)."""
  with torch.device("meta"):
    m = KimiVL(c)
  shapes = dict(m.published_spec())
  g = torch.Generator(device=dev).manual_seed(seed)

  def fetch(name):
    shape = shapes[name]
    u = torch.rand(shape, generator=g, device=dev) * 2 - 1
    if len(shape) >= 2:
      return u * (3.0 / np.prod(shape[1:])) ** 0.5
    return 1 + 0.1 * u if name.endswith("weight") else 0.1 * u
  return m.load_published(fetch, torch.bfloat16).eval()


def kimi_inputs(c: KimiVLConfig, dev, seed: int, b: int = GRAPH_B):
  g = torch.Generator().manual_seed(seed)
  x = (torch.randn(b, 3, c.camera_height, c.camera_width, generator=g),
       torch.randn(b, 2, 2, generator=g) * 10,
       torch.rand(b, generator=g) * 8,
       torch.eye(6)[torch.randint(0, 6, (b,), generator=g)])
  return tuple(t.to(dev, torch.bfloat16) for t in x)


def test_kimi_vl_forward_is_one_graph_replay(cuda, monkeypatch):
  """The small Kimi-VL in bf16: its eager forward makes no host sync
  (``set_sync_debug_mode("error")``), so its whole forward is captured
  once; three replays with fresh inputs equal the eager forward bit for
  bit, and the expert-load counter took every token-expert pair of the
  two warm-up calls and the three replays, layer by layer."""
  c = KIMI_SMALL
  m = kimi_model(c, cuda)
  captures = count_captures(monkeypatch)
  g = cuda_graph.GraphedForward(m)
  xs = [kimi_inputs(c, cuda, k) for k in range(3)]
  with torch.no_grad():
    torch.cuda.set_sync_debug_mode("error")
    try:
      eager = [m.forward(*x) for x in xs]
    finally:
      torch.cuda.set_sync_debug_mode("default")
    m.expert_load.zero_()
    outs = [g(*x) for x in xs]
  torch.cuda.synchronize()
  assert captures[0] == 1 and len(g.graphs) == 1
  for k in range(3):
    for key in ("pred_path", "pred_wp"):
      assert torch.equal(outs[k][key], eager[k][key]), (k, key)
  pairs = GRAPH_B * c.seq_len * c.num_experts_per_tok
  assert m.expert_load.sum(1).tolist() == [5 * pairs] * c.moe_layers


def published_moe(dev, seed: int = 0) -> moe.MoE:
  """One mixture-of-experts layer of Kimi-VL at its published widths in
  bf16, random weights."""
  c = KimiVLConfig()
  torch.manual_seed(seed)
  layer = moe.MoE(c.hidden_size, c.n_routed_experts, c.num_experts_per_tok,
                  c.moe_intermediate_size, c.n_shared_experts,
                  c.routed_scaling_factor)
  with torch.no_grad():
    for p in layer.parameters():
      p.uniform_(-1, 1).mul_((3.0 / p.shape[-1]) ** 0.5)
  layer = layer.to(dev, torch.bfloat16)
  layer.gate.float()
  return layer


@pytest.mark.parametrize("spread", ["random", "six_experts_only"])
def test_kimi_vl_grouped_gemm_matches_the_loop(cuda, spread):
  """The grouped GEMM path (``torch._grouped_mm`` over device offsets)
  against the loop over experts on one MoE layer at the published widths
  and a tick's 16 x 583 tokens: every pair routed once (the counts sum to
  tokens x 6), no host sync, and the outputs within bf16's rounding of
  each other (the two paths' GEMMs accumulate in different orders). With
  the selection bias pushed onto experts 0..5 every token takes the same
  six and the other 58 groups are empty."""
  c = KimiVLConfig()
  layer = published_moe(cuda)
  if spread == "six_experts_only":
    with torch.no_grad():
      layer.gate.e_score_correction_bias[:6] += 10.0
  N = 16 * c.seq_len
  g = torch.Generator(device=cuda).manual_seed(1)
  x = torch.randn(N, c.hidden_size, generator=g, device=cuda) \
      .to(torch.bfloat16)
  load = torch.zeros(c.n_routed_experts, dtype=torch.int64, device=cuda)
  with torch.no_grad():
    torch.cuda.set_sync_debug_mode("error")
    try:
      grouped = layer(x, load=load, grouped=True)
    finally:
      torch.cuda.set_sync_debug_mode("default")
    loop = layer(x, grouped=False)
  assert moe.grouped_available(x)
  assert int(load.sum()) == N * c.num_experts_per_tok
  if spread == "six_experts_only":
    assert load[:6].tolist() == [N] * 6 and int(load[6:].sum()) == 0
  gap = float((grouped - loop).norm() / loop.norm())
  assert gap < 2 ** -8, gap
