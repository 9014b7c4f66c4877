"""The GroupNorm kernel's host side on the CPU (``ops/norm.py``): the
launch geometry it takes at every shape, the ReLU epilogue of
``TpuGroupNorm`` and ``ChannelAffineNorm``, and the ``autograd.Function``'s
backward. The kernel itself runs only on the card
(``tests/test_torch_port_cuda.py``); the RegNetY and TransFuser++ parity
tests against the JAX package cover the plain version's numbers.
"""

import math

import numpy as np
import pytest
import torch

from carla_garage_tpu_torch.models import backbones
from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                      micro_config)
from carla_garage_tpu_torch.ops import kernel_cases, norm
from carla_garage_tpu_torch.ops.norm import (MIN_CTAS, PASS_BYTES,
                                             TpuGroupNorm, group_norm_plain,
                                             launch_geometry)

TFPP_NORMS = kernel_cases.tfpp_group_norms(16)


def group_elems(shape, groups):
  return shape[1] // groups * math.prod(shape[2:])


def covers(n, parts, chunk, quantum):
  """`parts` chunks of `chunk` elements, whole quanta, cover n once."""
  assert chunk % quantum == 0 and chunk >= quantum
  assert (parts - 1) * chunk < n <= parts * chunk


def check_geometry(n, itemsize, quantum, units):
  """The invariants of a launch: each kernel's parts cover a unit exactly
  once, in chunks of whole quanta; a CTA of the second kernel reads about
  PASS_BYTES (whole quanta over it); the first kernel's CTAs are spread to
  about MIN_CTAS over the units and are no more than the second's."""
  parts, chunk, mparts, mchunk = launch_geometry(n, itemsize, quantum, units)
  covers(n, parts, chunk, quantum)
  covers(n, mparts, mchunk, quantum)
  assert chunk * itemsize <= PASS_BYTES + quantum * itemsize
  assert mparts <= -(-MIN_CTAS // units)
  assert chunk <= mchunk and mparts <= parts
  return parts, chunk, mparts, mchunk


def test_tfpp_norm_calls():
  """136 GroupNorm calls in the full-spec TransFuser++ forward, 1.18 G
  elements at B=16; the largest group is the image branch's stage-0
  norm1, 3 x 128 x 512."""
  assert len(TFPP_NORMS) == 136
  assert sum(math.prod(s) for _, s, _, _ in TFPP_NORMS) == 1_175_511_040
  assert max(group_elems(s, g) for _, s, g, _ in TFPP_NORMS) == 196_608
  assert sum(relu for *_, relu in TFPP_NORMS) == 2 * (1 + 2 * 21)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("name,shape,groups",
                         sorted({(n, s, g) for n, s, g, _ in TFPP_NORMS
                                 if ".b0." in n or n.endswith("stem")}))
def test_geometry_contiguous(name, shape, groups, itemsize):
  """A contiguous map of the main path's shapes: B G groups, each covered
  in whole 16-byte vectors; the first kernel's CTAs number about MIN_CTAS
  in all."""
  units, vec = shape[0] * groups, 16 // itemsize
  parts, chunk, mparts, mchunk = check_geometry(group_elems(shape, groups),
                                                itemsize, vec, units)
  assert MIN_CTAS <= units * mparts < MIN_CTAS + units
  if name == "image.stage0.b0.norm1" and itemsize == 2:
    # 196,608 elements a group: 8 CTAs of 48 KB, the first kernel's 1
    assert (parts, chunk, mparts) == (8, 24_576, 1)


@pytest.mark.parametrize("itemsize,vec", [(2, 8), (2, 1), (4, 4), (4, 1)])
def test_geometry_sweep(itemsize, vec):
  """Group sizes from 1 element to 64 M, around each boundary of the
  second kernel's chunk, over 1 to 384 units."""
  rng = np.random.default_rng(itemsize * 10 + vec)
  sizes = {1, 2, vec, vec + 1, 49, 1_000_003, 1 << 26}
  for k in range(1, 9):
    edge = k * (PASS_BYTES // itemsize)
    sizes |= {edge - 1, edge, edge + 1}
  sizes |= set(int(v) for v in np.exp(rng.uniform(0, np.log(1 << 26), 200)))
  for units in (1, 16, 384):
    for n in sorted(sizes):
      check_geometry(n, itemsize, vec, units)


def test_geometry_of_a_large_group():
  """bf16, 16 groups of 917,505 elements: 48 KB a CTA of the second
  kernel (38 CTAs, whole vectors), the first's 17 CTAs a group, about
  MIN_CTAS in all."""
  assert launch_geometry(917_505, 2, 8, 16) == (38, 24_152, 17, 53_976)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("name,shape,groups",
                         sorted({(n, s, g) for n, s, g, _ in TFPP_NORMS
                                 if ".b0." in n or n.endswith("stem")}))
def test_geometry_channels_last(name, shape, groups, itemsize):
  """A channels-last map (the branches' layout) over whole samples:
  chunks of whole rows of C channels covering the sample exactly once,
  within 48 KB a CTA of the second kernel; the first kernel's CTAs each
  take an even share of S / (MIN_CTAS / B) rows, the second's no more."""
  C, S = shape[1], math.prod(shape[2:])
  B = shape[0]
  mchunk = check_geometry(S * C, itemsize, C, B)[3]
  spread = min(-(-MIN_CTAS // B), S)
  assert mchunk // C == -(-S // spread)


def random_map(shape, dtype, seed):
  g = torch.Generator().manual_seed(seed)
  return (torch.randn(shape, generator=g) * 2.0 + 0.7).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((2, 72, 6, 10), 24),
                                          ((2, 64, 3, 4, 5), 32),
                                          ((3, 16, 7, 7), 16)])
def test_group_norm_relu_is_relu_of_output(shape, groups, dtype):
  """relu=True equals torch.relu of today's output, bit for bit (the CPU
  runs the plain version, the card fuses the ReLU into the kernel)."""
  m = TpuGroupNorm(groups, shape[1])
  with torch.no_grad():
    m.scale.copy_(torch.linspace(-1.5, 2.0, shape[1]))
    m.bias.copy_(torch.linspace(0.5, -0.5, shape[1]))
  m = m.to(dtype)
  x = random_map(shape, dtype, seed=shape[1])
  y = m(x)
  assert y.dtype == dtype
  assert torch.equal(m(x, relu=True), torch.relu(y))
  assert bool((y < 0).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channel_affine_relu_is_relu_of_output(dtype):
  m = backbones.ChannelAffineNorm(12)
  with torch.no_grad():
    m.scale.copy_(torch.linspace(-1.0, 1.0, 12))
    m.bias.copy_(torch.linspace(0.3, -0.3, 12))
  m = m.to(dtype)
  x = random_map((2, 12, 5, 6), dtype, seed=3)
  y = m(x)
  assert torch.equal(m(x, relu=True), torch.relu(y))
  assert bool((y < 0).any())


@pytest.mark.parametrize("norm_kind", ["gn", "bn_affine"])
def test_regnety_blocks_relu_in_norm(norm_kind):
  """The stem and YBlock call their norms with relu=True; the output
  equals the old form, torch.relu after the norm."""
  torch.manual_seed(0)
  stem = backbones.RegNetYStem(3, 16, norm_kind)
  block = backbones.YBlock(16, 32, 2, 16, 0.25, norm_kind)
  x = torch.randn(2, 3, 16, 20)
  h = stem(x)
  assert torch.equal(h, torch.relu(stem.norm(stem.conv(x))))
  ref = torch.relu(block.norm1(block.conv1(h)))
  ref = block.se(torch.relu(block.norm2(block.conv2(ref))))
  ref = block.norm3(block.conv3(ref))
  ref = torch.relu(block.down_norm(block.down_conv(h)) + ref)
  assert torch.equal(block(h), ref)


def test_micro_forward_norm_inputs_channels_last():
  """Every GroupNorm of the TransFuser++ forward gets a channels-last map:
  the backbone's inputs are permuted NHWC tensors, and each convolution
  keeps its input's layout. The kernel takes that layout (and a contiguous
  one) and raises on any other."""
  torch.manual_seed(0)
  tcfg = micro_config()
  model = LidarCenterNet(tcfg).eval()
  seen = []

  def hook(mod, args):
    seen.append(args[0].is_contiguous(memory_format=torch.channels_last))

  for m in model.modules():
    if isinstance(m, TpuGroupNorm):
      m.register_forward_pre_hook(hook)
  with torch.no_grad():
    model(torch.rand(2, tcfg.img_h, tcfg.img_w, 3) * 255,
          torch.rand(2, tcfg.lidar_h, tcfg.lidar_w, tcfg.lidar_channels),
          torch.zeros(2, 2), torch.nn.functional.one_hot(
              torch.tensor([1, 2]), 6).float(), torch.zeros(2))
  assert len(seen) == 2 * len(kernel_cases.regnety_group_norms(
      2, (tcfg.img_h, tcfg.img_w), tcfg.image_arch))
  assert all(seen)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("needs", [(True, True, True), (True, False, False),
                                   (False, True, True)])
def test_backward_is_the_plain_versions(monkeypatch, relu, needs):
  """The autograd.Function's backward differentiates the plain version on
  the saved input: with the launch stood in for by the plain version, its
  gradients equal autograd's through the plain version, bit for bit."""
  monkeypatch.setattr(norm, "_launch", group_norm_plain)
  shape, groups = (2, 12, 5, 7), 4
  x0 = random_map(shape, torch.float32, seed=1)
  s0 = torch.linspace(-1.0, 2.0, 12)
  b0 = torch.linspace(0.4, -0.2, 12)
  dy = random_map(shape, torch.float32, seed=2)
  grads = []
  for fn in (norm._GroupNormKernel.apply, group_norm_plain):
    leaves = [t.clone().requires_grad_(need)
              for t, need in zip((x0, s0, b0), needs)]
    fn(*leaves, groups, 1e-6, relu).backward(dy)
    grads.append([t.grad for t in leaves])
  for got, want, need in zip(*grads, needs):
    if need:
      assert torch.equal(got, want)
    else:
      assert got is None and want is None
