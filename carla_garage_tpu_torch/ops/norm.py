"""GroupNorm with the JAX package's numerics (port of
carla_garage_tpu/ops/norm.py ``TpuGroupNorm``): the CUDA kernel's wrapper
and its plain version.

Per-channel moments over the spatial axes in float32, aggregated per
group, variance as E[x^2] - E[x]^2 clipped at 0, eps 1e-6, then one
x * a + b pass. ``F.group_norm`` uses eps 1e-5 and another variance
formula, so it is not used. Works on NC... maps (channels at dim 1);
parameters are ``scale`` and ``bias`` [C] as in flax.

On CUDA tensors ``group_norm`` launches ``csrc/group_norm.cu`` (its header
says what bounds it on an H100 and what its design does about that), with
an optional ReLU applied before the store: two passes over a contiguous or
channels-last map (the RegNetY branches' layout, since their inputs are
permuted NHWC tensors), the sums, then a second read and the write. On
other tensors it runs ``group_norm_plain``, which the CPU tests hold
against the JAX package.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch import nn

# bytes of the map a CTA of the second kernel reads
PASS_BYTES = 48 * 1024
# CTAs of each kernel, about two an SM of an H100 (the best of 1, 2, 4, 8
# and 16 at the TransFuser++ shapes): the first kernel's CTAs take no more,
# so that each of the second's has few sums to add up
MIN_CTAS = 2 * 132
VECTOR_BYTES = 16        # one load or store a thread
THREADS = 256            # a CTA's threads (channels-last: the nearest
MAX_THREADS = 512        # multiple of C / vector width, up to this)


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, num_groups: int, eps: float = 1e-6,
                     relu: bool = False) -> torch.Tensor:
  """Plain PyTorch version: x [B,C,...] in any float dtype, scale and bias
  [C] -> x's shape and dtype; with relu, ``torch.relu`` of the output."""
  B, C = x.shape[:2]
  G = num_groups
  spatial = tuple(range(2, x.ndim))
  xf = x.float()
  m1 = xf.mean(spatial)                                 # [B,C]
  m2 = xf.square().mean(spatial)
  gm1 = m1.reshape(B, G, C // G).mean(-1)               # [B,G]
  gm2 = m2.reshape(B, G, C // G).mean(-1)
  var = torch.clamp(gm2 - gm1.square(), min=0.0)
  inv_c = torch.rsqrt(var + eps).repeat_interleave(C // G, -1)
  mean_c = gm1.repeat_interleave(C // G, -1)
  a = inv_c * scale.float()[None]
  b = bias.float()[None] - mean_c * a
  shape = (B, C) + (1,) * (x.ndim - 2)
  out = (xf * a.reshape(shape) + b.reshape(shape)).to(x.dtype)
  return torch.relu(out) if relu else out


def launch_geometry(n: int, itemsize: int, quantum: int, units: int):
  """How the kernel's two passes cover `units` units (groups of a
  contiguous map, samples of a channels-last one) of n elements of
  itemsize bytes: (parts, chunk, mparts, mchunk). The second kernel covers
  a unit with `parts` CTAs of `chunk` elements, about PASS_BYTES each; the
  first with `mparts` CTAs of `mchunk`, at least MIN_CTAS CTAs in all for
  each kernel where the units have the rows. A chunk is a multiple of
  `quantum` (the vector width, or a row of C channels); a unit's last CTA
  takes the rest."""
  def chunk_of(k):
    per_cta = -(-n // k)
    return -(-per_cta // quantum) * quantum

  rows = -(-n // quantum)
  spread = -(-MIN_CTAS // units)
  chunk = chunk_of(min(max(-(-n * itemsize // PASS_BYTES), spread), rows))
  mchunk = chunk_of(min(spread, rows))
  return -(-n // chunk), chunk, -(-n // mchunk), mchunk


_DTYPES = (torch.float32, torch.bfloat16)
_LAUNCH = None


def _launcher():
  """The kernel's C entry point, built and typed on first use."""
  global _LAUNCH
  if _LAUNCH is None:
    from carla_garage_tpu_torch.ops.build import load_kernel
    fn = load_kernel("group_norm").group_norm_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + \
        [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 9 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _LAUNCH = fn
  return _LAUNCH


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            num_groups: int, eps: float, relu: bool) -> torch.Tensor:
  """Checks the inputs and launches the kernel on the current stream."""
  if x.ndim < 3:
    raise ValueError(f"group_norm: x has shape {tuple(x.shape)}, needs "
                     "[B,C,...] with a spatial axis")
  B, C = x.shape[:2]
  if C % num_groups:
    raise ValueError(f"group_norm: {C} channels in {num_groups} groups")
  if x.dtype not in _DTYPES:
    raise TypeError(f"group_norm: x is {x.dtype}, needs float32 or bfloat16")
  for name, t in (("scale", scale), ("bias", bias)):
    if t.device != x.device:
      raise ValueError(f"group_norm: {name} on {t.device}, x on {x.device}")
    if t.dtype != x.dtype:
      raise TypeError(f"group_norm: {name} is {t.dtype}, x {x.dtype}: the "
                      "kernel takes one type")
    if not t.is_contiguous():
      raise ValueError(f"group_norm: {name} is not contiguous")
  if tuple(scale.shape) != (C,) or tuple(bias.shape) != (C,):
    raise ValueError(f"group_norm: scale {tuple(scale.shape)} and bias "
                     f"{tuple(bias.shape)} do not match [{C}]")
  channels_last = not x.is_contiguous()
  if channels_last and not (
      x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last) or
      x.ndim == 5 and x.is_contiguous(memory_format=torch.channels_last_3d)):
    raise ValueError(f"group_norm: x of strides {x.stride()} is neither "
                     "contiguous nor channels-last")
  y = torch.empty_like(x)                # in x's layout
  if y.numel() == 0:
    return y
  S = math.prod(x.shape[2:])
  G, cpg, itemsize = num_groups, C // num_groups, x.element_size()
  vec = VECTOR_BYTES // itemsize
  if (C if channels_last else S) % vec or x.data_ptr() % VECTOR_BYTES or \
      y.data_ptr() % VECTOR_BYTES:
    vec = 1
  if channels_last:
    cols = C // vec                      # a thread keeps to one column
    if cols > MAX_THREADS:
      raise ValueError(f"group_norm: a channels-last map of {C} channels "
                       f"takes {cols} threads a row, more than {MAX_THREADS}")
    threads = cols * max(1, THREADS // cols)
    units, unit, quantum = B, S * C, C
  else:
    threads, units, unit, quantum = THREADS, B * G, cpg * S, vec
  parts, chunk, mparts, mchunk = launch_geometry(unit, itemsize, quantum,
                                                 units)
  partials = torch.empty((units * mparts * (G if channels_last else 1), 2),
                         dtype=torch.float32, device=x.device)
  fn = _launcher()
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             partials.data_ptr(), units, unit, chunk, parts, mchunk, mparts,
             S, C, cpg, G,
             threads, int(channels_last), int(x.dtype == torch.bfloat16),
             vec, eps, int(relu), stream)
  if err != 0:
    raise RuntimeError(f"group_norm kernel launch failed: CUDA error {err}")
  group_norm.launches += 1
  return y


class _GroupNormKernel(torch.autograd.Function):
  """The kernel forward; the backward differentiates the plain version,
  recomputed on the saved input, so gradients are the plain version's."""

  @staticmethod
  def forward(ctx, x, scale, bias, num_groups, eps, relu):
    ctx.save_for_backward(x, scale, bias)
    ctx.config = (num_groups, eps, relu)
    return _launch(x, scale, bias, num_groups, eps, relu)

  @staticmethod
  def backward(ctx, dy):
    with torch.enable_grad():
      leaves = [t.detach().requires_grad_(need) for t, need in
                zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
      out = group_norm_plain(*leaves, *ctx.config)
      wanted = [t for t in leaves if t.requires_grad]
      grads = iter(torch.autograd.grad(out, wanted, dy))
    return tuple(next(grads) if t.requires_grad else None
                 for t in leaves) + (None, None, None)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-6,
               relu: bool = False) -> torch.Tensor:
  """x [B,C,...] contiguous or channels-last, float32 or bf16; scale, bias
  [C] -> x's shape, dtype and layout, ReLU'd with relu.

  On CUDA tensors it launches the kernel's two passes or raises;
  ``group_norm.launches`` counts the calls that launched them (each call
  is two kernel launches). On other tensors (the CPU's, or the meta device's that count a forward's
  operations) it runs ``group_norm_plain``."""
  if x.device.type == "cuda":
    return _GroupNormKernel.apply(x, scale, bias, num_groups, eps, relu)
  return group_norm_plain(x, scale, bias, num_groups, eps, relu)


group_norm.launches = 0


class TpuGroupNorm(nn.Module):

  def __init__(self, num_groups: int, num_channels: int,
               eps: float = 1e-6):
    super().__init__()
    if num_channels % num_groups:
      raise ValueError(f"{num_channels} channels in {num_groups} groups")
    self.num_groups = num_groups
    self.eps = eps
    self.scale = nn.Parameter(torch.ones(num_channels))
    self.bias = nn.Parameter(torch.zeros(num_channels))

  def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """relu=True returns ``torch.relu`` of the output, fused into the
    kernel's store on the card."""
    return group_norm(x, self.scale, self.bias, self.num_groups, self.eps,
                      relu)
