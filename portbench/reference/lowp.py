"""The reference in float32 with TF32 off, and its control: the same
reference one precision below the configuration's.

The configuration's file names the control's precisions (``control``):
``model`` for the forward's arithmetic, ``inputs`` for what is handed to
the model, ``state`` for the simulator's float32 state. For a model in
bfloat16 the control runs every convolution and linear layer on float8
(e4m3) inputs and weights, each tensor scaled to its largest magnitude
(448 in e4m3), and accumulates in float32; the straight-through form
``x + (q(x) - x).detach()`` keeps it trainable. For float32 with TF32 off
the control turns TF32 on. The state's float32 goes to bfloat16.
"""

from __future__ import annotations

import contextlib
import copy

import torch
from torch.nn.utils import parametrize

E4M3_MAX = 448.0


def _set_tf32(on: bool):
  torch.backends.cuda.matmul.allow_tf32 = on
  torch.backends.cudnn.allow_tf32 = on


@contextlib.contextmanager
def exact_float32():
  """float32 matmuls and convolutions without TF32 inside."""
  old = (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32)
  _set_tf32(False)
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = old


@contextlib.contextmanager
def control_precision(precision: str):
  """TF32 on for a control whose model runs in "tf32"; nothing to set for
  "fp8", which is in the model (``control_model``)."""
  old = (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32)
  if precision == "tf32":
    _set_tf32(True)
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = old


def fp8(x: torch.Tensor) -> torch.Tensor:
  """x rounded to e4m3 at a per-tensor scale, straight through."""
  if not x.is_floating_point() or x.numel() == 0:
    return x
  scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
  q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
  return x + (q - x.detach())


def tf32(x: torch.Tensor) -> torch.Tensor:
  """x rounded to TF32's 10-bit mantissa (to nearest), straight through."""
  if x.dtype != torch.float32 or x.numel() == 0:
    return x
  bits = x.detach().contiguous().view(torch.int32)
  q = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
  q = torch.where(torch.isfinite(x.detach()), q, x.detach())
  return x + (q - x.detach())


def bf16(x: torch.Tensor) -> torch.Tensor:
  if not x.is_floating_point() or x.dtype == torch.bfloat16:
    return x
  return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x.detach())


ROUND = {"fp8": fp8, "tf32": tf32, "bf16": bf16}


def round_tree(x, precision: str):
  """Every floating tensor in x rounded to `precision`."""
  from portbench.common import tree_map_tensors
  return tree_map_tensors(lambda t: ROUND[precision](t)
                          if t.is_floating_point() else t, x)


def round_inputs(model: torch.nn.Module, precision: str):
  """A pre-hook that hands the model its inputs rounded to `precision`."""
  def hook(module, args):
    return tuple(round_tree(a, precision) for a in args)
  return model.register_forward_pre_hook(hook)


class _Fp8(torch.nn.Module):
  def forward(self, w):
    return fp8(w)


def _fp8_inputs(module, args):
  return tuple(fp8(a) if isinstance(a, torch.Tensor) else a for a in args)


def control_model(model: torch.nn.Module, precision: str):
  """The control of a bfloat16 configuration: a copy of `model` whose
  convolutions and linear layers see e4m3 inputs and weights. A float32
  configuration's control is the model itself under
  ``control_precision``."""
  if precision != "bf16":
    return copy.deepcopy(model)
  low = copy.deepcopy(model)
  for m in low.modules():
    if isinstance(m, (torch.nn.Linear, torch.nn.Conv1d, torch.nn.Conv2d,
                      torch.nn.Conv3d)):
      parametrize.register_parametrization(m, "weight", _Fp8())
      m.register_forward_pre_hook(_fp8_inputs)
  return low
