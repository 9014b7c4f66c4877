"""A mixture-of-experts layer as DeepSeek-V3 writes it (Kimi-VL's
decoder): a sigmoid router with a selection-only bias, routed SwiGLU
experts run as grouped GEMMs over tokens sorted by expert, and shared
experts that every token passes through.

- Router (``Router``): float32 logits of the token against a float32
  weight (kept float32 whatever the model's dtype), sigmoid scores; the
  top ``top_k`` experts are chosen on the score plus
  ``e_score_correction_bias``, and weighted by their unbiased scores,
  renormalised to sum to 1 and scaled by ``routed_scaling_factor``
  (``n_group`` = ``topk_group`` = 1: no group limit).
- Dispatch (``dispatch``): the token-expert pairs sorted by expert on the
  device (a stable ``argsort``), each expert's count by ``scatter_add_``
  into a zeroed buffer and the groups' end offsets by ``cumsum``: no host
  sync, so the layer stays inside a CUDA graph's capture. No token is
  dropped, none passes through an expert it did not choose, and no
  capacity is imposed; an expert may get no token.
- Experts (``Experts``): each expert's gate and up projections fused into
  one [2W, H] weight and its down projection [H, W], stacked over the
  experts. ``expert_swiglu`` runs them on the card as two
  ``torch._grouped_mm`` calls that read the offsets on the device (bf16,
  sm_90), the pair's router weight folded into the activations between
  them; elsewhere (the CPU, float32) as a loop over the experts, the
  plain path the tests hold the grouped one against.
- Combine: the pairs' outputs back in pair order (``index_copy_`` by the
  sort's permutation, every index once, so the sum is deterministic),
  summed over each token's ``top_k`` in float32, plus the shared experts'
  SwiGLU.

``MoE.forward(x [N, H], load=None, routes=None) -> [N, H] float32``, inside
the span ``model.moe`` (counting the token-expert pairs). ``load`` ([E],
int64) gains the tokens each expert took; ``routes`` ([N, top_k]) gets the
chosen experts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from carla_garage_tpu_torch.utils.profiling import span


class Router(nn.Module):

  def __init__(self, hidden: int, n_experts: int, top_k: int,
               scale: float):
    super().__init__()
    self.top_k, self.scale = top_k, scale
    self.weight = nn.Parameter(torch.zeros(n_experts, hidden))
    self.e_score_correction_bias = nn.Parameter(torch.zeros(n_experts))

  def forward(self, x):
    """x [N, H] -> (expert ids [N, top_k] int64, weights [N, top_k]
    float32)."""
    scores = F.linear(x.float(), self.weight.float()).sigmoid()
    choice = scores + self.e_score_correction_bias.float()
    ids = torch.topk(choice, self.top_k, dim=-1).indices
    w = scores.gather(1, ids)
    w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return ids, w * self.scale


def dispatch(ids: torch.Tensor, n_experts: int) -> tuple:
  """ids [N, k] -> (order [N*k]: the flat pair indices sorted by expert,
  stable; counts [E] int64; ends [E] int64, each group's end offset)."""
  flat = ids.reshape(-1)
  order = torch.argsort(flat, stable=True)
  counts = torch.zeros(n_experts, dtype=torch.int64, device=ids.device)
  counts.scatter_add_(0, flat, torch.ones_like(flat))
  return order, counts, torch.cumsum(counts, 0)


def grouped_available(x: torch.Tensor) -> bool:
  """Whether ``torch._grouped_mm`` runs this input: bf16 on an sm_90
  card."""
  return (x.is_cuda and x.dtype == torch.bfloat16 and
          hasattr(torch, "_grouped_mm") and
          torch.cuda.get_device_capability(x.device) >= (9, 0))


def expert_swiglu(x, ends, weight, gate_up, down, grouped: bool):
  """The routed experts over pairs sorted by expert: x [M, H] (group e in
  rows ends[e-1]..ends[e]), weight [M] each pair's router weight ->
  weight * down(silu(gate(x)) * up(x)) [M, H] in x's dtype."""
  W = down.shape[-1]
  if grouped:
    offs = ends.to(torch.int32)
    h = torch._grouped_mm(x, gate_up.transpose(-2, -1), offs=offs)
    a = (F.silu(h[:, :W]) * h[:, W:] * weight[:, None]).to(x.dtype)
    return torch._grouped_mm(a, down.transpose(-2, -1), offs=offs)
  out = x.new_zeros(x.shape[0], down.shape[1])
  start = 0
  for e, end in enumerate(ends.tolist()):
    if end > start:
      h = x[start:end] @ gate_up[e].t()
      a = (F.silu(h[:, :W]) * h[:, W:] * weight[start:end, None]) \
          .to(x.dtype)
      out[start:end] = a @ down[e].t()
    start = end
  return out


class Experts(nn.Module):
  """The routed experts' weights, stacked: gate_up [E, 2W, H] (each
  expert's gate rows, then its up rows), down [E, H, W]."""

  def __init__(self, n_experts: int, hidden: int, width: int):
    super().__init__()
    self.gate_up = nn.Parameter(torch.zeros(n_experts, 2 * width, hidden))
    self.down = nn.Parameter(torch.zeros(n_experts, hidden, width))


class SwiGLU(nn.Module):

  def __init__(self, hidden: int, width: int):
    super().__init__()
    self.gate_proj = nn.Linear(hidden, width, bias=False)
    self.up_proj = nn.Linear(hidden, width, bias=False)
    self.down_proj = nn.Linear(width, hidden, bias=False)

  def forward(self, x):
    return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MoE(nn.Module):

  def __init__(self, hidden: int, n_experts: int, top_k: int, width: int,
               n_shared: int, scale: float):
    super().__init__()
    self.n_experts, self.top_k = n_experts, top_k
    self.gate = Router(hidden, n_experts, top_k, scale)
    self.experts = Experts(n_experts, hidden, width)
    self.shared_experts = SwiGLU(hidden, width * n_shared)

  def forward(self, x, load=None, routes=None, grouped=None):
    """x [N, H] in the parameters' dtype -> [N, H] float32. grouped: the
    grouped GEMMs (True), the loop over experts (False), or where they
    run (None)."""
    N, k = x.shape[0], self.top_k
    with span("model.moe", count=N * k):
      ids, w = self.gate(x)
      order, counts, ends = dispatch(ids, self.n_experts)
      if load is not None:
        load.add_(counts)
      if routes is not None:
        routes.copy_(ids)
      xs = x.index_select(0, order // k)
      if grouped is None:
        grouped = grouped_available(xs)
      ys = expert_swiglu(xs, ends, w.reshape(-1).index_select(0, order),
                         self.experts.gate_up, self.experts.down, grouped)
      y = torch.empty_like(ys).index_copy_(0, order, ys)
      out = y.view(N, k, -1).sum(1, dtype=torch.float32)
      return out + self.shared_experts(x).float()
