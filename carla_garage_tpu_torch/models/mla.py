"""Multi-head latent attention (MLA) as DeepSeek-V2/V3 write it, in its
full form without a query LoRA (Kimi-VL's decoder) and without a cache:
each tick is one whole forward.

- ``q_proj``: H -> heads x (nope + rope); the query's last ``rope``
  dimensions of each head are rotated.
- ``kv_a_proj_with_mqa``: H -> latent + rope. The latent goes through an
  RMSNorm and ``kv_b_proj``: latent -> heads x (nope + v), the keys' first
  ``nope`` dimensions and the values; the other ``rope`` dimensions are
  one rotated key shared by every head.
- RoPE as the released code applies it: each head's ``rope`` dimensions
  taken as interleaved pairs, de-interleaved, then rotated in the
  rotate-half layout (``vla.apply_rope``), theta ``rope_theta``.
- Causal attention over the whole sequence at softmax scale
  (nope + rope)^-0.5, by ``scaled_dot_product_attention`` with keys of
  nope + rope dimensions and values of ``v``: on the H100 its cuDNN
  backend takes the unequal head dimensions (flash attention does not).
- ``o_proj``: heads x v -> H.

``MLA.forward(x [B, L, H], cos, sin) -> [B, L, H]`` in the parameters'
dtype, inside the span ``model.mla`` (counting the tokens).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from carla_garage_tpu_torch.models.vla import RMSNorm, apply_rope
from carla_garage_tpu_torch.utils.profiling import span


def deinterleave(x: torch.Tensor) -> torch.Tensor:
  """[..., d] with pairs (2i, 2i+1) -> [..., d]: the pairs' first
  elements, then their second ones."""
  return x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)


class MLA(nn.Module):

  def __init__(self, hidden: int, heads: int, nope: int, rope: int, v: int,
               latent: int, eps: float):
    super().__init__()
    self.heads, self.nope, self.rope, self.v = heads, nope, rope, v
    self.latent = latent
    self.scale = (nope + rope) ** -0.5
    self.q_proj = nn.Linear(hidden, heads * (nope + rope), bias=False)
    self.kv_a_proj_with_mqa = nn.Linear(hidden, latent + rope, bias=False)
    self.kv_a_layernorm = RMSNorm(latent, eps)
    self.kv_b_proj = nn.Linear(latent, heads * (nope + v), bias=False)
    self.o_proj = nn.Linear(heads * v, hidden, bias=False)

  def forward(self, x, cos, sin):
    """x [B, L, H]; cos, sin [L, rope] (``vla.rope_cos_sin``)."""
    B, L, _ = x.shape
    n, r = self.heads, self.rope
    with span("model.mla", count=B * L):
      q = self.q_proj(x).view(B, L, n, self.nope + r).transpose(1, 2)
      q_nope, q_pe = q.split([self.nope, r], -1)
      latent, k_pe = self.kv_a_proj_with_mqa(x).split([self.latent, r], -1)
      kv = self.kv_b_proj(self.kv_a_layernorm(latent)) \
          .view(B, L, n, self.nope + self.v).transpose(1, 2)
      k_nope, v = kv.split([self.nope, self.v], -1)
      q_pe = apply_rope(deinterleave(q_pe), cos, sin)
      k_pe = apply_rope(deinterleave(k_pe[:, None]), cos, sin)
      q = torch.cat([q_nope, q_pe], -1)
      k = torch.cat([k_nope, k_pe.expand(B, n, L, r)], -1)
      o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         scale=self.scale)
      return self.o_proj(o.transpose(1, 2).reshape(B, L, n * self.v))
