"""HuggingFace BertModel's ``inputs_embeds`` path (port of
carla_garage_tpu/models/bert.py), the encoder of PlanT.

embeddings = inputs_embeds + position_embeddings[:T] +
token_type_embeddings[0], LayerNorm (eps 1e-12), then n_layers post-LN
encoder blocks: self-attention with separate q/k/v projections, add +
LayerNorm, an exact-GELU intermediate dense, an output dense, add +
LayerNorm. No attention mask and no dropout (inference semantics, as the
JAX module runs). Parameter names follow the flax tree, so
``convert.load_flax_params`` loads a JAX encoder as it is.

flax's LayerNorm takes the variance as E[x^2] - E[x]^2; ``F.layer_norm``
takes E[(x - E[x])^2]. The two differ by float32 rounding only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.cgt.models.fusion import MultiHeadAttention
from portbench.reference.cgt.models.layers import LayerNorm, Linear

LN_EPS = 1e-12   # HF BertConfig.layer_norm_eps


class BertLayer(nn.Module):

  def __init__(self, hidden: int, n_heads: int, intermediate: int):
    super().__init__()
    self.attn = MultiHeadAttention(hidden, n_heads)
    self.attn_ln = LayerNorm(hidden, eps=LN_EPS)
    self.intermediate = Linear(hidden, intermediate)
    self.output = Linear(intermediate, hidden)
    self.output_ln = LayerNorm(hidden, eps=LN_EPS)

  def forward(self, x):
    x = self.attn_ln(x + self.attn(x, x))
    h = F.gelu(self.intermediate(x), approximate="none")
    return self.output_ln(x + self.output(h))


class BertEncoder(nn.Module):
  """BertModel(inputs_embeds=...).last_hidden_state (no pooler)."""

  def __init__(self, hidden: int = 512, n_layers: int = 8, n_heads: int = 8,
               intermediate: int = 2048, max_positions: int = 512):
    super().__init__()
    self.position_embeddings = nn.Parameter(
        torch.randn(max_positions, hidden) * 0.02)
    self.token_type_embeddings = nn.Parameter(torch.randn(2, hidden) * 0.02)
    self.emb_ln = LayerNorm(hidden, eps=LN_EPS)
    self.n_layers = n_layers
    for i in range(n_layers):
      self.add_module(f"layer{i}", BertLayer(hidden, n_heads, intermediate))

  def forward(self, inputs_embeds):
    T = inputs_embeds.shape[1]
    x = inputs_embeds + self.position_embeddings[None, :T] + \
        self.token_type_embeddings[0][None, None]
    x = self.emb_ln(x)
    for i in range(self.n_layers):
      x = getattr(self, f"layer{i}")(x)
    return x
