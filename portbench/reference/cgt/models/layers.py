"""Linear and LayerNorm that promote dtypes the way flax does.

flax computes a Dense or LayerNorm in the promoted type of its input and
its parameters, so in the JAX package's bf16 policy an f32 activation
meets bf16-rounded weights in f32 math (the join decoder after the f32
position embedding, the GRU head). torch's own layers refuse mixed
dtypes; these cast both sides to the promoted type instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(p, dt):
  return None if p is None else p.to(dt)


class Linear(nn.Linear):

  def forward(self, x):
    dt = torch.promote_types(x.dtype, self.weight.dtype)
    return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class LayerNorm(nn.LayerNorm):

  def forward(self, x):
    dt = torch.promote_types(x.dtype, self.weight.dtype)
    return F.layer_norm(x.to(dt), self.normalized_shape,
                        self.weight.to(dt), _cast(self.bias, dt), self.eps)
