"""Loss functions (port of carla_garage_tpu/ops/losses.py): label-smoothed
cross entropy, class-weighted focal cross entropy, masked L1.

``one_hot`` is a comparison with the class range, as ``jax.nn.one_hot``:
a label outside the range gives a zero row, and nothing is checked on the
host (``F.one_hot`` checks its labels, which waits for the device on the
CPU and asserts on the card).

Under a data-parallel mesh (``parallel/mesh.py``) each rank holds a slice
of the batch: a denominator that counts labels or weights is summed over
the ranks (detached), and a plain mean is the rank's share of the global
mean, so the ranks' losses sum to the global loss and their gradients to
the global gradient. ``mesh=None`` computes on the batch given."""

from __future__ import annotations

import torch

from portbench.reference.cgt.device import const
from portbench.reference.cgt.parallel.mesh import global_sum, share_mean


def one_hot(labels: torch.Tensor, num: int,
            dtype=torch.float32) -> torch.Tensor:
  return (labels[..., None] ==
          torch.arange(num, device=labels.device)).to(dtype)


def cross_entropy(logits, labels, weights=None, label_smoothing=0.0,
                  sample_weight=None, mesh=None):
  """CE over the last axis; labels int [..]. Per-class weights [C] optional;
  sample_weight broadcasts against the label shape (e.g. [B] per-sample
  quality gates). Returns the (weighted) mean over all elements."""
  num = logits.shape[-1]
  lab = one_hot(labels, num, logits.dtype)
  if label_smoothing > 0:
    lab = lab * (1 - label_smoothing) + label_smoothing / num
  logp = torch.log_softmax(logits, -1)
  ce = -torch.sum(lab * logp, -1)
  if weights is None and sample_weight is None:
    return share_mean(mesh, ce)
  w = torch.ones_like(ce)
  if weights is not None:
    w = w * const(weights, logits.device)[labels.long()]
  if sample_weight is not None:
    sw = sample_weight.reshape(sample_weight.shape +
                               (1,) * (ce.ndim - sample_weight.ndim))
    w = w * sw
  return torch.sum(ce * w) / torch.clamp(global_sum(mesh, torch.sum(w)),
                                         min=1e-6)


def focal_ce(logits, labels, gamma=2.0, weights=None, mesh=None):
  """Class-weighted focal cross entropy (focal_loss.py:1-134)."""
  logp = torch.log_softmax(logits, -1)
  p = torch.exp(logp)
  idx = labels.long()[..., None]
  pt = torch.gather(p, -1, idx)[..., 0]
  lpt = torch.gather(logp, -1, idx)[..., 0]
  loss = -torch.pow(1 - pt, gamma) * lpt
  if weights is not None:
    w = const(weights, logits.device)[labels.long()]
    return torch.sum(loss * w) / torch.clamp(global_sum(mesh, torch.sum(w)),
                                             min=1e-6)
  return share_mean(mesh, loss)


def l1_masked(pred, target, mask, mesh=None):
  """Mean absolute error over masked elements (avg-factor semantics of
  center_net.py:77-123)."""
  err = torch.abs(pred - target)
  m = mask.to(torch.float32)
  while m.ndim < err.ndim:
    m = m[..., None]
  m = m.expand(err.shape)
  return torch.sum(err * m) / torch.clamp(global_sum(mesh, torch.sum(m)),
                                          min=1e-6)
