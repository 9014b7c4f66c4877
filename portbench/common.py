"""What the drivers share: CUDA-event spans, copies of state trees,
percentiles and the gaps that decide ``correct``."""

from __future__ import annotations

import dataclasses
import math

import torch


class EventLog:
  """CUDA events recorded on the current stream at named points; they need
  no host sync and add none. Read after the window's last sync."""

  def __init__(self, enabled: bool):
    self.enabled = enabled
    self.events = {}

  def mark(self, name: str):
    if not self.enabled:
      return
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    self.events.setdefault(name, []).append(ev)

  def gaps_ms(self, a: str, b: str, shift: int = 0) -> list:
    """ms from each event `a` to the event `b` of the same index plus
    `shift` (shift=1 with a == b gives consecutive gaps)."""
    ea, eb = self.events.get(a, []), self.events.get(b, [])
    n = min(len(ea), len(eb) - shift)
    return [ea[i].elapsed_time(eb[i + shift]) for i in range(max(n, 0))]


def clone_tree(x):
  """A deep copy of tensors inside dataclasses, dicts, lists and tuples."""
  return tree_map_tensors(lambda t: t.detach().clone(), x)


def tree_map_tensors(fn, x):
  """fn applied to every tensor inside dataclasses, dicts, lists and
  tuples."""
  if isinstance(x, torch.Tensor):
    return fn(x)
  if dataclasses.is_dataclass(x) and not isinstance(x, type):
    return type(x)(**{f.name: tree_map_tensors(fn, getattr(x, f.name))
                      for f in dataclasses.fields(x)})
  if isinstance(x, dict):
    return {k: tree_map_tensors(fn, v) for k, v in x.items()}
  if isinstance(x, (list, tuple)):
    return type(x)(tree_map_tensors(fn, v) for v in x)
  return x


def convert_tree(x, module_map: dict):
  """Rebuild dataclasses of one package as the same-named classes of
  another: module_map {source module prefix: target prefix}. Tensors are
  shared, not copied."""
  import importlib
  if dataclasses.is_dataclass(x) and not isinstance(x, type):
    mod = type(x).__module__
    for src, dst in module_map.items():
      if mod.startswith(src):
        mod = dst + mod[len(src):]
        break
    cls = getattr(importlib.import_module(mod), type(x).__name__)
    return cls(**{f.name: convert_tree(getattr(x, f.name), module_map)
                  for f in dataclasses.fields(x)})
  if isinstance(x, dict):
    return {k: convert_tree(v, module_map) for k, v in x.items()}
  if isinstance(x, (list, tuple)):
    return type(x)(convert_tree(v, module_map) for v in x)
  return x


TO_REFERENCE = {"carla_garage_tpu_torch": "portbench.reference.cgt"}


def leaves(x, prefix=""):
  """[(path, tensor)] of a tree's tensors."""
  if isinstance(x, torch.Tensor):
    return [(prefix, x)]
  if dataclasses.is_dataclass(x) and not isinstance(x, type):
    return [l for f in dataclasses.fields(x)
            for l in leaves(getattr(x, f.name), f"{prefix}.{f.name}")]
  if isinstance(x, dict):
    return [l for k, v in x.items() for l in leaves(v, f"{prefix}.{k}")]
  if isinstance(x, (list, tuple)):
    return [l for i, v in enumerate(x) for l in leaves(v, f"{prefix}[{i}]")]
  return []


def rel_gap(a: torch.Tensor, b: torch.Tensor, floor: float = 0.0) -> float:
  """max |a - b| over max(max |b|, floor), in float64; b is the
  reference. inf where the shapes differ or a holds a non-finite value
  that b does not."""
  if tuple(a.shape) != tuple(b.shape):
    return math.inf
  a64 = a.detach().to(torch.float64)
  b64 = b.detach().to(device=a64.device, dtype=torch.float64)
  both = torch.isfinite(a64) & torch.isfinite(b64)
  if bool((torch.isfinite(a64) != torch.isfinite(b64)).any()):
    return math.inf
  if a64.numel() == 0:
    return 0.0
  diff = float(torch.where(both, (a64 - b64).abs(), 0.0).max())
  scale = max(float(torch.where(both, b64.abs(), 0.0).max()), floor)
  return diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)


def tree_gap(prog, ref, floor: float = 1.0) -> tuple:
  """(worst rel_gap over the leaves, its path), comparing leaves by path;
  a leaf on one side only is a gap of inf."""
  a, b = dict(leaves(prog)), dict(leaves(ref))
  worst, where = 0.0, ""
  for path in sorted(set(a) | set(b)):
    g = rel_gap(a[path], b[path], floor) if path in a and path in b \
        else math.inf
    if g > worst or (math.isinf(g) and not math.isinf(worst)):
      worst, where = g, path
  return worst, where


def norm_gap(prog, ref) -> tuple:
  """(|prog - ref|_2 / |ref|_2 over every leaf at once, the leaf with the
  largest share of the difference), comparing leaves by path in float64;
  a leaf on one side only, of another shape or not finite where the
  reference is, is inf."""
  a, b = dict(leaves(prog)), dict(leaves(ref))
  diff2, ref2, where, most = 0.0, 0.0, "", -1.0
  for path in sorted(set(a) | set(b)):
    if path not in a or path not in b or \
        tuple(a[path].shape) != tuple(b[path].shape):
      return math.inf, path
    x = a[path].detach().to(torch.float64)
    y = b[path].detach().to(device=x.device, dtype=torch.float64)
    if bool((torch.isfinite(x) != torch.isfinite(y)).any()):
      return math.inf, path
    ok = torch.isfinite(y)
    d = float(torch.where(ok, x - y, 0.0).square().sum())
    diff2 += d
    ref2 += float(torch.where(ok, y, 0.0).square().sum())
    if d > most:
      most, where = d, path
  if ref2 == 0:
    return (0.0 if diff2 == 0 else math.inf), where
  return math.sqrt(diff2 / ref2), where


def delta_gap(prev, prog, ref) -> tuple:
  """(worst gap of the step's change, its path): for each leaf the change
  from `prev` on each side, max |change_p - change_r| over the larger of
  max |change_r| and 1e-4 of the leaf's magnitude (at least 1), so that
  a ulp of round-off in a leaf that does not change reads about 1e-3; a
  leaf on one side only is inf."""
  a, b, s = dict(leaves(prog)), dict(leaves(ref)), dict(leaves(prev))
  worst, where = 0.0, ""
  for path in sorted(set(a) | set(b)):
    if path not in a or path not in b or path not in s or \
        tuple(a[path].shape) != tuple(b[path].shape):
      return math.inf, path
    s64 = s[path].detach().to(torch.float64)
    if tuple(s64.shape) != tuple(b[path].shape):
      return math.inf, path
    floor = 1e-4 * max(1.0, float(s64.abs().max()) if s64.numel() else 1.0)
    g = rel_gap(a[path].to(torch.float64) - s64,
                b[path].to(torch.float64) - s64.to(b[path].device), floor)
    if g > worst:
      worst, where = g, path
  return worst, where


def percentile(values: list, p: float) -> float:
  """The p-th percentile (0-100) by linear interpolation between the
  closest ranks (numpy's default)."""
  xs = sorted(values)
  if not xs:
    return math.nan
  k = (len(xs) - 1) * p / 100.0
  lo, hi = math.floor(k), math.ceil(k)
  return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)
