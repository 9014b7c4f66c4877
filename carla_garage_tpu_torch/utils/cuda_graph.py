"""Inference code replayed as CUDA graphs: a module's forward
(``GraphedForward``) and a chain of functions over pytrees
(``GraphedStages``, the simulator's tick after the policy).

``GraphedForward(module)`` is called as the module is: ``g(*args,
**kwargs)``. On the card, with autograd off, the module in eval mode and
autocast off, the module's forward runs as a replay of one CUDA graph:
its thousands of launches become one, and the host no longer sets the
pace of the forward. Anywhere else (the CPU, grad mode, a module in
training mode, an input off the card, a forward patched on the instance)
it calls the module eagerly.

The module is still called (``nn.Module.__call__``) and the replay
stands in for its ``forward`` for the length of the call, so the
module's own hooks fire once per call with the call's inputs and
outputs, as in eager. Hooks on its submodules fire only during warm-up
and capture, never in a replay.

A graph is captured on the first call for each signature (the inputs'
structure, shapes, strides, dtypes and devices, the plain scalars among
them, and the TF32 switches), after warm-up calls on a side stream; the
hooks fire in neither, and the capturing call returns the replay's
outputs of its own inputs. A replay copies the inputs into the graph's
buffers (one buffer for each place in the inputs, a few grouped launches),
so a forward that wrote into its inputs would write into those copies.
The graph reads the parameters and buffers where they lie: an in-place
update (an optimizer's step, ``load_state_dict``) shows in the next
replay, and where a parameter's or buffer's storage was replaced
(``.data =``, ``.to()``), every graph is dropped and captured again.
A parameter registered in place of another is not seen: build a new
``GraphedForward`` then.

Outputs: with ``copy_outputs`` (the default) the call returns copies,
which no later replay writes into. ``copy_outputs=False`` returns the
graph's own output buffers, which the next replay overwrites: for a
caller that makes new tensors of them at once (a dtype cast).

``GraphedStages()`` is called as ``g(stages, fixed, carry)``: for each
``(name, fn)`` of `stages` in order, ``carry = fn(fixed, carry)`` inside
``span(name)``; it returns the last carry. On the card each stage is a
graph of its own, captured back to back into one memory pool, so that
each reads the one before's outputs where they lie; a replay copies
`carry` in before the first and the last's outputs out into fresh
tensors after it, which no later replay writes into. `fixed` (a frozen
configuration, maps, a scene) is read where it lies: keyed by its
scalars' values and its tensors' shapes, and guarded by their data
pointers as the parameters are. It runs the stages eagerly where
``GraphedForward`` would.

The spans (``utils/profiling.py``): ``graph.capture`` around a capture
(opened outside the stream capture: a span's CUDA events recorded inside
it would become nodes of the graph) and ``graph.replay`` around the
replay with the inputs' copies (a stage's: with the carry's copies in the
first stage, the copies out in the last). Spans opened by the captured
code (where its warm-up opened any) become marker kernels in the graph
(``profiling.capturing``), which every replay runs where the span opened
and closed.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from carla_garage_tpu_torch.structs import tree_map
from carla_garage_tpu_torch.utils.profiling import capturing, opened, span

WARMUP = 2        # eager calls on a side stream before a capture
_SCALARS = (type(None), bool, int, float, str)
_FIELDS = {}      # dataclass type -> the names of its fields


def _fields(cls) -> tuple:
  names = _FIELDS.get(cls)
  if names is None:
    names = _FIELDS[cls] = tuple(f.name for f in dataclasses.fields(cls))
  return names


def _walk(x, key: list, tensors: list) -> bool:
  """Append `x`'s part of a signature to `key` and its tensors to
  `tensors`; False where it cannot be keyed. A function of the module, not
  a closure of ``_signature``: a closure that calls itself is a reference
  cycle, which would hold the call's tensors until the garbage collector
  ran."""
  if isinstance(x, torch.Tensor):
    if not x.is_cuda:
      return False
    key.append((tuple(x.shape), x.stride(), x.dtype, x.device))
    tensors.append(x)
    return True
  if isinstance(x, _SCALARS):
    key.append((type(x), x))
    return True
  cls = type(x)
  if hasattr(cls, "__dataclass_fields__"):
    key.append(cls)
    return all(_walk(getattr(x, f), key, tensors) for f in _fields(cls))
  if isinstance(x, (tuple, list)):
    key.append((cls, len(x)))
    return all(_walk(v, key, tensors) for v in x)
  if isinstance(x, dict):
    key.append((cls, tuple(x)))
    return all(_walk(v, key, tensors) for v in x.values())
  return False


def _signature(tree):
  """(key, tensors): a pytree's signature and its tensors in the order
  ``tree_map`` visits them; None where a tensor is off the card or a leaf
  is neither a tensor nor a plain scalar (the call then runs eagerly).

  The tree is dataclasses, tuples, lists and dicts; the key holds its
  structure (each node's type, a sequence's length, a dict's keys), each
  tensor's shape, strides, dtype and device, each scalar's type and value,
  and the TF32 switches."""
  key, tensors = [], []
  if not _walk(tree, key, tensors):
    return None
  key.append((torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32))
  return tuple(key), tensors


def _by_dtype(tensors: list) -> list:
  """The positions of `tensors` grouped by dtype and device, for one
  ``torch._foreach_copy_`` a group."""
  groups = {}
  for i, t in enumerate(tensors):
    groups.setdefault((t.dtype, t.device), []).append(i)
  return list(groups.values())


class _Graph:
  """Functions captured as CUDA graphs, one each, back to back in one
  memory pool: the first takes buffers shaped as the call's inputs (a
  pytree), each later one the outputs of the one before, read where they
  lie. Replay them in their order."""

  def __init__(self, stages: list, tree, tensors: list):
    self.inputs = [torch.empty_like(x) for x in tensors]
    it = iter(self.inputs)
    x = tree_map(lambda _: next(it), tree)
    self._in_groups = _by_dtype(self.inputs)
    self.copy_in(tensors)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    spans = opened()
    with torch.cuda.stream(side):
      for _ in range(WARMUP):
        y = x
        for fn in stages:
          y = fn(y)
    marks = opened() > spans
    pool = torch.cuda.graph_pool_handle()
    self.graphs = []
    # captured on the side stream as torch.cuda.graph does, without the
    # garbage collection and cache release it makes before each capture,
    # which added 3 s to a closed-loop run's set-up over the simulator's
    # four captures and free no memory a replay needs
    with torch.cuda.stream(side), capturing(marks=marks):
      for fn in stages:
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=pool)
        try:
          x = fn(x)
        finally:
          g.capture_end()
        self.graphs.append(g)
    torch.cuda.current_stream().wait_stream(side)
    self.outputs = x
    self._outs = []
    tree_map(self._outs.append, x)
    self._out_groups = _by_dtype(self._outs)

  def copy_in(self, tensors: list):
    for idx in self._in_groups:
      torch._foreach_copy_([self.inputs[i] for i in idx],
                           [tensors[i] for i in idx])

  def copy_out(self):
    """The outputs in fresh tensors, which no later replay writes into."""
    fresh = [torch.empty_like(t) for t in self._outs]
    for idx in self._out_groups:
      torch._foreach_copy_([fresh[i] for i in idx],
                           [self._outs[i] for i in idx])
    it = iter(fresh)
    return tree_map(lambda _: next(it), self.outputs)


def _eager_mode() -> bool:
  """Graphs are out: autograd or autocast on, or a capture running."""
  return (torch.is_grad_enabled() or torch.is_autocast_enabled() or
          torch.cuda.is_current_stream_capturing())


class GraphedForward:
  """`module`'s forward as a CUDA graph replay (see the module's
  docstring)."""

  def __init__(self, module: torch.nn.Module, copy_outputs: bool = True):
    self.module = module
    self.copy_outputs = copy_outputs
    self.graphs = {}          # signature -> _Graph
    self._state = []          # the parameters and buffers the graphs read
    self._ptrs = []           # their data pointers at capture

  def __call__(self, *args, **kwargs):
    m = self.module
    first = next(m.parameters(), None)
    if (m.training or first is None or not first.is_cuda or
        "forward" in m.__dict__ or _eager_mode()):
      return m(*args, **kwargs)
    m.forward = self._forward
    try:
      return m(*args, **kwargs)
    finally:
      del m.forward

  def _forward(self, *args, **kwargs):
    m = self.module
    call = (args, dict(sorted(kwargs.items())))
    sig = _signature(call)
    if sig is None:
      return type(m).forward(m, *args, **kwargs)
    key, tensors = sig
    if [t.data_ptr() for t in self._state] != self._ptrs:
      self.graphs.clear()
    g = self.graphs.get(key)
    if g is None:
      if not self.graphs:
        self._state = list(m.parameters()) + list(m.buffers())
        self._ptrs = [t.data_ptr() for t in self._state]
      forward = type(m).forward           # not the call: no hooks fire
      with torch.cuda.device(self._state[0].device), \
          span("graph.capture"):
        g = self.graphs[key] = _Graph(
            [lambda c: forward(m, *c[0], **c[1])], call, tensors)
    with span("graph.replay"):
      g.copy_in(tensors)
      g.graphs[0].replay()
    if self.copy_outputs:
      return g.copy_out()
    return g.outputs


class GraphedStages:
  """A chain of functions, each the body of one of the program's spans,
  replayed as CUDA graphs (see the module's docstring)."""

  def __init__(self):
    self.graphs = {}          # signature -> _Graph
    self._ptrs = None         # the data pointers of `fixed` at capture

  def __call__(self, stages: tuple, fixed, carry):
    sig = self._key(stages, fixed, carry)
    if sig is None:
      for name, fn in stages:
        with span(name):
          carry = fn(fixed, carry)
      return carry
    key, ptrs, tensors = sig
    if ptrs != self._ptrs:
      self.graphs.clear()
      self._ptrs = ptrs
    g = self.graphs.get(key)
    if g is None:
      with torch.cuda.device(tensors[0].device), span("graph.capture"):
        g = self.graphs[key] = _Graph(
            [functools.partial(fn, fixed) for _, fn in stages], carry,
            tensors)
    last = len(stages) - 1
    for i, (name, _) in enumerate(stages):
      with span(name), span("graph.replay"):
        if i == 0:
          g.copy_in(tensors)
        g.graphs[i].replay()
        if i == last:
          out = g.copy_out()
    return out

  @staticmethod
  def _key(stages, fixed, carry):
    """(key, the data pointers of `fixed`, the carry's tensors), or None
    where the stages run eagerly."""
    inputs = _signature(carry)
    if inputs is None or not inputs[1] or _eager_mode():
      return None
    held = _signature(fixed)
    if held is None:
      return None
    key = (tuple(name for name, _ in stages), held[0], inputs[0])
    return key, [t.data_ptr() for t in held[1]], inputs[1]
