"""A module's inference forward replayed as a CUDA graph.

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
shapes, strides, dtypes and devices, the non-tensor arguments, and the
TF32 switches), after warm-up forwards on a side stream; the hooks fire
in neither, and the capturing call returns the replay's outputs of its
own inputs. A replay copies the inputs into the graph's buffers, so a
forward that wrote into its inputs would write into those copies. The
graph reads the parameters and buffers where they lie: an in-place
update (an optimizer's step, ``load_state_dict``) shows in the next
replay, and where a parameter's or buffer's storage was replaced
(``.data =``, ``.to()``), every graph is dropped and captured again.
A parameter registered in place of another is not seen: build a new
``GraphedForward`` then.

Outputs: with ``copy_outputs`` (the default) the call returns copies,
which no later replay writes into. ``copy_outputs=False`` returns the
graph's own output buffers, which the next replay overwrites: for a
caller that makes new tensors of them at once (a dtype cast).

The spans (``utils/profiling.py``): ``graph.capture`` around a capture
(opened outside the stream capture: a span's CUDA events recorded inside
it would become nodes of the graph) and ``graph.replay`` around the
inputs' copies and the replay. The module's own spans inside the capture
(where its warm-up opened any) become marker kernels in the graph
(``profiling.capturing``), which every replay runs where the span opened
and closed.
"""

from __future__ import annotations

import torch

from carla_garage_tpu_torch.structs import tree_map
from carla_garage_tpu_torch.utils.profiling import capturing, opened, span

WARMUP = 2        # eager forwards on a side stream before a capture
_SCALARS = (type(None), bool, int, float, str)


def _signature(args: tuple, kwargs: dict):
  """(key, tensors): the call's signature and its tensor inputs in order;
  None where an input tensor is off the card or an argument is neither a
  tensor nor a plain scalar (the call then runs eagerly)."""
  key, tensors = [], []
  for name, x in list(enumerate(args)) + sorted(kwargs.items()):
    if isinstance(x, torch.Tensor):
      if not x.is_cuda:
        return None
      key.append((name, tuple(x.shape), x.stride(), x.dtype, x.device))
      tensors.append(x)
    elif isinstance(x, _SCALARS):
      key.append((name, type(x), x))
    else:
      return None
  key.append((torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32))
  return tuple(key), tensors


class _Graph:
  """One captured forward: its graph, input buffers and outputs."""

  def __init__(self, module, args: tuple, kwargs: dict, tensors: list):
    forward = type(module).forward          # not the call: no hooks fire
    buffers = {id(x): torch.empty_like(x) for x in tensors}
    static = lambda x: buffers[id(x)] if isinstance(x, torch.Tensor) else x
    args = [static(x) for x in args]
    kwargs = {k: static(x) for k, x in kwargs.items()}
    self.inputs = [buffers[id(x)] for x in tensors]
    self.copy_in(tensors)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    spans = opened()
    with torch.cuda.stream(side):
      for _ in range(WARMUP):
        forward(module, *args, **kwargs)
    torch.cuda.current_stream().wait_stream(side)
    self.graph = torch.cuda.CUDAGraph()
    with capturing(marks=opened() > spans), torch.cuda.graph(self.graph):
      self.outputs = forward(module, *args, **kwargs)

  def copy_in(self, tensors: list):
    for dst, src in zip(self.inputs, tensors):
      dst.copy_(src)


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
    if (torch.is_grad_enabled() or m.training or first is None or
        not first.is_cuda or torch.is_autocast_enabled() or
        "forward" in m.__dict__):
      return m(*args, **kwargs)
    m.forward = self._forward
    try:
      return m(*args, **kwargs)
    finally:
      del m.forward

  def _forward(self, *args, **kwargs):
    m = self.module
    sig = _signature(args, kwargs)
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
      with torch.cuda.device(self._state[0].device), \
          span("graph.capture"):
        g = self.graphs[key] = _Graph(m, args, kwargs, tensors)
    with span("graph.replay"):
      g.copy_in(tensors)
      g.graph.replay()
    if self.copy_outputs:
      return tree_map(torch.clone, g.outputs)
    return g.outputs
