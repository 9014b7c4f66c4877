"""agent_graph_share.eval: the share of the window's ``agent.inputs`` spans
(the PlanT policy's objects, route and flags, the larger of its two
stages before the forward) that hold a ``graph.replay`` span (the stage
replayed as a CUDA graph), in %, over the window's ticks outside the
traced stretch (as ``program_spans.layer_ms`` takes them). A replay of
the forward (``agent.model``) or of the simulator's layers does not
count. None where the program recorded no ``graph.*`` span at all: a
program without graphs, or a run on the CPU, where every stage runs
eagerly. Importing this file turns the program's recorder on."""

import sys

from portbench import program_spans

program_spans.turn_on()

LAYER, REPLAY = "agent.inputs", "graph.replay"


def read(rec):
  if rec.get("kind") != "eval":
    return None
  spans = program_spans.recorded()
  if not any(s.name.startswith("graph.") for s in spans):
    return None
  roots = program_spans.window_roots(rec, program_spans.ROOTS["eval"], spans)
  skip = set(rec["traced"])
  skip |= {i + 1 for i in skip}
  keep = {r.id for i, r in enumerate(roots) if i not in skip}
  layers = {s.id for s in spans if s.name == LAYER and s.root in keep}
  if not layers:
    return None
  parent = {s.id: s.parent for s in spans}
  held = set()
  for s in spans:
    if s.name == REPLAY:
      up = s.parent
      while up is not None and up not in layers:
        up = parent.get(up)
      held.add(up)
  held.discard(None)
  print(f"agent_graph_share: {len(held)} of {len(layers)} {LAYER} spans "
        f"hold {REPLAY}", file=sys.stderr)
  return 100.0 * len(held) / len(layers)
