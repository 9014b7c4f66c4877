"""Core world-state containers (port of carla_garage_tpu/structs.py).

The JAX package keeps the world state as flax ``struct.dataclass`` pytrees.
Here they are plain dataclasses of tensors with the same field names and
shapes, batch-first, with validity masks instead of actor churn.
``tree_map`` walks them leaf by leaf (the ``jax.tree.map`` counterpart),
``Struct.replace`` is ``flax.struct``'s ``replace`` and ``Struct.to`` moves
every tensor leaf to a device.

Shapes use these axis names:
  B — batch of parallel episodes, V — vehicle slots, W — walker slots,
  L — traffic-light slots, S — stop-sign slots, R — dense route points,
  n — PID window.

The JAX ``SimState.rng`` key has no field here: random draws come from a
``torch.Generator`` that the caller passes to ``sim_step``/``rollout``, or
as explicit tensors (see ``agents/sensor_agent.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Tuple

import torch


def tree_map(fn: Callable, tree, *rest):
  """Apply fn to every tensor leaf of tree (and the matching leaves of rest).

  Recurses into dataclasses, tuples, lists and dicts; any other leaf
  (None, a Python number, a generator) is returned unchanged."""
  if isinstance(tree, torch.Tensor):
    return fn(tree, *rest)
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    return dataclasses.replace(tree, **{
        f.name: tree_map(fn, getattr(tree, f.name),
                         *[getattr(r, f.name) for r in rest])
        for f in dataclasses.fields(tree)})
  if isinstance(tree, (tuple, list)):
    return type(tree)(tree_map(fn, t, *[r[i] for r in rest])
                      for i, t in enumerate(tree))
  if isinstance(tree, dict):
    return {k: tree_map(fn, v, *[r[k] for r in rest])
            for k, v in tree.items()}
  return tree


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
  """(path, tensor) for every tensor leaf, paths joined with '/'."""
  if isinstance(tree, torch.Tensor):
    yield prefix, tree
  elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    for f in dataclasses.fields(tree):
      yield from tree_items(getattr(tree, f.name), f"{prefix}/{f.name}")
  elif isinstance(tree, (tuple, list)):
    for i, t in enumerate(tree):
      yield from tree_items(t, f"{prefix}/{i}")
  elif isinstance(tree, dict):
    for k, v in tree.items():
      yield from tree_items(v, f"{prefix}/{k}")


class Struct:
  """Mixin for the state dataclasses: flax-style replace and device moves."""

  def replace(self, **kw):
    return dataclasses.replace(self, **kw)

  def to(self, device):
    return tree_map(lambda x: x.to(device), self)


class Cmd:
  """Navigation commands (CARLA RoadOption values, route_manipulation.py)."""
  VOID = -1
  LEFT = 1
  RIGHT = 2
  STRAIGHT = 3
  LANE_FOLLOW = 4
  CHANGE_LANE_LEFT = 5
  CHANGE_LANE_RIGHT = 6


class LightState:
  GREEN = 0
  YELLOW = 1
  RED = 2
  OFF = 3


@dataclasses.dataclass
class EgoState(Struct):
  """Ego kinematic state. pos [B,2] m, yaw [B] rad, speed [B] m/s (forward)."""
  pos: torch.Tensor
  yaw: torch.Tensor
  speed: torch.Tensor


@dataclasses.dataclass
class VehicleStates(Struct):
  """Background traffic. All [B,V...]; invalid slots are masked."""
  pos: torch.Tensor          # [B,V,2]
  yaw: torch.Tensor          # [B,V]
  speed: torch.Tensor        # [B,V]
  extent: torch.Tensor       # [B,V,2] half length/width
  valid: torch.Tensor        # [B,V] bool
  control: torch.Tensor      # [B,V,3] steer/throttle/brake currently applied
  buf_vel: torch.Tensor      # [B,V,SB] stuck-detection ring buffers
  buf_throttle: torch.Tensor
  buf_brake: torch.Tensor
  lane_id: torch.Tensor      # [B,V] int32 lane polyline followed
  lane_t: torch.Tensor       # [B,V] arc-position along the polyline (m)
  stand_ticks: torch.Tensor  # [B,V] int32 consecutive standstill ticks


@dataclasses.dataclass
class WalkerStates(Struct):
  pos: torch.Tensor          # [B,W,2]
  yaw: torch.Tensor          # [B,W]
  direction: torch.Tensor    # [B,W,2] unit walk direction
  speed: torch.Tensor        # [B,W]
  extent: torch.Tensor       # [B,W,2]
  valid: torch.Tensor        # [B,W] bool
  seen_frames: torch.Tensor  # [B,W] int32
  active: torch.Tensor       # [B,W] bool — crossing scenario triggered
  walked_m: torch.Tensor     # [B,W] meters walked since activation


@dataclasses.dataclass
class WalkerSpec(Struct):
  """Static crossing-scenario parameters (see the JAX WalkerSpec)."""
  trigger_dist: torch.Tensor  # [B,W]
  cross_dist: torch.Tensor    # [B,W]
  walk_speed: torch.Tensor    # [B,W]
  trigger_tta: torch.Tensor   # [B,W] seconds; 0 = distance-only


@dataclasses.dataclass
class TrafficLights(Struct):
  """Static light definitions; the state is a pure function of sim time."""
  pos: torch.Tensor          # [B,L,2] stop-line box center (world)
  yaw: torch.Tensor          # [B,L]
  extent: torch.Tensor       # [B,L,2]
  offset_s: torch.Tensor     # [B,L] phase offset in seconds
  green_s: torch.Tensor
  yellow_s: torch.Tensor
  red_s: torch.Tensor
  valid: torch.Tensor        # [B,L] bool

  def state_at(self, t: torch.Tensor) -> torch.Tensor:
    """Light state at sim time t [..] -> [..,L] int32."""
    cycle = self.green_s + self.yellow_s + self.red_s
    cycle = torch.where(cycle > 0, cycle, torch.ones_like(cycle))
    phase = torch.remainder(t[..., None] + self.offset_s, cycle)
    s = torch.where(phase < self.green_s, LightState.GREEN,
                    torch.where(phase < self.green_s + self.yellow_s,
                                LightState.YELLOW, LightState.RED))
    return torch.where(self.valid, s, LightState.OFF).to(torch.int32)


@dataclasses.dataclass
class StopSigns(Struct):
  pos: torch.Tensor          # [B,S,2] trigger-volume center
  yaw: torch.Tensor          # [B,S]
  extent: torch.Tensor       # [B,S,2]
  valid: torch.Tensor        # [B,S] bool


@dataclasses.dataclass
class Route(Struct):
  """Dense (1 m) and sparse (command) route arrays, padded to fixed length."""
  points: torch.Tensor          # [B,R,2]
  cmd: torch.Tensor             # [B,R] int32
  is_junction: torch.Tensor     # [B,R] bool
  seg_len: torch.Tensor         # [B,R] distance from point i-1 to i
  num_valid: torch.Tensor       # [B] int32
  sparse_points: torch.Tensor   # [B,Rs,2]
  sparse_cmd: torch.Tensor      # [B,Rs]
  sparse_num_valid: torch.Tensor  # [B] int32


@dataclasses.dataclass
class PIDState(Struct):
  """Length-n error window (nav_planner.PIDController semantics)."""
  window: torch.Tensor       # [...,n]

  @classmethod
  def create(cls, batch_shape, n, device="cuda"):
    from carla_garage_tpu_torch.device import resolve_device
    return cls(window=torch.zeros(tuple(batch_shape) + (n,),
                                  device=resolve_device(device)))


@dataclasses.dataclass
class PlannerState(Struct):
  """Windowed route-pointer planner state."""
  idx: torch.Tensor          # [B] int32 — first un-popped route point
  is_last: torch.Tensor      # [B] bool


@dataclasses.dataclass
class ExpertState(Struct):
  """Carry state of the privileged expert. The sensor-on loop carries it
  unchanged; the expert itself is ported in a later slice."""
  planner_dense: PlannerState
  planner_sparse: PlannerState
  pid_turn: PIDState
  pid_speed: PIDState
  steer: torch.Tensor             # [B]
  target_speed: torch.Tensor      # [B]
  junction: torch.Tensor          # [B] bool
  cleared_stop_signs: torch.Tensor  # [B,S] bool
  vehicle_hazard: torch.Tensor    # [B] bool
  walker_hazard: torch.Tensor
  light_hazard: torch.Tensor
  stop_sign_hazard: torch.Tensor
  walker_close: torch.Tensor
  stop_sign_close: torch.Tensor


@dataclasses.dataclass
class CriteriaState(Struct):
  """Per-episode infraction accumulators (see the JAX CriteriaState)."""
  penalty: torch.Tensor            # [B]
  n_collision_vehicle: torch.Tensor  # [B] int32
  n_collision_walker: torch.Tensor
  n_collision_static: torch.Tensor
  n_red_light: torch.Tensor
  n_stop_sign: torch.Tensor
  route_completion: torch.Tensor   # [B]
  max_route_idx: torch.Tensor      # [B] int32
  outside_lane_m: torch.Tensor     # [B]
  driven_m: torch.Tensor           # [B]
  blocked_ticks: torch.Tensor      # [B] int32
  deviated: torch.Tensor           # [B] bool
  blocked: torch.Tensor            # [B] bool
  timed_out: torch.Tensor          # [B] bool
  veh_overlap: torch.Tensor        # [B,V] int32 cooldown ticks
  wlk_overlap: torch.Tensor        # [B,W] int32
  static_overlap: torch.Tensor     # [B] int32
  red_light_cooldown: torch.Tensor  # [B,L] bool
  stop_pending: torch.Tensor       # [B,S] bool
  stop_done: torch.Tensor          # [B,S] bool
  stop_entered: torch.Tensor       # [B,S] bool
  event_pos: torch.Tensor          # [B,E,2]
  event_kind: torch.Tensor         # [B,E] int32 (EventKind)
  event_tick: torch.Tensor         # [B,E] int32
  event_count: torch.Tensor        # [B] int32


class EventKind:
  """Infraction event codes in CriteriaState.event_kind."""
  NONE = 0
  COLLISION_VEHICLE = 1
  COLLISION_WALKER = 2
  COLLISION_STATIC = 3
  RED_LIGHT = 4
  STOP_SIGN = 5


@dataclasses.dataclass
class SimState(Struct):
  """Full per-tick simulation state for a batch of episodes.

  `agent` is the learned policy's carry (empty tuple when none)."""
  tick: torch.Tensor         # [B] int32
  done: torch.Tensor         # [B] bool
  ego: EgoState
  vehicles: VehicleStates
  walkers: WalkerStates
  expert: ExpertState
  criteria: CriteriaState
  agent: Any = ()
  scenario: Any = ()

  @property
  def time_s(self) -> torch.Tensor:
    return self.tick.to(torch.float32) / 20.0


@dataclasses.dataclass
class Scene(Struct):
  """Read-only per-episode scene definition (batched over B)."""
  town_id: torch.Tensor      # [B] int32 index into the map stack
  route: Route
  lights: TrafficLights
  stops: StopSigns
  walkers_spec: WalkerSpec
  timeout_ticks: torch.Tensor  # [B] int32
  scenarios: Any = ()
