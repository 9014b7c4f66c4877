"""Dataset generation on the device (port of carla_garage_tpu/sim/datagen.py).

Batched expert rollouts emit training frames directly: the world advances
``SAVE_FREQ`` ticks per frame, and each frame records the world state and
the expert's labels as tensors stacked [F,B,...]. Labels that need the
future (waypoints) are computed afterwards by shifting the recorded
trajectory, as the reference reads future measurements
(data.py:812-838). A tick makes no host sync.

DAgger: ``collect_dagger_frames`` rolls a learned policy while the
expert's carry state rides along (``make_dagger_policy``), so every
recorded frame carries the expert's labels at a state the learned policy
reached. ``export_frames_jsonl`` writes one episode's frames as a JSONL
log on the host.
"""

from __future__ import annotations

import dataclasses
import gzip
import json

import torch

from portbench.reference.cgt.config import GlobalConfig
from portbench.reference.cgt.maps.town_map import LaneGraph, MapStack
from portbench.reference.cgt.sim import expert as expert_mod
from portbench.reference.cgt.sim import geometry as geo
from portbench.reference.cgt.sim.episode import sim_step
from portbench.reference.cgt.sim.route_planner import route_lookup
from portbench.reference.cgt.structs import Scene, SimState, Struct, tree_map

SAVE_FREQ = 5            # data_save_freq (config.py:86)
PRED_LEN = 8             # future waypoints (2 s at 4 Hz, config.py:118)


@dataclasses.dataclass
class Frames(Struct):
  """Stacked training frames [F,B,...] (F = frames at 4 Hz)."""
  ego_pos: torch.Tensor       # [F,B,2]
  ego_yaw: torch.Tensor       # [F,B]
  ego_speed: torch.Tensor     # [F,B]
  veh_pos: torch.Tensor       # [F,B,V,2]
  veh_yaw: torch.Tensor
  veh_speed: torch.Tensor
  veh_brake: torch.Tensor
  veh_extent: torch.Tensor    # [F,B,V,2]
  veh_valid: torch.Tensor
  wlk_pos: torch.Tensor       # [F,B,W,2]
  wlk_yaw: torch.Tensor
  wlk_speed: torch.Tensor
  wlk_extent: torch.Tensor
  wlk_valid: torch.Tensor
  target_point: torch.Tensor  # [F,B,2] ego frame (sparse route)
  command: torch.Tensor       # [F,B] int32 navigation command at the TP
  dense_idx: torch.Tensor     # [F,B] dense-planner pointer
  steer: torch.Tensor         # [F,B] expert action labels
  throttle: torch.Tensor
  brake: torch.Tensor
  target_speed: torch.Tensor  # [F,B] expert target speed (0 when braking)
  junction: torch.Tensor      # [F,B]
  light_hazard: torch.Tensor  # [F,B] expert red-light flag (PlanT input)
  stop_hazard: torch.Tensor   # [F,B] expert stop-sign flag
  time_s: torch.Tensor        # [F,B] sim time (recovers light states)
  alive: torch.Tensor         # [F,B] episode not done at this frame


def collect_expert_frames(cfg: GlobalConfig, maps: MapStack,
                          lanes: LaneGraph, scene: Scene, state: SimState,
                          n_frames: int,
                          generator: torch.Generator | None = None,
                          draws: list | None = None):
  """Roll the expert for n_frames * SAVE_FREQ ticks, recording one frame
  every SAVE_FREQ ticks. draws: one dict of the expert's draws per tick
  (n_frames * SAVE_FREQ of them), or None to draw from `generator`.
  Returns (final_state, Frames)."""
  frames = []
  for f in range(n_frames):
    for i in range(SAVE_FREQ):
      tick = draws[f * SAVE_FREQ + i] if draws is not None else None
      state = sim_step(cfg, maps, lanes, scene, state, generator=generator,
                       draws=tick)
    frames.append(_record_frame(cfg, scene, state))
  return state, tree_map(lambda *xs: torch.stack(xs), *frames)


def make_dagger_policy(model_policy):
  """Combine a learned policy with the expert into one policy: the MODEL
  drives (its controls reach the dynamics) while the expert's carry state
  (planners, PID, hazard flags) advances along the visited trajectory.

  The tick's draws are split by name: the expert takes its
  ``expert.DRAW_KEYS`` (steer_noise), the model the rest; what is not
  given each draws from the generator, the expert first. The updates
  merge with the model's winning a shared key."""
  def pol(cfg, maps, scene, state, generator=None, draws=None):
    draws = draws or {}
    ex_draws = {k: v for k, v in draws.items() if k in expert_mod.DRAW_KEYS}
    ag_draws = {k: v for k, v in draws.items()
                if k not in expert_mod.DRAW_KEYS}
    _, ex_upd = expert_mod.expert_step(cfg, maps, scene, state,
                                       generator=generator, draws=ex_draws)
    control, ag_upd = model_policy(cfg, maps, scene, state,
                                   generator=generator, draws=ag_draws)
    return control, {**ex_upd, **ag_upd}

  return pol


def collect_dagger_frames(cfg: GlobalConfig, maps: MapStack,
                          lanes: LaneGraph, scene: Scene, state: SimState,
                          policy, n_frames: int,
                          generator: torch.Generator | None = None,
                          draws: list | None = None):
  """DAgger datagen: roll the LEARNED policy for n_frames * SAVE_FREQ
  ticks, recording one frame every SAVE_FREQ ticks with the EXPERT's
  labels at the visited states (state.expert advances through
  ``make_dagger_policy``). draws: one dict per tick (the expert's, the
  policy's and the scenario engine's draws by name), or None to draw from
  `generator`. Returns (final_state, Frames).

  Route-relative labels (target speed, checkpoints, hazards, objects) are
  right; waypoint labels follow the policy's own trajectory and should be
  weighted 0."""
  combined = make_dagger_policy(policy)
  frames = []
  for f in range(n_frames):
    for i in range(SAVE_FREQ):
      tick = draws[f * SAVE_FREQ + i] if draws is not None else None
      state = sim_step(cfg, maps, lanes, scene, state, combined,
                       generator=generator, draws=tick)
    frames.append(_record_frame(cfg, scene, state))
  return state, tree_map(lambda *xs: torch.stack(xs), *frames)


def _record_frame(cfg: GlobalConfig, scene: Scene, st: SimState) -> Frames:
  """Snapshot one training frame (shared by the expert and DAgger
  collectors)."""
  ex = st.expert
  ego = st.ego
  route = scene.route
  tp_world, tp_cmd = route_lookup(route.sparse_points, route.sparse_cmd,
                                  route.sparse_num_valid,
                                  ex.planner_sparse.idx, 1)
  hazard = ex.vehicle_hazard | ex.walker_hazard | ex.light_hazard | \
      ex.stop_sign_hazard
  return Frames(
      ego_pos=ego.pos, ego_yaw=ego.yaw, ego_speed=ego.speed,
      veh_pos=st.vehicles.pos, veh_yaw=st.vehicles.yaw,
      veh_speed=st.vehicles.speed,
      veh_brake=st.vehicles.control[..., 2],
      veh_extent=st.vehicles.extent, veh_valid=st.vehicles.valid,
      wlk_pos=st.walkers.pos, wlk_yaw=st.walkers.yaw,
      wlk_speed=st.walkers.speed, wlk_extent=st.walkers.extent,
      wlk_valid=st.walkers.valid,
      target_point=geo.world_to_ego(tp_world, ego.pos, ego.yaw),
      command=tp_cmd.to(torch.int32),
      dense_idx=ex.planner_dense.idx,
      steer=ex.steer, throttle=torch.zeros_like(ex.steer),
      brake=hazard.to(torch.float32),
      target_speed=torch.where(hazard, 0.0, ex.target_speed),
      junction=ex.junction,
      light_hazard=ex.light_hazard.to(torch.float32),
      stop_hazard=(ex.stop_sign_hazard |
                   ex.stop_sign_close).to(torch.float32),
      time_s=st.time_s,
      alive=~st.done)


def export_frames_jsonl(frames: Frames, path: str, episode: int = 0):
  """Write one episode's frame log as JSONL (gzip for a '.gz' path): per
  frame the ego's pose, speed, steer and brake, and the valid vehicles and
  walkers, stopping at the first frame where the episode is done. The
  frames move to the host once."""
  f_np = {f.name: getattr(frames, f.name)[:, episode].cpu().numpy()
          for f in dataclasses.fields(frames)}
  op = gzip.open if path.endswith(".gz") else open
  with op(path, "wt") as f:
    for t in range(f_np["ego_pos"].shape[0]):
      if not bool(f_np["alive"][t]):
        break
      rec = {
          "frame": t,
          "ego": {"pos": f_np["ego_pos"][t].tolist(),
                  "yaw": float(f_np["ego_yaw"][t]),
                  "speed": float(f_np["ego_speed"][t]),
                  "steer": float(f_np["steer"][t]),
                  "brake": float(f_np["brake"][t])},
          "vehicles": [
              {"pos": f_np["veh_pos"][t, v].tolist(),
               "yaw": float(f_np["veh_yaw"][t, v]),
               "speed": float(f_np["veh_speed"][t, v])}
              for v in range(f_np["veh_yaw"].shape[1])
              if bool(f_np["veh_valid"][t, v])],
          "walkers": [
              {"pos": f_np["wlk_pos"][t, w].tolist()}
              for w in range(f_np["wlk_yaw"].shape[1])
              if bool(f_np["wlk_valid"][t, w])],
      }
      f.write(json.dumps(rec) + "\n")


def checkpoint_labels(frames: Frames, scene: Scene, n_ckpt: int,
                      spacing: int = 2) -> torch.Tensor:
  """Future route checkpoints in each frame's ego frame (the reference's
  smoothed route labels, data.py:1066-1138). [F,B,n_ckpt,2]."""
  F, B = frames.ego_yaw.shape
  R = scene.route.points.shape[1]
  offs = (torch.arange(n_ckpt, device=frames.dense_idx.device) + 1) * spacing
  q = (frames.dense_idx.long()[..., None] + offs).clamp(0, R - 1)  # [F,B,n]
  pts = torch.gather(scene.route.points[None].expand(F, B, R, 2), 2,
                     q[..., None].expand(-1, -1, -1, 2))
  return geo.world_to_ego(pts, frames.ego_pos[:, :, None],
                          frames.ego_yaw[:, :, None])


def waypoint_labels(frames: Frames):
  """Future ego positions in each frame's ego coordinates
  (data.py:812-838): label[t, k] = pose(t+k+1) in frame(t),
  k = 0..PRED_LEN-1. Frames within PRED_LEN of the end are masked.

  Returns (wp [F,B,PRED_LEN,2], valid [F,B])."""
  F = frames.ego_pos.shape[0]
  wp = torch.stack([
      geo.world_to_ego(torch.roll(frames.ego_pos, -(k + 1), 0),
                       frames.ego_pos, frames.ego_yaw)
      for k in range(PRED_LEN)], dim=2)
  has_future = torch.arange(F, device=wp.device) < (F - PRED_LEN)
  fut_alive = torch.roll(frames.alive, -PRED_LEN, 0)
  valid = frames.alive & fut_alive & has_future[:, None]
  return wp, valid


def target_speed_labels(frames: Frames, cfg: GlobalConfig,
                        brake_lookahead: int = 0) -> torch.Tensor:
  """Class index 0..3 (0 = brake; bins at walker/slow/fast + 0.1,
  config.py:144-148), int32 [F,B].

  brake_lookahead > 0 labels brake if the expert brakes within the next k
  frames, which supervises braking before the expert's own hazard flag
  latches."""
  e = cfg.expert
  ts = frames.target_speed
  braking = frames.brake > 0.5
  for k in range(1, brake_lookahead + 1):
    braking = braking | (torch.roll(frames.brake, -k, 0) > 0.5)
  cls = torch.where(ts <= e.target_speed_walker + 0.1, 1,
                    torch.where(ts <= e.target_speed_slow + 0.1, 2, 3))
  return torch.where(braking | (ts <= 0.01), 0, cls).to(torch.int32)
