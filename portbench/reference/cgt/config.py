"""Global configuration for the PyTorch port of the driving stack.

A copy of ``carla_garage_tpu/config.py``: the port imports nothing of the
JAX package, so it keeps its own registry, value for value the same.
Single registry of hyperparameters, mirroring the *role* of the reference's
``team_code/config.py:26-544`` (GlobalConfig) split into frozen, typed
sub-configs.

All behavioral constants (speeds, PID gains, radii, penalties, ...) are kept
numerically identical to the reference so that the expert / criteria are
behaviorally equivalent; each block cites the reference lines it mirrors.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SimConfig:
  """Core simulation constants (reference: config.py:26-61, leaderboard_evaluator_local.py:66)."""
  fps: int = 20                         # fixed-step synchronous sim rate
  dt: float = 1.0 / 20.0
  # Kinematic bicycle (World-on-Rails tuned constants, autopilot.py:1162-1207)
  front_wb: float = -0.090769015
  rear_wb: float = 1.4178275
  steer_gain: float = 0.36848336
  brake_accel: float = -4.952399
  throt_accel: float = 0.5633837
  # Ego bounding box extents (config.py:508-510, vehicle.lincoln.mkz2017 half-extents)
  ego_extent_x: float = 2.4508416652679443
  ego_extent_y: float = 1.0641621351242065
  ego_extent_z: float = 0.7553732395172119
  # Capacities (fixed shapes; reference spawns up to 500 traffic vehicles,
  # route_scenario_local.py:445-494 — we cap per-batch-element actor slots)
  max_vehicles: int = 32
  max_walkers: int = 8
  max_lights: int = 48
  max_stop_signs: int = 16
  max_route_points: int = 4096          # dense 1 m-spaced route points per episode
  route_window: int = 64                # look-ahead window for route queries


@dataclasses.dataclass(frozen=True)
class ExpertConfig:
  """Privileged expert constants (reference: config.py:29-61, :270-294)."""
  target_speed_slow: float = 5.0        # m/s at junctions
  target_speed_fast: float = 8.0        # m/s on open road
  target_speed_walker: float = 2.0      # m/s when a pedestrian is close
  steer_noise: float = 1e-3
  bicycle_frame_rate: int = 20
  extrapolation_seconds: float = 4.0
  extrapolation_seconds_no_junction: float = 1.0
  detection_radius: float = 30.0
  light_radius: float = 15.0
  safety_box_safety_margin: float = 2.5
  traffic_safety_box_length: float = 1.9
  traffic_safety_box_width_multiplier: float = 0.5
  stuck_buffer_size: int = 30
  stuck_vel_threshold: float = 0.1
  stuck_throttle_threshold: float = 0.1
  stuck_brake_threshold: float = 0.1
  # PID (config.py:279-294)
  turn_kp: float = 1.25
  turn_ki: float = 0.75
  turn_kd: float = 0.3
  turn_n: int = 20
  speed_kp: float = 5.0
  speed_ki: float = 0.5
  speed_kd: float = 1.0
  speed_n: int = 20
  brake_ratio: float = 1.1
  clip_delta: float = 0.25
  clip_throttle: float = 0.75
  # Route planners (config.py:493-497)
  route_planner_min_distance: float = 7.5
  route_planner_max_distance: float = 50.0
  dense_route_planner_min_distance: float = 3.5
  dense_route_planner_max_distance: float = 50.0
  num_route_points_saved: int = 20
  # Stuck/creep recovery (config.py:499-503)
  stuck_threshold: int = 1100
  creep_duration: int = 20
  creep_throttle: float = 0.4


@dataclasses.dataclass(frozen=True)
class CriteriaConfig:
  """Infraction / scoring constants (reference: statistics_manager_local.py:23-30,
  route_scenario_local.py:52-53 and :572-578, atomic_criteria_local.py)."""
  penalty_collision_pedestrian: float = 0.50
  penalty_collision_vehicle: float = 0.60
  penalty_collision_static: float = 0.65
  penalty_traffic_light: float = 0.70
  penalty_stop: float = 0.80            # 1.0 on Longest6 (set via benchmark flag)
  route_timeout_s_per_m: float = 0.8
  route_timeout_base_s: float = 5.0
  blocked_speed_threshold: float = 0.1  # m/s
  blocked_seconds: float = 180.0
  route_deviation_m: float = 30.0       # max distance from route before deviation
  min_route_completion: float = 0.99    # fraction counted as route completed
  # Collision dedup: same actor within this time window counts once
  # (atomic_criteria_local.py:300-437 spatial/temporal dedup)
  collision_dedup_seconds: float = 2.0


@dataclasses.dataclass(frozen=True)
class SensorConfig:
  """Sensor rig constants (reference: config.py:93-163)."""
  camera_width: int = 1024
  camera_height: int = 256
  camera_fov: float = 110.0
  camera_pos: Tuple[float, float, float] = (-1.5, 0.0, 2.0)
  lidar_pos: Tuple[float, float, float] = (0.0, 0.0, 2.5)
  lidar_rotation_frequency: int = 10
  lidar_points_per_second: int = 600_000
  # BEV / LiDAR grid (config.py:119-141)
  lidar_resolution_width: int = 256
  lidar_resolution_height: int = 256
  pixels_per_meter: float = 4.0
  hist_max_per_pixel: int = 5
  lidar_split_height: float = 0.2
  min_x: float = -32.0
  max_x: float = 32.0
  min_y: float = -32.0
  max_y: float = 32.0
  num_bev_semantic_classes: int = 11
  num_semantic_classes: int = 7


@dataclasses.dataclass(frozen=True)
class GlobalConfig:
  sim: SimConfig = dataclasses.field(default_factory=SimConfig)
  expert: ExpertConfig = dataclasses.field(default_factory=ExpertConfig)
  criteria: CriteriaConfig = dataclasses.field(default_factory=CriteriaConfig)
  sensor: SensorConfig = dataclasses.field(default_factory=SensorConfig)

  def replace(self, **kw) -> "GlobalConfig":
    return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = GlobalConfig()


def longest6_config() -> GlobalConfig:
  """Longest6 benchmark overrides: stop-sign penalty 1.0
  (statistics_manager_local.py:28-30)."""
  cfg = GlobalConfig()
  return cfg.replace(criteria=dataclasses.replace(cfg.criteria, penalty_stop=1.0))
