"""GPS <-> CARLA coordinate conversions (port of
carla_garage_tpu/utils/geodesy.py).

The reference converts GNSS readings to CARLA coordinates with a fixed
Mercator scale (nav_planner.py:64-77: scale [111324.60662786, 111319.490945]
and a 90-degree rotation) and locations to lat/lon via the inverse
(nav_planner._location_to_gps:246-266). Host numpy, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np

GPS_SCALE = np.array([111324.60662786, 111319.490945])
EARTH_RADIUS_EQUA = 6378137.0


def gps_to_carla(lat_lon: np.ndarray) -> np.ndarray:
  """[..,2] (lat, lon) -> CARLA (x, y). nav_planner.convert_gps_to_carla."""
  g = np.asarray(lat_lon) * GPS_SCALE
  return np.stack([g[..., 1], -g[..., 0]], -1)


def location_to_gps(xy, lat_ref: float = 42.0, lon_ref: float = 2.0):
  """CARLA (x, y) -> (lat, lon). nav_planner._location_to_gps."""
  scale = math.cos(lat_ref * math.pi / 180.0)
  mx = scale * lon_ref * math.pi * EARTH_RADIUS_EQUA / 180.0 + xy[..., 0]
  my = scale * EARTH_RADIUS_EQUA * math.log(
      math.tan((90.0 + lat_ref) * math.pi / 360.0)) - xy[..., 1]
  lon = mx * 180.0 / (math.pi * EARTH_RADIUS_EQUA * scale)
  lat = 360.0 * np.arctan(np.exp(my / (EARTH_RADIUS_EQUA * scale))) \
      / math.pi - 90.0
  return np.stack([lat, lon], -1)
