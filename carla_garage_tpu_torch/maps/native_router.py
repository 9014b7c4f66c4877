"""ctypes binding of the native C++ grid router (``native/router.cpp``).

The repository's ``native/librouter.so`` is loaded as it is. Only when
that file is absent is ``native/router.cpp`` compiled with ``g++``, into
``build/native/`` at the repository root (git-ignored), never into
``native/`` (``utils/host_build.py``). ``maps/routing.RoadRouter`` takes
this A* when it loads and scipy's Dijkstra otherwise: the same choice as
the JAX package's binding of the same library.
"""

from __future__ import annotations

import ctypes

import numpy as np

from carla_garage_tpu_torch.utils import host_build

_LIB = None
_TRIED = False

NATIVE_DIR = host_build.ROOT / "native"


def _load():
  """The library: native/librouter.so, or a g++ build of native/router.cpp
  when that is absent; None when neither loads."""
  global _LIB, _TRIED
  if _LIB is not None or _TRIED:
    return _LIB
  _TRIED = True
  so = NATIVE_DIR / "librouter.so"
  try:
    if not so.exists():
      so = host_build.build(NATIVE_DIR / "router.cpp", "router")
    p, i32 = ctypes.POINTER, ctypes.c_int32
    _LIB = host_build.load(so, {"route_grid": (i32, [
        p(ctypes.c_uint8), p(ctypes.c_float), i32, i32, i32, i32,
        ctypes.c_float, p(i32), i32])})
  except (OSError, RuntimeError):         # no g++, a failed build, no .so
    return None
  return _LIB


def available() -> bool:
  return _load() is not None


def route_grid(grid: np.ndarray, penalty: np.ndarray, start: int,
               goal: int, cell_m: float, max_path: int = 65536):
  """A* path over the occupancy grid. Returns int32 cell indices
  (start..goal), or None if unreachable or the library is unavailable."""
  lib = _load()
  if lib is None:
    return None
  g = np.ascontiguousarray(grid.astype(np.uint8))
  p = np.ascontiguousarray(penalty.astype(np.float32))
  out = np.empty((max_path,), np.int32)
  n = lib.route_grid(
      g.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
      p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
      grid.shape[0], grid.shape[1], int(start), int(goal),
      float(cell_m), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
      max_path)
  if n <= 0:
    return None
  return out[:n].copy()
