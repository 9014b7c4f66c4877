"""ctypes binding of the native C++ grid router (``native/router.cpp``).

The repository's ``native/librouter.so`` is loaded as it is. Only when
that file is absent is ``native/router.cpp`` compiled with ``g++``, into
``build/native/`` at the repository root (git-ignored), never into
``native/``. ``maps/routing.RoadRouter`` takes this A* when it loads and
scipy's Dijkstra otherwise: the same choice as the JAX package's binding
of the same library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "native"


def _library() -> Path | None:
  """The shared library to load: native/librouter.so, or a g++ build of
  native/router.cpp when that is absent; None when neither exists."""
  so = NATIVE_DIR / "librouter.so"
  if so.exists():
    return so
  out = BUILD_DIR / "librouter.so"
  if out.exists():
    return out
  src = NATIVE_DIR / "router.cpp"
  if not src.exists():
    return None
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_suffix(f".{os.getpid()}.tmp")
  try:
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o",
                    str(tmp), str(src)], check=True, capture_output=True)
  except (OSError, subprocess.CalledProcessError):
    return None
  os.replace(tmp, out)
  return out


def _load():
  global _LIB, _TRIED
  if _LIB is not None or _TRIED:
    return _LIB
  _TRIED = True
  so = _library()
  if so is None:
    return None
  try:
    lib = ctypes.CDLL(str(so))
  except OSError:
    return None
  lib.route_grid.restype = ctypes.c_int32
  lib.route_grid.argtypes = [
      ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
      ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
      ctypes.c_float, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
  _LIB = lib
  return lib


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
