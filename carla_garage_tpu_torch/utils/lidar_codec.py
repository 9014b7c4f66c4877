"""LiDAR point-cloud compression, the ``.lzc`` format (port of
carla_garage_tpu/utils/lidar_codec.py; the reference's laszip role,
data_agent.py:359-369).

Layout: [int64 n][f32 scale][3 x f32 axis offset][for each axis x, y, z:
n LEB128 varints of zigzag(quantized deltas)], points quantized at `scale`
meters (default 2 mm) above each axis' minimum.

``compress`` / ``decompress`` run the repository's native codec
(``native/liblidar_codec.so``, else ``native/lidar_codec.cpp`` built with
g++ into ``build/native/``) and raise when it neither loads nor builds.
The JAX package falls back to its numpy encoder there, which rounds ties
differently (``np.round`` of a division, half to even, against the native
``lround`` of a multiplication by 1/scale, half away from zero): the same
sweep could then be stored as two different byte strings. ``compress_plain``
/ ``decompress_plain`` are those numpy versions, byte for byte.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from carla_garage_tpu_torch.utils import host_build

NATIVE_DIR = host_build.ROOT / "native"
DEFAULT_SCALE = 0.002
_HEADER = 24

_LIB = None


def library_path() -> Path:
  """The shared library the codec loads: the repository's
  native/liblidar_codec.so, or a g++ build of native/lidar_codec.cpp."""
  so = NATIVE_DIR / "liblidar_codec.so"
  if so.exists():
    return so
  return host_build.build(NATIVE_DIR / "lidar_codec.cpp", "lidar_codec")


def _lib() -> ctypes.CDLL:
  global _LIB
  if _LIB is None:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    _LIB = host_build.load(library_path(), {
        "lzc_compress": (i64, [p, i64, ctypes.c_float, p, i64]),
        "lzc_decompress": (i64, [p, i64, p, i64]),
    })
  return _LIB


def _points(points) -> np.ndarray:
  return np.ascontiguousarray(points, np.float32).reshape(-1, 3)


def compress(points: np.ndarray, scale: float = DEFAULT_SCALE) -> bytes:
  """float32 [N,3] -> .lzc bytes, through the native codec."""
  pts = _points(points)
  cap = _HEADER + 15 * 3 * max(len(pts), 1)
  out = np.empty((cap,), np.uint8)
  size = _lib().lzc_compress(pts.ctypes.data, len(pts), scale,
                             out.ctypes.data, cap)
  if size <= 0:
    raise RuntimeError(f"lzc_compress failed ({size}) for {len(pts)} points")
  return out[:size].tobytes()


def decompress(data: bytes) -> np.ndarray:
  """.lzc bytes -> float32 [N,3], through the native codec."""
  if len(data) < _HEADER:
    raise ValueError(f".lzc data of {len(data)} bytes has no header")
  n = int(np.frombuffer(data[:8], np.int64)[0])
  if n < 0:
    raise ValueError(f".lzc header holds {n} points")
  out = np.empty((n, 3), np.float32)
  buf = np.frombuffer(data, np.uint8)
  got = _lib().lzc_decompress(buf.ctypes.data, len(data), out.ctypes.data, n)
  if got != n:
    raise ValueError(f"malformed .lzc data: decoded {got} of {n} points")
  return out


def _quantize(pts: np.ndarray, scale: float):
  off = pts.min(0) if len(pts) else np.zeros((3,), np.float32)
  q = np.round((pts - off) / scale).astype(np.int64)
  return q, off.astype(np.float32)


def compress_plain(points: np.ndarray, scale: float = DEFAULT_SCALE) -> bytes:
  """The numpy encoder of the same format (JAX's ``_compress_py``)."""
  pts = _points(points)
  q, off = _quantize(pts, scale)
  head = (np.int64(len(pts)).tobytes() +
          np.float32(scale).tobytes() + off.tobytes())
  body = bytearray()
  for a in range(3):
    d = np.diff(q[:, a], prepend=0)
    zz = ((d << 1) ^ (d >> 63)).astype(np.uint64)
    for v in zz:
      v = int(v)
      while v >= 0x80:
        body.append((v & 0x7f) | 0x80)
        v >>= 7
      body.append(v)
  return head + bytes(body)


def decompress_plain(data: bytes) -> np.ndarray:
  """The numpy decoder of the same format (JAX's ``_decompress_py``)."""
  n = int(np.frombuffer(data[:8], np.int64)[0])
  scale = float(np.frombuffer(data[8:12], np.float32)[0])
  off = np.frombuffer(data[12:24], np.float32)
  buf = np.frombuffer(data, np.uint8)
  pos = _HEADER
  out = np.empty((n, 3), np.float32)
  for a in range(3):
    prev = 0
    for i in range(n):
      v, shift = 0, 0
      while True:
        b = int(buf[pos])
        pos += 1
        v |= (b & 0x7f) << shift
        if not b & 0x80:
          break
        shift += 7
      prev += (v >> 1) ^ -(v & 1)
      out[i, a] = prev * scale + off[a]
  return out
