"""PNG and baseline JPEG, read and written on the host without PIL.

The reference's datasets keep camera frames as JPEG and label maps as PNG
(data_agent.py:341-372); the JAX package reads and writes them through
PIL, which the card's machine lacks. This module is the port's own codec,
one code path on every machine:

* PNG: 8-bit gray and RGB (RGBA is read with the alpha dropped). zlib
  and numpy here; the row filters, which run pixel by pixel, in C++.
* JPEG: baseline and extended sequential Huffman, 1 or 3 components,
  4:4:4, 4:2:2 and 4:2:0, restart intervals; entropy coding, DCTs,
  resampling and colour conversion in C++ (``csrc/host/image_codec.cpp``),
  which decodes as libjpeg does under PIL's defaults and encodes with
  libjpeg's arithmetic and the Annex-K tables scaled by its quality rule
  (``ops/jpeg.quality_tables``).

The C++ library is built with g++ at first use into ``build/native/``
(``utils/host_build.py``). Arrays are uint8, [H, W] or [H, W, 3].
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from carla_garage_tpu_torch.ops.jpeg import quality_tables
from carla_garage_tpu_torch.utils import host_build

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "host" / \
    "image_codec.cpp"
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# luma sampling factors (h, v) by chroma subsampling
SUBSAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}
_JPEG_ERRORS = {-1: "truncated", -2: "not a JPEG", -3: "unsupported",
                -4: "bad Huffman table or code", -5: "bad or missing table",
                -6: "buffer too small", -7: "corrupt data"}

_LIB = None


def library_path() -> Path:
  """The codec's shared library, compiled with g++ unless built already."""
  return host_build.build(_SRC, "image_codec")


def _lib() -> ctypes.CDLL:
  global _LIB
  if _LIB is None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    _LIB = host_build.load(library_path(), {
        "jpg_info": (i32, [p, i64, p, p, p]),
        "jpg_decode": (i32, [p, i64, p, i64]),
        "jpg_encode": (i64, [p, i32, i32, i32, p, p, i32, i32, i32, p, i64]),
        "png_unfilter": (i32, [p, i32, i32, i32, p]),
        "png_filter": (i32, [p, i32, i32, i32, p, p]),
    })
  return _LIB


def _ptr(a: np.ndarray) -> int:
  return a.ctypes.data


def _as_image(img) -> np.ndarray:
  a = np.ascontiguousarray(img)
  if a.dtype != np.uint8:
    raise TypeError(f"images are uint8, got {a.dtype}")
  if a.ndim == 3 and a.shape[2] == 1:
    a = np.ascontiguousarray(a[..., 0])
  if not (a.ndim == 2 or (a.ndim == 3 and a.shape[2] == 3)):
    raise ValueError(f"images are [H,W] or [H,W,3], got {a.shape}")
  return a


# ------------------------------------------------------------------ PNG --
def _chunk(kind: bytes, body: bytes) -> bytes:
  return (struct.pack(">I", len(body)) + kind + body +
          struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img, filter_type: int = 1) -> bytes:
  """[H,W] or [H,W,3] uint8 -> PNG bytes; every row with the given filter
  (0 none, 1 sub, 2 up, 3 average, 4 Paeth), zlib at PIL's level 6."""
  a = _as_image(img)
  if filter_type not in range(5):
    raise ValueError(f"PNG filter types are 0-4, got {filter_type}")
  h, w = a.shape[:2]
  bpp = 1 if a.ndim == 2 else 3
  raw = np.empty((h, 1 + w * bpp), np.uint8)
  types = np.full((h,), filter_type, np.uint8)
  _lib().png_filter(_ptr(a), h, w * bpp, bpp, _ptr(types), _ptr(raw))
  ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if bpp == 1 else 2, 0, 0, 0)
  return (_PNG_SIG + _chunk(b"IHDR", ihdr) +
          _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) +
          _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
  """PNG bytes -> uint8 [H,W] (gray) or [H,W,3] (RGB, or RGBA with the
  alpha dropped)."""
  if data[:8] != _PNG_SIG:
    raise ValueError("not a PNG file")
  pos, idat, ihdr = 8, [], None
  while pos + 8 <= len(data):
    n, kind = struct.unpack(">I4s", data[pos:pos + 8])
    body = data[pos + 8:pos + 8 + n]
    if len(body) != n:
      raise ValueError("truncated PNG chunk")
    if kind == b"IHDR":
      ihdr = struct.unpack(">IIBBBBB", body)
    elif kind == b"IDAT":
      idat.append(body)
    elif kind == b"IEND":
      break
    pos += 12 + n
  if ihdr is None or not idat:
    raise ValueError("PNG without IHDR or IDAT")
  w, h, depth, ctype, _, _, interlace = ihdr
  channels = {0: 1, 2: 3, 6: 4}.get(ctype)
  if depth != 8 or channels is None or interlace:
    raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                     f"{ctype}, interlace {interlace}")
  raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
  rowbytes = w * channels
  if raw.size != h * (rowbytes + 1):
    raise ValueError("PNG data size does not match its header")
  out = np.empty((h, w, channels), np.uint8)
  if _lib().png_unfilter(_ptr(raw), h, rowbytes, channels, _ptr(out)):
    raise ValueError("unknown PNG filter type")
  if channels == 1:
    return out[..., 0]
  return out[..., :3].copy() if channels == 4 else out


def read_png(path) -> np.ndarray:
  return decode_png(Path(path).read_bytes())


def write_png(path, img, filter_type: int = 1):
  Path(path).write_bytes(encode_png(img, filter_type))


# ----------------------------------------------------------------- JPEG --
def encode_jpeg(img, quality: int = 90, subsampling: str = "4:2:0",
                restart_interval: int = 0) -> bytes:
  """[H,W] or [H,W,3] uint8 -> baseline JPEG bytes at libjpeg's `quality`
  (subsampling applies to RGB; restart_interval in MCUs, 0 for none)."""
  a = _as_image(img)
  if subsampling not in SUBSAMPLING:
    raise ValueError(f"subsampling is one of {sorted(SUBSAMPLING)}")
  hs, vs = SUBSAMPLING[subsampling]
  h, w = a.shape[:2]
  nc = 1 if a.ndim == 2 else 3
  ql, qc = (np.ascontiguousarray(t, np.uint16)
            for t in quality_tables(quality))
  cap = 4096 + 2 * a.size + 64 * ((h // 8 + 2) * (w // 8 + 2))
  out = np.empty((cap,), np.uint8)
  n = _lib().jpg_encode(_ptr(a), w, h, nc, _ptr(ql), _ptr(qc), hs, vs,
                        restart_interval, _ptr(out), cap)
  if n < 0:
    raise ValueError(f"JPEG encode failed: {_JPEG_ERRORS.get(n, n)}")
  return out[:n].tobytes()


def decode_jpeg(data: bytes) -> np.ndarray:
  """JPEG bytes -> uint8 [H,W] (one component) or [H,W,3] (RGB)."""
  buf = np.frombuffer(data, np.uint8)
  dims = [ctypes.c_int() for _ in range(3)]
  lib = _lib()
  r = lib.jpg_info(_ptr(buf), buf.size, *(ctypes.addressof(d)
                                          for d in dims))
  if r:
    raise ValueError(f"JPEG header: {_JPEG_ERRORS.get(r, r)}")
  w, h, nc = (d.value for d in dims)
  if nc not in (1, 3):
    raise ValueError(f"unsupported JPEG: {nc} components")
  out = np.empty((h, w, nc), np.uint8)
  r = lib.jpg_decode(_ptr(buf), buf.size, _ptr(out), out.size)
  if r:
    raise ValueError(f"JPEG decode failed: {_JPEG_ERRORS.get(r, r)}")
  return out[..., 0] if nc == 1 else out


def read_jpeg(path) -> np.ndarray:
  return decode_jpeg(Path(path).read_bytes())


def write_jpeg(path, img, quality: int = 90, subsampling: str = "4:2:0",
               restart_interval: int = 0):
  Path(path).write_bytes(encode_jpeg(img, quality, subsampling,
                                     restart_interval))
