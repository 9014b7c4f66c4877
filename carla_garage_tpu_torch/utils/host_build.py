"""Build the port's host-side C++ libraries with g++ and load them with
ctypes.

A library is built at first use into ``build/native/`` at the repository
root (git-ignored), under a name that carries a hash of its source and
flags, so an edited source is rebuilt and a built one is reused. Nothing is
built when a module is imported. A failed build raises with g++'s output:
the callers have no other path to fall back on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


def library_path(src: Path, name: str) -> Path:
  digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode())
  return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(src: Path, name: str) -> Path:
  """The path of `src`'s shared library, compiled with g++ unless it is
  built already."""
  out = library_path(src, name)
  if out.exists():
    return out
  gxx = shutil.which("g++")
  if gxx is None:
    raise RuntimeError(f"g++ not found: {src} is built with g++ at first use")
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_suffix(f".{os.getpid()}.tmp")
  proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(f"g++ failed for {src}:\n{proc.stderr}")
  os.replace(tmp, out)
  return out


def load(path: Path, signatures: dict) -> ctypes.CDLL:
  """ctypes handle of `path` with {function: (restype, argtypes)} set."""
  lib = ctypes.CDLL(str(path))
  for fn, (restype, argtypes) in signatures.items():
    getattr(lib, fn).restype = restype
    getattr(lib, fn).argtypes = argtypes
  return lib
