"""Build the port's CUDA kernel with nvcc and load it with ctypes.

The kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
for Hopper (``sm_90a``) into a shared library under ``build/kernels/`` at
the repository root (listed in ``.gitignore``). The library name carries
a hash of the source and the flags, so an edited source is rebuilt and a
built one is reused. Nothing is built when a module is imported: the
first call that needs the kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build" / "kernels"

# kernel name -> source, relative to the package
KERNELS = {"raycast_boxes": "csrc/raycast_boxes.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LOADED: dict = {}


def _nvcc() -> str:
  nvcc = shutil.which("nvcc")
  if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
    nvcc = "/usr/local/cuda/bin/nvcc"
  if nvcc is None:
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a host with the CUDA toolkit")
  return nvcc


def library_path(name: str) -> Path:
  src = (_PKG / KERNELS[name]).read_bytes()
  digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
  return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_kernel(name: str) -> str:
  """Compile the kernel's library unless it is built already. Returns
  nvcc's output (ptxas's register report), empty when nothing was built;
  raises with that output if nvcc fails."""
  out = library_path(name)
  if out.exists():
    return ""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_suffix(f".{os.getpid()}.tmp")
  cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_PKG / KERNELS[name])]
  proc = subprocess.run(cmd, capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                       f"{proc.stderr}")
  os.replace(tmp, out)
  return proc.stdout + proc.stderr


def load_kernel(name: str) -> ctypes.CDLL:
  """The ctypes handle of a kernel library, built on first use."""
  if name not in _LOADED:
    build_kernel(name)
    _LOADED[name] = ctypes.CDLL(str(library_path(name)))
  return _LOADED[name]
