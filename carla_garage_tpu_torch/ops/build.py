"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
for Hopper (``sm_90a``) into a shared library under ``build/kernels/`` at
the repository root (listed in ``.gitignore``). The library name carries
a hash of the source and the flags, so an edited source is rebuilt and a
built one is reused. Nothing is built when a module is imported: the
first call that needs a kernel builds it, and ``build_all`` builds every
kernel with one nvcc process per source, all started together.
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
KERNELS = {"raycast_boxes": "csrc/raycast_boxes.cu",
           "fill_boxes_bev": "csrc/fill_boxes_bev.cu",
           "span_markers": "csrc/span_markers.cu",
           "group_norm": "csrc/group_norm.cu"}

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


def _start(name: str):
  """Start nvcc for a kernel that is not built yet: (process, tmp, out),
  or None when its library exists."""
  out = library_path(name)
  if out.exists():
    return None
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_suffix(f".{os.getpid()}.tmp")
  cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_PKG / KERNELS[name])]
  proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
  return proc, tmp, out


def _finish(name: str, started) -> str:
  if started is None:
    return ""
  proc, tmp, out = started
  text, _ = proc.communicate()
  if proc.returncode != 0:
    raise RuntimeError(f"nvcc failed for {name}:\n{text}")
  os.replace(tmp, out)
  return text


def build_kernel(name: str) -> str:
  """Compile the kernel's library unless it is built already. Returns
  nvcc's output (ptxas's register report), empty when nothing was built;
  raises with that output if nvcc fails."""
  return _finish(name, _start(name))


def build_all() -> dict:
  """Build every kernel, one nvcc process per source, all running at once.
  Returns {name: nvcc's output} (empty for a library already built)."""
  started = {name: _start(name) for name in KERNELS}
  out, errors = {}, []
  for name, st in started.items():       # wait for every process
    try:
      out[name] = _finish(name, st)
    except RuntimeError as e:
      errors.append(str(e))
  if errors:
    raise RuntimeError("\n".join(errors))
  return out


def load_kernel(name: str) -> ctypes.CDLL:
  """The ctypes handle of a kernel library, built on first use."""
  if name not in _LOADED:
    build_kernel(name)
    _LOADED[name] = ctypes.CDLL(str(library_path(name)))
  return _LOADED[name]
