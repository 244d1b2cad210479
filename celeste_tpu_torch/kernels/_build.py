"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each library is compiled at first use from ``celeste_tpu_torch/csrc`` into
``celeste_tpu_torch/_build/<name>-<hash>.so`` (a directory git ignores),
where the hash covers the sources and the flags, so an edit rebuilds and an
unchanged tree reuses the file.  The sources have a plain C interface and
include no PyTorch header, which keeps a build to seconds.  Nothing here
runs when the package is imported: a machine without ``nvcc`` or a GPU can
import every module, and only a CUDA launch reaches this file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the "
                       "CUDA kernels of celeste_tpu_torch")


def build_library(name: str, sources, flags=()) -> Path:
    """Compile ``sources`` (file names under csrc/) into one shared library
    unless it is built; the file name carries the hash of the sources, the
    shared headers (csrc/*.cuh) and the flags (``NVCC_FLAGS`` and the
    library's own ``flags``)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for path in [CSRC_DIR / s for s in sources] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), *(str(CSRC_DIR / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


def load_library(name: str, sources, declare, flags=()) -> ctypes.CDLL:
    """Build (if needed) and load a library once per process;
    ``declare(lib)`` sets the argtypes and restype of every entry."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(name, sources, flags)))
            declare(lib)
            _loaded[name] = lib
        return lib
