"""Build the package's CUDA sources with ``nvcc``, load them with ctypes and
launch their entries: the one launch layer of the kernel modules.

Each library is compiled at first use from ``celeste_tpu_torch/csrc`` into
``celeste_tpu_torch/_build/<name>-<hash>.so`` (a directory git ignores),
where the hash covers the sources and the flags, so an edit rebuilds and an
unchanged tree reuses the file.  The sources have a plain C interface and
include no PyTorch header, which keeps a build to seconds.  Nothing here
runs when the package is imported: a machine without ``nvcc`` or a GPU can
import every module, and only a CUDA launch builds anything.

A kernel module describes its library once, as a :class:`Library`: name,
sources, flags and every C entry's signature as data (which the CPU tests
hold against ``csrc/``).  Its wrappers check their tensors with
:func:`check_tensor` and launch through :meth:`Library.launch`, which enters
the device, passes the current stream, raises on the entry's error code and
counts the launches that succeeded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# a signature's letters: a pointer, an array of pointers, an int
_ARGTYPES = {"p": ctypes.c_void_p, "a": ctypes.POINTER(ctypes.c_void_p), "i": ctypes.c_int}


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


class Library:
    """One CUDA library of ``csrc/``: its ``name``, its ``sources`` (file
    names under csrc/) and its own nvcc ``flags``, and in ``entries`` each C
    entry's signature, one letter a parameter (``p`` a pointer, ``a`` an
    array of pointers, ``i`` an int; every entry ends with the stream, a
    ``p``, and returns a CUDA error code, which ``<name>_error_string``
    turns into text).  ``counts`` holds the launch counters, one per entry
    unless ``counters`` names them."""

    def __init__(self, name: str, sources, entries: dict[str, str], flags=(), counters=None):
        self.name, self.sources, self.flags = name, tuple(sources), tuple(flags)
        self.entries = dict(entries)
        self.counts = dict.fromkeys(counters or self.entries, 0)
        self._cdll = None
        self._lock = threading.Lock()

    def declare(self, cdll: ctypes.CDLL) -> None:
        """Set the argtypes and restype of every entry of ``cdll``: this
        library, or another build of its sources."""
        for entry, signature in self.entries.items():
            fn = getattr(cdll, entry)
            fn.argtypes, fn.restype = [_ARGTYPES[c] for c in signature], ctypes.c_int
        fn = getattr(cdll, f"{self.name}_error_string")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p

    def load(self) -> ctypes.CDLL:
        """The library, built (if needed), loaded and declared once per
        process; different libraries build at once from several threads."""
        if self._cdll is None:
            with self._lock:
                if self._cdll is None:
                    cdll = ctypes.CDLL(str(build_library(self.name, self.sources, self.flags)))
                    self.declare(cdll)
                    self._cdll = cdll
        return self._cdll

    def build(self) -> Path:
        """Build and load the library now (it is otherwise built at the
        first launch).  Returns the path of the shared library."""
        return Path(self.load()._name)

    def launch(self, entry: str, device, *args, counter: str | None = None, at=None) -> None:
        """Call ``entry`` with ``args`` and the current stream of the CUDA
        ``device``, inside that device.  A nonzero error code raises
        ``RuntimeError`` naming the entry, the sizes in ``at`` (a dict, as
        ``{"B": 8, "C": 3}``) and the error, and counts nothing; a launch
        that succeeded counts one under ``counter`` (the entry's own by
        default)."""
        cdll = self.load()
        with torch.cuda.device(device):
            err = getattr(cdll, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
        if err:
            where = " at " + ", ".join(f"{k}={v}" for k, v in at.items()) if at else ""
            text = getattr(cdll, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{entry} launch failed{where}: {text} ({err})")
        self.counts[counter or entry] += 1

    def launch_counts(self) -> dict[str, int]:
        """The launches counted so far, by counter."""
        return dict(self.counts)

    def reset_launch_counts(self) -> None:
        for key in self.counts:
            self.counts[key] = 0


def cuda_device(t):
    """The device of ``t``; raises unless it is a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {t.device}")
    return t.device


def ptrs(tensors) -> list[int]:
    """The data pointers of ``tensors``, in order."""
    return [t.data_ptr() for t in tensors]


def check_tensor(t, name: str, shape, device, dtype=torch.float32) -> None:
    """Raise ``ValueError`` unless the tensor ``t`` (called ``name`` in the
    message) is on ``device`` with ``dtype`` and ``shape``, and contiguous."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
