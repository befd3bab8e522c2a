"""Build a hand-written CUDA kernel into a plain C-ABI shared library.

Each kernel's source under ``csrc/`` is compiled with ``nvcc`` for
``sm_90a`` at first use, into ``build/torch_kernels/`` of the checkout,
under a name keyed by a hash of that source and the flags, so an edited
source builds anew and an unchanged one is built once. ``load_library``
builds and loads it with ``ctypes`` once per process.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``nvcc`` on PATH, then under ``$CUDA_HOME/bin``, then in
    ``/usr/local/cuda/bin``; raises if none has it."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH, under $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin: the port's kernels cannot be "
                       "built")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build_library(source: Path) -> Path:
    """Compile ``source`` unless its build exists; returns the library's
    path. The compiler's output (with ``-Xptxas -v``: registers, shared
    memory and spills) is kept beside it as ``<name>.log``."""
    path = library_path(source)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(source)], capture_output=True, text=True)
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)       # atomic: concurrent builds race safely
    return path


def current_raw_stream(device_index: int) -> int:
    """The handle of the current CUDA stream of ``device_index``: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without making
    a ``Stream`` object (a tenth of its host time)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def call_on(device_index: int, fn, *args):
    """``fn(*args)`` with card ``device_index`` current, as a launch through
    a C interface needs (entering ``torch.cuda.device`` only where another
    card is current: it costs as much as the launch)."""
    if torch.cuda.current_device() == device_index:
        return fn(*args)
    with torch.cuda.device(device_index):
        return fn(*args)


_loaded: Dict[Path, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def load_library(source: Path,
                 bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library of ``source``, built and loaded at the first call, when
    ``bind`` sets its functions' argument and result types; later calls
    return the same handle."""
    lib = _loaded.get(source)
    if lib is not None:
        return lib
    with _load_lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(source)))
            bind(lib)
            _loaded[source] = lib
        return lib
