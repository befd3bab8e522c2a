"""GQA decode attention vs a ring KV cache: the hand-written Hopper kernel
(``csrc/decode_attention.cu``) and its wrapper.

The kernel replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention``. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface at
first use, under ``build/torch_kernels/`` of the checkout, keyed by a hash of
its source, and loaded with ``ctypes``. A tensor on the CPU takes the plain
version (``ref.decode_attention_ref``); a CUDA tensor launches the kernel or
raises. ``decode_attention.launches`` counts the launches.
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

from repro_torch.kernels.ref import decode_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# (q dtype, kv dtype) pairs the kernel takes; the output has q's dtype
DTYPES = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)}
MAX_HEAD_DIM = 256
MAX_GROUP_ELEMS = 4096        # G * D: 256 threads x 16 accumulators

_lib = None
_lib_lock = threading.Lock()


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
                       "/usr/local/cuda/bin: the decode_attention kernel "
                       "cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"decode_attention-{digest}.so"


def build_library() -> Path:
    """Compile the kernel's shared library unless this source's build exists;
    returns its path. The compiler's output (with ``-Xptxas -v``: registers,
    shared memory and spills) is kept beside it as ``<name>.log``."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)       # atomic: concurrent builders race safely
    return path


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            fn = lib.coserve_decode_attention
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.coserve_decode_attention_splits.argtypes = [ctypes.c_int] * 4
            lib.coserve_decode_attention_splits.restype = ctypes.c_int
            lib.coserve_cuda_error_string.argtypes = [ctypes.c_int]
            lib.coserve_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(q, k_cache, v_cache, window: int):
    if not (q.is_cuda and k_cache.device == q.device
            and v_cache.device == q.device):
        raise ValueError("decode_attention: q, k_cache and v_cache must lie "
                         f"on one CUDA device, got {q.device}, "
                         f"{k_cache.device}, {v_cache.device}")
    if (q.dtype, k_cache.dtype) not in DTYPES or v_cache.dtype != k_cache.dtype:
        raise TypeError("decode_attention takes (q, kv) dtypes fp32/fp32, "
                        "bf16/bf16 or fp32/bf16, got "
                        f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("decode_attention: q [B,H,D], caches [B,Hkv,W,D]; "
                         f"got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, h, d = q.shape
    kb, hkv, w, kd = k_cache.shape
    if kb != b or kd != d or hkv == 0 or h % hkv or w == 0:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not fit "
                         f"caches {tuple(k_cache.shape)}")
    if d % 32 or d > MAX_HEAD_DIM or (h // hkv) * d > MAX_GROUP_ELEMS:
        raise ValueError(f"decode_attention: head_dim {d} must be a multiple "
                         f"of 32 up to {MAX_HEAD_DIM}, and group x head_dim "
                         f"{(h // hkv) * d} at most {MAX_GROUP_ELEMS}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("decode_attention: inputs must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention: the caches must start on a "
                         "16-byte boundary (the kernel reads 16-byte vectors)")
    if window < 0:
        raise ValueError(f"decode_attention: window {window} < 0")


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0):
    """q: [B,H,D]; caches: [B,Hkv,W,D]; pos: absolute position of the new
    token -> [B,H,D] in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, pos, window=window)
    _check(q, k_cache, v_cache, window)
    lib = _library()
    b, h, d = q.shape
    hkv, w = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = lib.coserve_decode_attention_splits(b, hkv, w, sms)
    out = torch.empty_like(q)
    # partial (acc, m, l) of each split, combined by the second kernel
    ws = torch.empty(b * hkv * splits * (g * d + 2 * g) if splits > 1 else 0,
                     dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.coserve_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), ws.data_ptr() if splits > 1 else None, b, h, hkv,
            w, d, int(pos), int(window), int(q.dtype == torch.bfloat16),
            int(k_cache.dtype == torch.bfloat16), splits, stream)
    if rc != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed: CUDA error {rc} "
            f"({lib.coserve_cuda_error_string(rc).decode()})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
