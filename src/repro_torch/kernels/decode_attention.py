"""GQA decode attention vs a ring KV cache: the hand-written Hopper kernel
(``csrc/decode_attention.cu``) and its wrapper.

The kernel replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention``. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface at
first use (``build.load_library``) and loaded with ``ctypes``. A tensor on
the CPU takes the plain version (``ref.decode_attention_ref``); a CUDA
tensor launches the kernel or raises. ``decode_attention.launches`` counts
the launches: one a call, the combine of the splits included.

``plan`` picks the kernel's tile and split counts from the shapes alone.
A call with splits takes its combine tickets from the counters of the
stream it runs on, or, in a CUDA graph capture, from counters of that
capture's own (``_tickets_for``): calls in flight on two streams, and the
replays of two graphs, never share them.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.ref import decode_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"

# (q dtype, kv dtype) pairs the kernel takes; the output has q's dtype
DTYPES = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)}
MAX_HEAD_DIM = 256
MAX_GROUP_ELEMS = 4096        # G * D: 256 threads x 16 accumulators
MAX_TILE = 64                 # ring slots a tile
STAGE_BYTES = 32768           # the K and V rows of one tile at most
MAX_COMBINE = 16384           # splits x rows weights the combine holds
MAX_ROWS = 1 << 16            # B x Hkv x row chunks the split counters cover
# A block takes at most this many of a kv head's query rows, the grid aims
# at this many blocks an SM (two fit at phi4-mini's ring), and a split walks
# at least this many tiles.
ROWS_PER_BLOCK = 4
BLOCKS_PER_SM = 2
MIN_TILES_PER_SPLIT = 2


def plan(batch: int, num_kv_heads: int, width: int, head_dim: int,
         group: int, kv_bytes: int, sm_count: int) -> tuple[int, int, int]:
    """(tile, rows, splits) for a call: ``tile`` ring slots a tile (64, or
    fewer so that a tile's K and V rows take at most ``STAGE_BYTES``);
    ``rows`` of a kv head's ``group`` query rows a block (the group cut
    into equal chunks of at most ``ROWS_PER_BLOCK``: a block's work on a
    tile grows with its rows, while the chunks of one head re-read its
    tiles from L2); and ``splits`` blocks per (batch, kv head, chunk), so
    that the grid is about ``BLOCKS_PER_SM`` blocks on each SM while every
    split has ``MIN_TILES_PER_SPLIT`` tiles to walk and the combine's
    weights fit."""
    tile = min(MAX_TILE, STAGE_BYTES // (2 * head_dim * kv_bytes))
    n_tiles = -(-width // tile)
    chunks = -(-group // ROWS_PER_BLOCK)
    rows = -(-group // chunks)
    blocks = batch * num_kv_heads * chunks
    splits = min(-(-BLOCKS_PER_SM * sm_count // blocks),
                 -(-n_tiles // MIN_TILES_PER_SPLIT), MAX_COMBINE // rows)
    if blocks > MAX_ROWS:
        splits = 1
    return tile, rows, max(1, splits)


def _bind(lib):
    fn = lib.coserve_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    if lib.coserve_decode_attention_max_rows() != MAX_ROWS:
        raise RuntimeError("decode_attention: the library's ticket count "
                           "differs from MAX_ROWS")
    lib.coserve_stream_capture_id.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.coserve_stream_capture_id.restype = ctypes.c_int
    lib.coserve_cuda_error_string.argtypes = [ctypes.c_int]
    lib.coserve_cuda_error_string.restype = ctypes.c_char_p


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


_tickets: dict = {}
_tickets_lock = threading.Lock()


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"decode_attention {what} failed: CUDA error {rc} "
            f"({lib.coserve_cuda_error_string(rc).decode()})")


def _tickets_for(lib, device: torch.device, stream) -> torch.Tensor:
    """The combine tickets of the calls on ``stream``, ``MAX_ROWS`` zeroed
    counters, made at the first such call and kept: one array for the
    stream's calls outside a capture, and one for each CUDA graph capture
    that records calls on it. The block that combines a call's splits
    resets its counter, so the next call in stream order (or in the
    graph) finds them zero again. An array made in a capture is zeroed
    inside the graph, ahead of the graph's first call, so each replay
    starts from zero whichever graphs ran before; the replays of two
    graphs, and eager calls on other streams, never share counters. A
    graph's array (256 KiB of its memory pool) is kept while the program
    runs."""
    capture = ctypes.c_ulonglong()
    _raise_on(lib, lib.coserve_stream_capture_id(stream.cuda_stream,
                                                 ctypes.byref(capture)),
              "capture query")
    key = (device.index, stream.cuda_stream, capture.value)
    with _tickets_lock:
        tickets = _tickets.get(key)
        if tickets is None:
            tickets = _tickets[key] = torch.zeros(
                MAX_ROWS, dtype=torch.int32, device=device)
    return tickets


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0):
    """q: [B,H,D]; caches: [B,Hkv,W,D]; pos: absolute position of the new
    token -> [B,H,D] in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, pos, window=window)
    _check(q, k_cache, v_cache, window)
    lib = load_library(SOURCE, _bind)
    b, h, d = q.shape
    hkv, w = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    tile, rows, splits = plan(b, hkv, w, d, g, k_cache.element_size(), sms)
    out = torch.empty_like(q)
    # partial (acc, m, l) of each split, combined by the last split to end
    chunks = -(-g // rows)
    ws = torch.empty(b * hkv * chunks * splits * (rows * d + 2 * rows)
                     if splits > 1 else 0, dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device)
        tickets = (_tickets_for(lib, q.device, stream).data_ptr()
                   if splits > 1 else None)
        rc = lib.coserve_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), ws.data_ptr() if splits > 1 else None, tickets,
            b, h, hkv, w, d, int(pos), int(window),
            int(q.dtype == torch.bfloat16),
            int(k_cache.dtype == torch.bfloat16), tile, rows, splits,
            stream.cuda_stream)
    _raise_on(lib, rc, "kernel launch")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
