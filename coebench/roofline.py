"""The benchmark's frozen arithmetic: the H100's published peaks, the
operations and bytes of one launch of each hand-written kernel, and the
useful FLOPs of one served prompt, all from shapes.

Peaks are the NVIDIA H100 SXM data sheet's dense rates at the card's full
700 W power limit; every share computed against them is printed beside the
card's name and its power limit. A launch's bound is the larger of its
operations over the peak for their type and its bytes (each input read once,
each output written once) over the HBM rate, as the port's kernel table
states them.
"""
from __future__ import annotations

import functools
import importlib
from typing import Dict

HBM_BYTES_PER_S = 3.35e12      # HBM3
BF16_OPS_PER_S = 989e12        # dense bf16 on the tensor cores
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


@functools.lru_cache(maxsize=None)
def causal_pairs(s: int, t: int, window: int = 0) -> int:
    """The (query row, key) pairs a causal mask lets through, query row i at
    position t - s + i, with an optional sliding ``window``."""
    total = 0
    for i in range(s):
        pos = t - s + i
        lo = max(0, pos - window + 1) if window else 0
        total += pos + 1 - lo
    return total


def flash_attention_launch(b: int, h: int, hkv: int, s: int, d: int,
                           dtype: str = "bfloat16", window: int = 0) -> dict:
    """One causal self-attention launch over q [b,h,s,d] and k, v
    [b,hkv,s,d]: 4 operations per visible (row, key, d) (the q.k and p.v
    multiply-adds) at the tensor cores' bf16 rate (float32: the CUDA cores'),
    q and out once, k and v once."""
    pairs = causal_pairs(s, s, window)
    ops = 4 * b * h * d * pairs
    nbytes = (2 * b * h * s * d + 2 * b * hkv * s * d) * DTYPE_BYTES[dtype]
    peak = BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S
    return _bound(ops, peak, nbytes)


def mamba_scan_launch(b: int, s: int, d: int, n: int,
                      x_dtype: str = "bfloat16", dt_dtype: str = "float32",
                      bc_dtype: str = "float32") -> dict:
    """One selective-scan launch: x, dt [b,s,d], B, C [b,s,n], A [d,n] and
    D [d] read once, y [b,s,d] (x's dtype) and the final state [b,d,n]
    float32 written once; per (b, s, d, n) the exponential, dt*A, dt*x*B,
    the state's multiply-add and C's (7 operations), per (b, s, d) dt*x and
    the D skip (3), on the CUDA cores."""
    xs, dts, bcs = (DTYPE_BYTES[x_dtype], DTYPE_BYTES[dt_dtype],
                    DTYPE_BYTES[bc_dtype])
    nbytes = (b * s * d * (2 * xs + dts) + 2 * b * s * n * bcs + d * n * 4
              + d * 4 + b * d * n * 4)
    ops = b * s * d * (7 * n + 3)
    return _bound(ops, FP32_OPS_PER_S, nbytes)


def _bound(ops: float, peak: float, nbytes: float) -> dict:
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return {"ops": ops, "bytes": nbytes, "bound_s": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def family(model_type: str):
    """The FLOP and launch counts of ``model_type``:
    ``coebench/flops/<model_type>.py``."""
    return importlib.import_module(f"coebench.flops.{model_type}")


def prompt_flops(cfg: dict, s: int) -> float:
    """Useful FLOPs of one prompt of ``s`` tokens through one expert of the
    configuration ``cfg`` (its published keys)."""
    return family(cfg["model_type"]).prompt_flops(cfg, s)


def launches(cfg: dict, forwards) -> Dict[str, dict]:
    """Per hand-written kernel: the launches the window's forwards
    ((padded rows, rows, sequence) each) imply and the sum of their
    bounds."""
    fam = family(cfg["model_type"])
    out: Dict[str, dict] = {}
    for rows, _, s in forwards:
        for name, (count, bound) in fam.launches(cfg, rows, s).items():
            acc = out.setdefault(name, {"launches": 0, "bound_s": 0.0})
            acc["launches"] += count
            acc["bound_s"] += count * bound["bound_s"]
    return out
