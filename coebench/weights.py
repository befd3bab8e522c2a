"""The benchmark's seeded weight maker.

Each expert's weights are drawn on the device from one ``torch.Generator``
seeded from the run's seed and the expert's index, one call per tensor into
one device buffer in the served dtype, then copied in one transfer into a
page-locked host buffer of exactly that size. The flat names, shapes and
dtypes are the family reference's ``layout`` (the program's parameter
layout); the named tensors are views into the host buffer. Both the program
(through its host store) and the reference read these host tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ALIGN = 256


def expert_seed(seed: int, index: int) -> int:
    return (seed * 1009 + index) % (1 << 63)


def plan(layout) -> Tuple[List[tuple], int]:
    """(name, shape, dtype, init, fan, byte offset) per tensor and the
    buffer's size, each tensor starting on an ``ALIGN``-byte boundary."""
    out, off = [], 0
    for name, shape, dtype, init, fan in layout:
        nbytes = math.prod(shape) * DTYPES[dtype].itemsize
        out.append((name, shape, dtype, init, fan, off))
        off += -(-nbytes // ALIGN) * ALIGN
    return out, off


def views(buf: torch.Tensor, entries) -> Dict[str, torch.Tensor]:
    """The named tensors of a byte buffer laid out by ``plan``."""
    out = {}
    for name, shape, dtype, _, _, off in entries:
        t = DTYPES[dtype]
        n = math.prod(shape) * t.itemsize
        out[name] = buf[off:off + n].view(t).view(shape)
    return out


def _fill(t: torch.Tensor, init: str, fan: int, gen: torch.Generator):
    if init == "dense":
        t.normal_(0.0, 1.0 / math.sqrt(fan), generator=gen)
    elif init == "norm_scale":
        t.normal_(1.0, 0.1, generator=gen)
    elif init == "norm_bias":
        t.normal_(0.0, 0.1, generator=gen)
    elif init == "skip":
        t.normal_(1.0, 0.1, generator=gen)
    elif init == "dt_bias":
        # softplus(dt_bias) log-uniform in [1e-3, 1e-1] (Mamba's dt init)
        u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
        u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
        dt = u.exp()
        t.copy_(dt + torch.log(-torch.expm1(-dt)))
    elif init == "a_log":
        # S4D-real: A[:, j] = -(j + 1) for every channel
        n = t.shape[-1]
        t.copy_(torch.arange(1, n + 1, dtype=torch.float32,
                             device=t.device).log().expand(t.shape))
    else:
        raise ValueError(f"unknown init {init!r}")


def host_buffer(nbytes: int, pinned: bool) -> torch.Tensor:
    """``nbytes`` of host memory as a uint8 tensor; ``pinned``: its pages
    first touched by torch's threads, then page-locked (``pin``), which
    takes a third of the time that locking untouched pages does."""
    buf = torch.empty(nbytes, dtype=torch.uint8)
    if pinned:
        buf.zero_()
        pin(buf)
    return buf


def pin(buf: torch.Tensor) -> None:
    """Page-lock ``buf``'s exact bytes for the card's DMA engines."""
    rt = torch.cuda.cudart()
    err = rt.cudaHostRegister(buf.data_ptr(), buf.numel(), 0)
    code = getattr(err, "value", err)
    if int(code) != 0:
        raise RuntimeError(f"cudaHostRegister failed with CUDA error {code}")


def unpin(buf: torch.Tensor) -> None:
    """Undo ``pin`` before ``buf`` is freed."""
    err = torch.cuda.cudart().cudaHostUnregister(buf.data_ptr())
    code = getattr(err, "value", err)
    if int(code) != 0:
        raise RuntimeError(f"cudaHostUnregister failed with CUDA error "
                           f"{code}")


def make_expert(layout, seed: int, device: torch.device,
                scratch: torch.Tensor = None, host: torch.Tensor = None):
    """One expert's weights drawn on ``device`` from ``seed``; returns
    (flat name -> host tensor, host buffer, device scratch buffer). Pass the
    scratch back in for the next expert of the same layout, and a host
    buffer of this layout to refill it in place of locking a new one."""
    entries, nbytes = plan(layout)
    if scratch is None or scratch.numel() < nbytes:
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, t in views(scratch, entries).items():
        init, fan = next((e[3], e[4]) for e in entries if e[0] == name)
        _fill(t, init, fan, gen)
    if host is None:
        host = host_buffer(nbytes, device.type == "cuda")
    host.copy_(scratch[:nbytes])
    return views(host, entries), host, scratch
