"""Mesh construction: the port of ``repro.launch.mesh``.

Functions, not module constants, so that importing starts no process
group. The production meshes are 16x16 = 256 ranks over ("data", "model")
and 2x16x16 = 512 over ("pod", "data", "model"). Where the reference's dry
run asks XLA for 512 placeholder host devices, the port's starts a
one-process ``"fake"`` process group of 512 ranks
(``init_fake_process_group``): collectives on it move nothing, and a
``DeviceMesh`` over it carries DTensors of meta tensors through a trace.
``make_local_mesh`` is the 1x1 mesh of one real rank: the card's NCCL, or
gloo when the CPU is asked for.
"""
from __future__ import annotations

import math
import socket

import torch
import torch.distributed as dist

PRODUCTION_RANKS = 512


def init_fake_process_group(world_size: int = PRODUCTION_RANKS) -> None:
    """Make this process rank 0 of a ``"fake"`` default process group of
    ``world_size`` ranks (``torch.testing``'s ``FakeStore``; importing its
    module registers the backend)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {world}: the dry run must "
            f"start a fake process group of {PRODUCTION_RANKS} ranks "
            "(repro_torch.launch.mesh.init_fake_process_group) first")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_local_mesh(device: str = "cuda"):
    """1x1 ("data", "model") mesh over a one-rank process group on this
    machine (started here if none is): NCCL on the card, gloo on the CPU.
    There is no fallback: ``device="cuda"`` without a card raises."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_local_mesh(device='cuda') needs a CUDA card")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, (1, 1),
                            mesh_dim_names=("data", "model"))
