"""Mesh construction: the port of ``repro.launch.mesh``.

Functions, not module constants, so that importing starts no process
group. The production meshes are 16x16 = 256 ranks over ("data", "model")
and 2x16x16 = 512 over ("pod", "data", "model"). Where the reference's dry
run asks XLA for 512 placeholder host devices, the port's starts a
one-process ``"fake"`` process group of 512 ranks
(``init_fake_process_group``): collectives on it move nothing, and a
``DeviceMesh`` over it carries DTensors of meta tensors through a trace.
That mesh has the type of a multi-card run's, ``"cuda"``, because DTensor
chooses its collectives by the mesh's type: on a ``"cpu"`` mesh it moves a
shard from one tensor dim to another by gathering the whole dim and
keeping a chunk, on a ``"cuda"`` mesh by one all-to-all of the shard
(``_dtensor.shard_dim_alltoall``). Building it touches no card; the
tensors on it stay meta, so none is made on a card either.
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


def fake_mesh(shape, axes):
    """A ``"cuda"``-typed ``DeviceMesh`` of ``shape`` named ``axes`` over
    this process's ``"fake"`` default group, which must hold at least
    ``prod(shape)`` ranks: the mesh a card run would have, carrying meta
    DTensors."""
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {world}: start a fake "
            "process group (repro_torch.launch.mesh.init_fake_process_group)"
            " first")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cuda", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The 16x16 mesh, or 2x16x16 with ``multi_pod``, as ``fake_mesh``
    over the dry run's fake group of ``PRODUCTION_RANKS`` ranks."""
    if multi_pod:
        return fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return fake_mesh((16, 16), ("data", "model"))


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
