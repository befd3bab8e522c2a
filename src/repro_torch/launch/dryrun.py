"""Multi-pod dry run: trace every (arch x shape x mesh) cell on meta
DTensors. The port of ``repro.launch.dryrun``.

Proves the distribution config is coherent without hardware: each cell's
step (train, prefill or decode) must run to its end on the single-pod
16x16 mesh and the 2x16x16 multi-pod mesh, every parameter, optimizer
moment, batch and cache a meta DTensor with the placements the logical
rules give it, over a one-process ``"fake"`` process group of 512 ranks
(``launch/mesh.py``; no process group is started at import).

Per cell, as the reference's JSON has them:

- ``flops``: per device, ``torch.utils.flop_counter``'s formulas over each
  operation the step dispatches: a DTensor operation's count on its global
  shapes divided by the ways its output is split (``Shard`` or
  ``Partial`` mesh dims), an operation on local shards counted as it is;
- ``collective_bytes`` by kind (``all-gather``, ``reduce-scatter``,
  ``all-reduce``, ``all-to-all``): the result bytes of each
  ``_c10d_functional`` collective a rank launches, the accounting
  ``repro.launch.hlo`` does on HLO text;
- ``argument_bytes`` and ``output_bytes``: the local shards' bytes;
- ``lower_s``: the trace's seconds;
- ``bytes_accessed``, ``temp_bytes``, ``peak_bytes`` and ``compile_s`` are
  ``null``: they come from XLA's compiler, and an eager trace has no
  counterpart.

The reference lowers 1- and 2-period variants beside the full depth
because XLA counts a while-loop body once; an eager trace counts every
layer, so the ``roofline`` block holds the full-depth numbers and the
period count, with nothing extrapolated. A failing cell is recorded and
the sweep goes on.

Usage:
  python -m repro_torch.launch.dryrun --arch starcoder2_3b --shape train_4k
  python -m repro_torch.launch.dryrun --sweep [--multi-pod] [--out out.json]
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config
from repro_torch.launch.mesh import (init_fake_process_group,
                                     make_production_mesh)
from repro_torch.launch.specs import build_cell, distributed_args, lower_cell

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def local_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` a rank holds: a DTensor's local
    shard, any other tensor whole."""
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in _tensors(tree))


class StepCounter(TorchDispatchMode):
    """Counts, while active, the per-device flops of the operations
    dispatched (``flop_registry``'s formulas; see the module docstring)
    and the result bytes of each functional collective by kind."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collective_bytes: dict = {}
        self.collective_counts: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:
                nbytes = sum(t.numel() * t.element_size()
                             for t in _tensors(out))
                self.collective_bytes[kind] = \
                    self.collective_bytes.get(kind, 0) + nbytes
                self.collective_counts[kind] = \
                    self.collective_counts.get(kind, 0) + 1
        elif packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += flops // _split(out)
        return out


def _split(out) -> int:
    """The ways a DTensor result is divided among ranks: the product of
    the sizes of the mesh dims on which it is sharded or partial."""
    from torch.distributed.tensor import DTensor

    first = _tensors(out)[0] if _tensors(out) else None
    if not isinstance(first, DTensor):
        return 1
    return math.prod(first.device_mesh.size(i)
                     for i, p in enumerate(first.placements)
                     if not p.is_replicate())


def _trace_stats(arch, shape, mesh, n_periods=None) -> dict:
    cell = build_cell(arch, shape, mesh, n_periods=n_periods)
    args = distributed_args(cell)
    arg_bytes = local_bytes(args)
    counter = StepCounter()
    t0 = time.perf_counter()
    with counter:
        out = lower_cell(cell, mesh, args)
    t_lower = time.perf_counter() - t0
    return {
        "lower_s": round(t_lower, 1),
        "compile_s": None,
        "flops": float(counter.flops),
        "bytes_accessed": None,
        "argument_bytes": arg_bytes,
        "output_bytes": local_bytes(out),
        "temp_bytes": None,
        "peak_bytes": None,
        "collective_bytes": counter.collective_bytes,
        "collective_counts": counter.collective_counts,
        "n_periods": n_periods,
        "cfg_periods": cell.cfg.num_periods(),
    }


def run_cell(arch: str, shape: str, mesh, verbose: bool = True,
             with_roofline: bool = True) -> dict:
    """The full-depth trace of one cell; with ``with_roofline`` its
    numbers again under ``roofline``, beside the period count."""
    full = _trace_stats(arch, shape, mesh)
    periods = full.pop("cfg_periods")
    result = {"arch": arch, "shape": shape, "mesh": list(mesh.shape),
              "ok": True, **full}
    if with_roofline:
        result["roofline"] = {"flops": full["flops"],
                              "bytes_accessed": None,
                              "collective_bytes": full["collective_bytes"],
                              "n_periods": periods}
    if verbose:
        coll = full["collective_bytes"]
        print(f"[{arch} x {shape} x {'x'.join(map(str, mesh.shape))}] ok: "
              f"trace {full['lower_s']:.1f}s | flops/dev {full['flops']:.3g}"
              f" | args {full['argument_bytes'] / 2**30:.2f} GiB | coll "
              f"{sum(coll.values()) / 2**20:.1f} MiB", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)

    if not dist.is_initialized():
        init_fake_process_group()
    if args.both_meshes:
        meshes = [make_production_mesh(multi_pod=False),
                  make_production_mesh(multi_pod=True)]
    else:
        meshes = [make_production_mesh(multi_pod=args.multi_pod)]

    results = []

    def save():                 # after every cell: a crash loses nothing
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    if args.sweep:
        cells = [(a, s) for a in ARCH_IDS
                 for s in applicable_shapes(get_config(a))]
    else:
        cells = [(args.arch, args.shape)]

    failures = 0
    for mesh in meshes:
        single_pod = len(mesh.shape) == 2
        for arch, shape in cells:
            try:
                results.append(run_cell(arch, shape, mesh,
                                        with_roofline=single_pod))
            except Exception as e:  # noqa: BLE001 — record and continue
                failures += 1
                results.append({
                    "arch": arch, "shape": shape, "mesh": list(mesh.shape),
                    "ok": False, "error": f"{type(e).__name__}: {e}"})
                print(f"[{arch} x {shape}] FAILED: {e}")
                traceback.print_exc()
            save()
    print(f"\n{len(results) - failures}/{len(results)} cells ok -> "
          f"{args.out}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
