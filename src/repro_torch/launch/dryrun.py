"""Multi-pod dry run: trace every (arch x shape x mesh) cell on meta
DTensors. The port of ``repro.launch.dryrun``.

Proves the distribution config is coherent without hardware: each cell's
step (train, prefill or decode) must run to its end on the single-pod
16x16 mesh and the 2x16x16 multi-pod mesh, every parameter, optimizer
moment, batch and cache a meta DTensor with the placements the logical
rules give it, over a one-process ``"fake"`` process group of 512 ranks
(``launch/mesh.py``; no process group is started at import). As the
reference's ``memory_analysis()`` does, the trace also says whether a
cell's step fits one device: it counts the live bytes of the tensors one
rank holds while the step runs.

Per cell, as the reference's JSON has them, all per device (one rank's
local shards):

- ``flops``: ``torch.utils.flop_counter``'s formulas over each operation
  a rank runs on its local tensors: a DTensor operation is counted by the
  local operations DTensor runs for it, on the shards, so an output
  replicated over a mesh axis counts its whole product on every rank of
  that axis;
- ``collective_bytes`` by kind (``all-gather``, ``reduce-scatter``,
  ``all-reduce``, ``all-to-all``): the result bytes of each
  ``_c10d_functional`` collective a rank launches, the accounting
  ``repro.launch.hlo`` does on HLO text. That includes the
  redistributions DTensor makes inside one operation. The mesh has a
  card run's type (``"cuda"``, ``launch/mesh.py``), so DTensor launches
  what it would launch there: a shard moved from one tensor dim to another
  on one mesh axis is one ``_dtensor.shard_dim_alltoall``, counted as an
  ``all-to-all`` of the local shard's bytes, with no whole-dim copy;
- ``argument_bytes`` and ``output_bytes``: the local shards' bytes;
- ``peak_bytes``: the highest count of live bytes during the step. Each
  local operation's result storage is added once, DTensor's transient
  gathered copies among them; views, aliases (a collective's
  ``wait_tensor``) and in-place results add nothing; a storage
  leaves the count when it dies (a weakref callback on the storage). The
  step's arguments are registered before it runs, so the count starts at
  their bytes. Only storages on the arguments' device count. On the card
  the caching allocator's ``max_memory_allocated()`` for the same step
  agrees with it (``chip_smoke.py`` phase 20);
- ``temp_bytes``: the bytes live at that peak that are neither argument
  nor output storages;
- ``bytes_accessed``: for every operation that moves data, the local
  bytes of its tensor inputs and of its results, a result that aliases
  an input counting zero (an in-place result, by the schema's alias
  info, or a result on an input's storage); views move nothing. A
  collective counts its input and its result. This is an unfused eager
  count, larger than XLA's fused one for the same step, and no
  comparison with the reference's numbers is made;
- ``lower_s``: the trace's seconds; ``compile_s`` is ``null``: nothing
  compiles;
- ``mesh_device_type`` and ``cuda_initialized``: the mesh's type and
  whether this process had started CUDA by the trace's end (it must not:
  the tensors are meta, and the sweep hides the cards from its cells).

How DTensor's work is seen: the counter returns ``NotImplemented`` for
an operation on DTensors, so DTensor runs its redistributions and the
local operation beneath it, and the counter sees each of them on local
tensors, the transient gathered copies among them. What DTensor's
sharding propagator runs to choose a sharding is not work a rank does,
and nothing dispatched while it is on the stack is counted: its shape
inference on global-shape ``FakeTensor``s, the decompositions it traces
on global-shape meta tensors for an operation without a strategy of its
own, the small mesh it makes for them. It runs on a cache miss only, so
the first call of an operation counts what a later one does.

The reference lowers 1- and 2-period variants beside the full depth
because XLA counts a while-loop body once; an eager trace counts every
layer, so the ``roofline`` block holds the full-depth numbers and the
period count, with nothing extrapolated. A failing cell is recorded and
the sweep goes on. ``trace_step(fn, *args)`` gives the same numbers for
any step, outside the cells (``chip_smoke.py`` phase 20).

Usage:
  python -m repro_torch.launch.dryrun --arch starcoder2_3b --shape train_4k
  python -m repro_torch.launch.dryrun --sweep [--multi-pod] [--jobs 7] \
      [--out out.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import traceback
import weakref

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
    "shard_dim_alltoall": "all-to-all",     # DTensor's own, on a card mesh
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


# allocations that write nothing: counted as live bytes, not as bytes
# accessed
_NO_DATA = frozenset({
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default})


def _local(t):
    """The tensor whose storage holds ``t``'s bytes on this rank."""
    return getattr(t, "_local_tensor", t)       # a DTensor's local shard


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _op_tensors(values) -> list:
    """The tensors among an operation's arguments or results: each a
    tensor or a list of them."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


class StepCounter(TorchDispatchMode):
    """Counts, while active, the per-device flops of the operations
    dispatched (``flop_registry``'s formulas), the result bytes of each
    functional collective by kind, the bytes accessed and the live bytes
    with their peak (see the module docstring). ``register(tree)`` adds
    the storages of a step's arguments before the step runs.

    The storages are tracked by weakref callbacks, which the autograd
    engine's threads may fire, so the books are kept under a lock."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collective_bytes: dict = {}
        self.collective_counts: dict = {}
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_storage_bytes = 0
        self._lock = threading.RLock()
        # id(storage) -> [nbytes, birth, storages standing for them, their
        # weakrefs], one entry shared by the storages that alias one result
        self._live: dict = {}
        self._events = 0        # storages added and freed so far
        self._peak_at = 0       # the event that set the peak
        self._arg_events = 0    # the last event of the arguments'
        self._device = None     # the arguments' device type: the one counted

    def register(self, tree) -> None:
        """Counts the storages of ``tree``'s tensors (a step's arguments)
        as live and as arguments. From then on only storages on the
        arguments' device count as live: a tensor the step makes on the
        host, and copies to a meta or CUDA device, is not device memory."""
        for t in _tensors(tree):
            storage = _local(t).untyped_storage()
            self._device = self._device or storage.device.type
            if id(storage) not in self._live \
                    and storage.device.type == self._device:
                self.argument_storage_bytes += storage.nbytes()
                self._add(storage)
        self._arg_events = self._events

    def _add(self, storage) -> None:
        with self._lock:
            self._events += 1
            entry = [storage.nbytes(), self._events, 0, []]
            self._hold(storage, entry)
            self.live_bytes += entry[0]
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes
                self._peak_at = self._events

    def _hold(self, storage, entry) -> None:
        """``storage`` stands for ``entry``'s bytes: they stay live until
        every storage that stands for them has died."""
        key = id(storage)
        entry[2] += 1
        entry[3].append(weakref.ref(
            storage, lambda _, key=key, entry=entry: self._free(key, entry)))
        self._live[key] = entry

    def _alias(self, source, results) -> None:
        """``results`` hold ``source``'s data under storages of their own
        (a collective's ``wait_tensor`` or autograd wrapper, which alias
        its result on a device and copy it on meta): they keep its bytes
        live, and add none."""
        with self._lock:
            entry = self._live.get(id(source.untyped_storage()))
            for t in results:
                if entry is not None \
                        and id(t.untyped_storage()) not in self._live:
                    self._hold(t.untyped_storage(), entry)

    def _free(self, key, entry) -> None:
        with self._lock:
            if self._live.get(key) is entry:
                del self._live[key]
            entry[2] -= 1
            if entry[2] == 0:
                self._events += 1
                self.live_bytes -= entry[0]

    def memory(self, out) -> dict:
        """``peak_bytes`` and ``temp_bytes`` of the step that returned
        ``out``: the bytes live at the peak less the arguments' storages
        and the storages of ``out`` that were born by then."""
        outputs = 0
        seen = set()
        with self._lock:
            for t in _tensors(out):
                storage = _local(t).untyped_storage()
                entry = self._live.get(id(storage))
                if entry is not None and id(storage) not in seen \
                        and entry[1] > self._arg_events \
                        and entry[1] <= self._peak_at:
                    outputs += entry[0]
                seen.add(id(storage))
            return {"peak_bytes": self.peak_bytes,
                    "temp_bytes": self.peak_bytes
                    - self.argument_storage_bytes - outputs}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if DTensor in types:
            return NotImplemented       # DTensor runs it on local tensors
        out = func(*args, **kwargs)
        ins = _op_tensors((*args, *kwargs.values()))
        outs = _op_tensors(out if isinstance(out, (list, tuple)) else (out,))
        if _in_sharding_propagation():
            return out                  # DTensor choosing a sharding
        packet = func._overloadpacket
        kind = _COLLECTIVES.get(packet.__name__) if func.namespace in (
            "_c10d_functional", "_dtensor") else None
        if kind is not None:
            self.collective_bytes[kind] = \
                self.collective_bytes.get(kind, 0) + sum(map(_nbytes, outs))
            self.collective_counts[kind] = \
                self.collective_counts.get(kind, 0) + 1
        elif func.namespace == "_c10d_functional":
            self._alias(ins[0], outs)   # wait_tensor, _wrap_tensor_autograd
            return out
        elif packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self._count_bytes(func, ins, outs)
        return out

    def _count_bytes(self, func, inputs, outputs) -> None:
        held = {id(t.untyped_storage()) for t in inputs}
        moved = 0
        for t in outputs:
            storage = t.untyped_storage()
            if id(storage) in held:             # a view or in-place result
                continue
            moved += _nbytes(t)
            if id(storage) not in self._live and self._device in (
                    None, storage.device.type):
                self._add(storage)
        if func in _NO_DATA or not (moved or func._schema.is_mutable):
            return                              # an allocation or a view
        self.bytes_accessed += moved + sum(_nbytes(t) for t in inputs)


# the modules of DTensor's sharding propagator
_PROPAGATION = ("distributed/tensor/_sharding_prop.py",
                "distributed/tensor/_decompositions.py")


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagator is on the caller's stack."""
    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code.co_filename.endswith(_PROPAGATION):
            return True
        frame = frame.f_back
    return False


def trace_step(fn, *args) -> dict:
    """Runs ``fn(*args)`` once under a ``StepCounter`` with ``args``
    registered as the step's arguments, and returns the dry run's keys
    for that step (the module docstring defines them). ``args`` may be
    meta, CPU or CUDA tensors, DTensors among them."""
    counter = StepCounter()
    counter.register(args)
    t0 = time.perf_counter()
    with counter:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    return {
        "lower_s": round(seconds, 1),
        "compile_s": None,
        "flops": float(counter.flops),
        "bytes_accessed": counter.bytes_accessed,
        "argument_bytes": local_bytes(args),
        "output_bytes": local_bytes(out),
        **counter.memory(out),
        "collective_bytes": counter.collective_bytes,
        "collective_counts": counter.collective_counts,
    }


def _trace_stats(arch, shape, mesh, n_periods=None) -> dict:
    cell = build_cell(arch, shape, mesh, n_periods=n_periods)
    stats = trace_step(lambda *args: lower_cell(cell, mesh, args),
                       *distributed_args(cell))
    return {**stats, "n_periods": n_periods,
            "cfg_periods": cell.cfg.num_periods()}


def run_cell(arch: str, shape: str, mesh, verbose: bool = True,
             with_roofline: bool = True) -> dict:
    """The full-depth trace of one cell; with ``with_roofline`` its
    numbers again under ``roofline``, beside the period count."""
    full = _trace_stats(arch, shape, mesh)
    periods = full.pop("cfg_periods")
    result = {"arch": arch, "shape": shape, "mesh": list(mesh.shape),
              "ok": True, **full, "mesh_device_type": mesh.device_type,
              "cuda_initialized": torch.cuda.is_initialized()}
    if with_roofline:
        result["roofline"] = {"flops": full["flops"],
                              "bytes_accessed": full["bytes_accessed"],
                              "collective_bytes": full["collective_bytes"],
                              "n_periods": periods}
    if verbose:
        coll = full["collective_bytes"]
        print(f"[{arch} x {shape} x {'x'.join(map(str, mesh.shape))}] ok: "
              f"trace {full['lower_s']:.1f}s | flops/dev {full['flops']:.3g}"
              f" | args {full['argument_bytes'] / 2**30:.2f} GiB | temp "
              f"{full['temp_bytes'] / 2**30:.2f} GiB | peak "
              f"{full['peak_bytes'] / 2**30:.2f} GiB | coll "
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
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --sweep: cells traced at once")
    args = ap.parse_args(argv)
    if args.sweep:
        raise SystemExit(_sweep_in_processes(args))

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

    failures = 0
    arch, shape = args.arch, args.shape
    for mesh in meshes:
        single_pod = len(mesh.shape) == 2
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


def _sweep_in_processes(args) -> int:
    """``--sweep``: every cell as ``python -m repro_torch.launch.dryrun
    --arch A --shape S`` in a process of its own (each starts its own fake
    process group), ``--jobs`` at a time, the cards hidden from it; their
    results merged into ``--out`` in the sweep's order."""
    import os
    import shutil
    import subprocess
    import sys
    import tempfile

    cells = [(a, s) for a in ARCH_IDS
             for s in applicable_shapes(get_config(a))]
    mesh_flags = ["--both-meshes"] if args.both_meshes else \
        ["--multi-pod"] if args.multi_pod else []
    tmp = tempfile.mkdtemp(prefix="dryrun_sweep_")
    outs = [os.path.join(tmp, f"{a}_{s}.json") for a, s in cells]
    pending = list(zip(cells, outs))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    running = []
    while pending or running:
        while pending and len(running) < args.jobs:
            (arch, shape), out = pending.pop(0)
            running.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--out", out,
                 *mesh_flags], env=env))
        time.sleep(1)
        running = [p for p in running if p.poll() is None]
    results = []
    for (arch, shape), out in zip(cells, outs):
        if os.path.exists(out):
            with open(out) as f:
                results += json.load(f)
        else:
            results.append({"arch": arch, "shape": shape, "ok": False,
                            "error": "the cell's process wrote nothing"})
    shutil.rmtree(tmp, ignore_errors=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    failures = sum(not r["ok"] for r in results)
    print(f"\n{len(results) - failures}/{len(results)} cells ok -> "
          f"{args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    main()
