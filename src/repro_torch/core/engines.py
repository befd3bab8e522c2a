"""Execution engines behind the executor state machine.

``SimEngine`` — latencies from offline profiles + the unified memory
hierarchy (``repro_torch.memory``); drives the event-driven simulator at the
paper's scale (hundreds of experts). Every transfer it performs occupies the
hierarchy's *shared* SSD/PCIe channels, so concurrent loads contend instead
of each pretending it owns the link.

``RealEngine`` — actually loads PyTorch expert params across host/disk tiers
onto the device (a CUDA card unless the caller asks for the CPU) and runs
their forwards, measuring wall time. Loads queue on real transfer threads
that mirror the tier topology: one thread per transfer channel (one shared
thread in ``links="shared"`` mode, or one per device pool in
``links="per-device"`` mode), each with its own CUDA stream, so prefetch
genuinely overlaps host I/O with device compute and concurrent loads
serialize exactly where the simulated channels would. Scheduler and
expert-manager behaviour (and therefore switch counts) are
engine-independent.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.coe import CoEModel, Request
from repro_torch.kernels.ops import decode_attention_op
from repro_torch.memory import MemoryHierarchy, TierSpec

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """The engine's device: ``cuda`` (the default everywhere) or ``cpu``.
    Asking for CUDA without a usable card raises; nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} asked for, but no CUDA device is "
                "available (pass device='cpu' to run on the host)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work: a wall-clock latency read before
    this would measure only the launch."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SimEngine:
    """Profiled-latency engine (paper-scale simulation)."""

    def __init__(self, coe: CoEModel, tier: Optional[TierSpec],
                 hierarchy: Optional[MemoryHierarchy] = None):
        self.coe = coe
        self.tier = tier
        # standalone construction (tests, notebooks): derive a hierarchy so
        # the latency model and channels always exist
        self.hierarchy = hierarchy if hierarchy is not None \
            else MemoryHierarchy(coe, tier, pools={})

    # --- latency model (uncontended predictions) ------------------------ #
    def load_latency(self, ex, expert_id: str) -> float:
        if ex is not None and ex.device in ("host", "cpu"):
            h = self.hierarchy
            if h.host_exec_enabled and h.in_host(expert_id):
                return 0.0             # host co-execution: runs in place
            return h.predict_host_load(expert_id)
        group = ex.link_group if ex is not None else ""
        return self.hierarchy.predict_device_load(expert_id, group)

    def exec_latency(self, ex, expert_id: str, n: int) -> float:
        prof = ex.profile(self.coe.spec(expert_id).arch)
        return prof.exec_latency(n)

    # --- side effects --------------------------------------------------- #
    def load(self, ex, expert_id: str, now: float = 0.0) -> float:
        """Begin the transfer on the contended channels; returns the latency
        the executor observes (queueing wait + service legs). The PCIe leg
        rides the executor's own device link in per-device mode."""
        if ex is not None and ex.device in ("host", "cpu"):
            tr = self.hierarchy.begin_host_load(expert_id, now)
        else:
            group = ex.link_group if ex is not None else ""
            tr = self.hierarchy.begin_device_load(expert_id, now, group=group)
        return tr.latency

    def unload(self, ex, expert_id: str) -> None:
        if ex is not None and ex.device in ("host", "cpu"):
            return                      # CPU pool lives in DRAM already
        self.hierarchy.note_evicted(expert_id)

    def execute(self, ex, expert_id: str, batch: List[Request]
                ) -> Tuple[Optional[list], float]:
        # outcome is carried by the synthetic request payload (drives routing)
        outputs = [None if r.data is None else r.data.get("outcome")
                   for r in batch]
        return outputs, self.exec_latency(ex, expert_id, len(batch))


class RingKVCache:
    """One request's ring KV cache for the real decode path.

    Device-resident rings in the heads-major layout ([Hkv, W, D]) with the
    absolute position ``pos`` kept as a Python int; ``append`` writes slot
    ``pos % width`` (the ring update), ``attend`` runs ``decode_attention``
    over the ring: the hand-written kernel on a CUDA device, its plain
    version on the CPU. Positions past ``width`` overwrite the oldest slot —
    the kernel's validity mask reconstructs absolute positions from ``pos``.
    """

    def __init__(self, num_heads: int = 4, num_kv_heads: int = 2,
                 head_dim: int = 64, width: int = 64,
                 dtype: str = "float32", window: int = 0,
                 device="cuda"):
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.width = width
        self.window = window
        self.device = resolve_device(device)
        shape = (num_kv_heads, width, head_dim)
        self.k = torch.zeros(shape, dtype=_DTYPES[dtype], device=self.device)
        self.v = torch.zeros(shape, dtype=_DTYPES[dtype], device=self.device)
        self.pos = -1                   # last written absolute position

    def append(self, k: np.ndarray, v: np.ndarray) -> int:
        """Write this step's [Hkv, D] k/v at the next ring slot; returns
        the absolute position written."""
        self.pos += 1
        slot = self.pos % self.width
        self.k[:, slot, :] = torch.as_tensor(k).to(self.device, self.k.dtype)
        self.v[:, slot, :] = torch.as_tensor(v).to(self.device, self.v.dtype)
        return self.pos

    def attend(self, q: np.ndarray):
        """[H, D] query against the ring -> [H, D] numpy output (B=1 kernel
        call; members of one continuous batch have different ``pos`` so
        they cannot share a batched call). The query is float32, as the
        reference's ``jnp.asarray`` of a float64 array makes it, so a
        bfloat16 ring takes the kernel's fp32-q / bf16-kv form."""
        qt = torch.as_tensor(np.asarray(q, np.float32)).to(self.device)
        out = decode_attention_op(qt[None], self.k[None], self.v[None],
                                  self.pos, window=self.window)
        return out[0].cpu().numpy()


class HostStore:
    """Host-DRAM + disk parameter store for the real backend.

    Experts start on 'disk' (flat name -> array ``.npz`` files) or in host
    memory as CPU tensors (pinned when ``pin_memory`` is set, which only a
    CUDA device allows); loads into an executor deserialize and copy them
    to the device — the real analogue of the paper's SSD -> DRAM -> GPU
    expert switching.
    """

    def __init__(self, root: Optional[str] = None, pin_memory: bool = False):
        self.host: Dict[str, Dict[str, torch.Tensor]] = {}
        self.disk: Dict[str, str] = {}
        self.root = root
        self.pin_memory = pin_memory

    def _host_tensors(self, params) -> Dict[str, torch.Tensor]:
        out = {}
        for name, a in params.items():
            t = torch.as_tensor(a).cpu()
            out[name] = t.pin_memory() if self.pin_memory else t
        return out

    def put_host(self, expert_id: str, params: Dict[str, Any]):
        self.host[expert_id] = self._host_tensors(params)

    def put_disk(self, expert_id: str, params: Dict[str, Any]):
        if not self.root:
            raise ValueError("HostStore needs a root dir for the disk tier")
        os.makedirs(self.root, exist_ok=True)
        path = os.path.join(self.root, f"{expert_id}.npz")
        np.savez(path, **{name: torch.as_tensor(a).cpu().numpy()
                          for name, a in params.items()})
        self.disk[expert_id] = path

    def fetch(self, expert_id: str) -> Tuple[Dict[str, torch.Tensor], str]:
        """Returns (host-side params, source tier)."""
        if expert_id in self.host:
            return self.host[expert_id], "host"
        with np.load(self.disk[expert_id]) as z:
            params = self._host_tensors({name: z[name] for name in z.files})
        self.host[expert_id] = params          # disk read populates host cache
        return params, "disk"


class _TransferWorker:
    """One transfer channel of the real backend: a daemon thread that
    performs fetch + host-to-device jobs FIFO on the channel's own CUDA
    stream. Concurrent loads from different executors serialize here — the
    real-hardware analogue of the simulator's contended
    ``TransferChannel``."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" \
            else None
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None

    def _ensure_started(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="coserve-transfer")
            self._thread.start()

    def _run(self):
        while True:
            fn, done = self._q.get()
            try:
                fn(self.stream)
            except BaseException as e:  # surfaced by wait()
                done["error"] = e
            finally:
                done["event"].set()
                self._q.task_done()

    def submit(self, fn) -> dict:
        """Queue ``fn(stream)``; returns the handle ``wait`` blocks on."""
        self._ensure_started()
        done = {"event": threading.Event(), "error": None}
        self._q.put((fn, done))
        return done

    @staticmethod
    def wait(handle: dict):
        handle["event"].wait()
        if handle["error"] is not None:
            raise handle["error"]


class RealEngine:
    """Runs real PyTorch experts; latencies are measured wall time, read
    after the device finished the work.

    ``apply_fns[arch]``: fn (params, batch_tensor) -> outputs. Expert
    payloads supply ``make_batch(requests) -> array`` and
    ``interpret(outputs) -> list`` hooks via the CoE expert payload dict.

    Transfers ride per-channel transfer threads: ``load()`` enqueues on the
    thread of the link the executor's pool uses (``bind_topology`` maps pool
    group -> channel; unbound or shared-link mode keeps a single thread)
    and returns the *predicted* latency (so scheduling stays deterministic),
    and the executor's ``finish_load`` blocks until the transfer really
    completed. ``measured_load_time`` accumulates the wall time the workers
    actually spent moving timed (post-init) loads; it is surfaced in
    ``Metrics.memory['real_measured_load_s']``.
    """

    def __init__(self, coe: CoEModel, store: HostStore,
                 apply_fns: Dict[str, Any], device="cuda"):
        self.coe = coe
        self.store = store
        self.apply_fns = apply_fns
        self.device = resolve_device(device)
        self.device_params: Dict[str, Dict[str, torch.Tensor]] = {}
        self._workers: Dict[str, _TransferWorker] = {}
        self._topology = None
        self._hierarchy = None
        self._pending: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self.measured_load_time = 0.0
        # heterogeneous CPU co-execution (policy.host_exec): host/CPU
        # executors run host-resident experts straight from the DRAM store —
        # no transfer thread, no deserialization round-trip
        self.host_exec_enabled = False
        # token-level decode: one ring KV cache per mid-generation request,
        # driving the decode_attention kernel per step. ``decode_attn``
        # overrides the cache geometry (heads/width/dtype).
        self.decode_caches: Dict[int, RingKVCache] = {}
        self.decode_attn: Dict[str, Any] = {}

    # --- topology binding (one transfer thread per transfer channel) ---- #
    def bind_topology(self, topology, hierarchy=None) -> None:
        """Mirror the tier topology's channels: each PCIe channel, peer
        ingress link (or the SSD link on unified tiers) gets its own FIFO
        transfer thread, so the real backend serializes loads exactly where
        the simulator's contended channels would. ``hierarchy`` (when given)
        lets loads of experts already resident on a sibling pool ride that
        pool's peer channel thread. Called by ``CoServeSystem``."""
        self._topology = topology
        self._hierarchy = hierarchy

    def _channel_name(self, ex, expert_id: str = "") -> str:
        if self._topology is None or ex is None:
            return ""                  # unbound: a single thread
        t = self._topology
        if t.spec.unified or getattr(ex, "device", "") in ("host", "cpu"):
            # one storage link carries the load (host/CPU executors load
            # disk -> DRAM and never own a PCIe channel)
            return t.disk_channel.name
        if expert_id and self._hierarchy is not None \
                and self._hierarchy.peer_source(expert_id,
                                                ex.link_group) is not None:
            return t.peer_for(ex.link_group).name
        return t.pcie_for(ex.link_group).name

    def _worker_for(self, name: str) -> _TransferWorker:
        with self._lock:
            worker = self._workers.get(name)
            if worker is None:
                worker = self._workers[name] = _TransferWorker(self.device)
            return worker

    def _host_exec_hit(self, ex, expert_id: str) -> bool:
        return (self.host_exec_enabled and ex is not None
                and getattr(ex, "device", "") in ("host", "cpu")
                and expert_id in self.store.host)

    def load_latency(self, ex, expert_id: str) -> float:
        # prediction for scheduling: profiled value (derived from the
        # TransferEngine formula at profiling time)
        if self._host_exec_hit(ex, expert_id):
            return 0.0                 # host co-execution: runs in place
        spec = self.coe.spec(expert_id)
        prof = ex.profile(spec.arch)
        return prof.load_latency_host if expert_id in self.store.host \
            else prof.load_latency_disk

    def exec_latency(self, ex, expert_id: str, n: int) -> float:
        prof = ex.profile(self.coe.spec(expert_id).arch)
        return prof.exec_latency(n)

    # ------------------------------------------------------------------ #
    def _transfer(self, expert_id: str, stream=None, timed: bool = True):
        """Fetch the params and copy them to the device on ``stream`` (the
        channel's own, or the caller's current one): non-blocking copies
        from pinned host tensors, then a wait on that stream only."""
        t0 = time.perf_counter()
        host_params, _ = self.store.fetch(expert_id)
        if stream is None:
            dev = {n: t.to(self.device) for n, t in host_params.items()}
            synchronize(self.device)
        else:
            with torch.cuda.stream(stream):
                dev = {n: t.to(self.device, non_blocking=True)
                       for n, t in host_params.items()}
            # the tensors were allocated on the channel's stream but are read
            # on the compute stream: keep the allocator from reusing them
            # before that stream is done with them
            compute = torch.cuda.default_stream(self.device)
            for t in dev.values():
                t.record_stream(compute)
            stream.synchronize()
        with self._lock:
            self.device_params[expert_id] = dev
            if timed:
                self.measured_load_time += time.perf_counter() - t0

    def load(self, ex, expert_id: str, now: float = 0.0) -> float:
        if self._host_exec_hit(ex, expert_id):
            # execute in place on the CPU: the host-store params ARE the
            # executable params — no worker round-trip, nothing pending
            with self._lock:
                self.device_params[expert_id] = self.store.host[expert_id]
            return 0.0
        worker = self._worker_for(self._channel_name(ex, expert_id))
        handle = worker.submit(
            lambda stream: self._transfer(expert_id, stream))
        with self._lock:
            self._pending[expert_id] = handle
        return self.load_latency(ex, expert_id)

    def wait_load(self, ex, expert_id: str) -> None:
        """Block until the queued transfer landed (executor ``finish_load``)."""
        with self._lock:
            handle = self._pending.pop(expert_id, None)
        if handle is not None:
            _TransferWorker.wait(handle)

    def unload(self, ex, expert_id: str) -> None:
        self.wait_load(ex, expert_id)    # never drop a half-landed transfer
        with self._lock:
            self.device_params.pop(expert_id, None)

    def warm_place(self, pool, expert_id: str) -> None:
        """Initial placement (system-init phase): transfer without timing."""
        self._transfer(expert_id, timed=False)

    # --- token-level decode --------------------------------------------- #
    def decode_step(self, ex, states, now: float = 0.0) -> float:
        """Run one decode step for every member of ``ex``'s continuous
        batch: append this step's k/v to each request's ring cache and run
        the decode kernel against it (B=1 per member — members sit at
        different ring positions). Inputs are hash-seeded per (request,
        position) exactly as in the reference, so replays are deterministic
        and both packages decode the same numbers. Returns measured wall
        seconds — the DecodeRuntime's step latency."""
        t0 = time.perf_counter()
        for st in states:
            rid = st.req.id
            cache = self.decode_caches.get(rid)
            if cache is None:
                cache = self.decode_caches[rid] = \
                    RingKVCache(**self.decode_attn, device=self.device)
            rng = np.random.default_rng(abs(hash((rid, cache.pos + 1)))
                                        % (2 ** 32))
            hkv, d = cache.num_kv_heads, cache.head_dim
            cache.append(rng.standard_normal((hkv, d)),
                         rng.standard_normal((hkv, d)))
            q = rng.standard_normal((cache.num_heads, d))
            st.req.result = cache.attend(q)   # copies back: device is done
        return time.perf_counter() - t0

    def decode_release(self, rid: int) -> None:
        """A request finished (or was orphaned): drop its ring cache."""
        self.decode_caches.pop(rid, None)

    def execute(self, ex, expert_id: str, batch: List[Request]
                ) -> Tuple[list, float]:
        spec = self.coe.spec(expert_id)
        payload = spec.payload or {}
        t0 = time.perf_counter()
        params = self.device_params[expert_id]
        make_batch = payload["make_batch"]
        interpret = payload.get("interpret", lambda o: list(o))
        x = make_batch(batch)
        # pad the batch dim to a power-of-two bucket, as the reference does
        # (one compiled shape per bucket there; here the same batch shapes)
        n = x.shape[0]
        bucket = 1 << (n - 1).bit_length()
        if bucket != n:
            pad = np.zeros((bucket - n,) + x.shape[1:], x.dtype)
            x = np.concatenate([x, pad], axis=0)
        # the batch goes where the params are: the device, or host DRAM for
        # a host co-executed expert
        where = next(iter(params.values())).device
        with torch.no_grad():
            out = self.apply_fns[spec.arch](params,
                                            torch.from_numpy(x).to(where))
        out = out.cpu().numpy()                # waits for the device
        lat = time.perf_counter() - t0
        return interpret(out[:n]), lat
