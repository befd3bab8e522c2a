"""The dry run's per-device memory and bytes accessed
(``repro_torch.launch.dryrun``: ``StepCounter``, ``trace_step``).

- A hand-written step (an allocation, a view, an in-place op, a free and a
  non-reentrant ``torch.utils.checkpoint`` function taken through its
  backward) gives hand-counted ``peak_bytes``, ``temp_bytes`` and
  ``bytes_accessed``, on meta tensors and on CPU tensors alike; the live
  books hold when many threads add and free storages at once.
- The smoke StarCoder2-3B train step traces to the same ``peak_bytes`` on
  meta and on CPU tensors, with remat off and on, and remat lowers it.
- The dry run's cells at CI size (the mini 2x2x2 MoE train cell, the 2x2
  dense prefill and decode cells), each in a subprocess with its own fake
  process group as in ``tests/test_torch_dryrun.py``, report every memory
  key, with ``peak_bytes >= argument_bytes``; the three subprocesses run
  together.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import threading

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.dryrun import StepCounter, trace_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KIB = 1024          # one float32 [256] tensor


def _hand_step(x, w):
    a = x * 2                           # +1 KiB
    v = a.view(16, 16)                  # a view: nothing
    v.add_(1.0)                         # in place: nothing
    b = a + x                           # +1 KiB
    del a, v                            # -1 KiB: a's storage dies
    c = checkpoint(lambda y: (y * 3).sin(), w, use_reentrant=False)
    loss = (c * b).sum()
    (g,) = torch.autograd.grad(loss, [w])
    return g


# Live at the peak, the last product of the backward: the arguments x and
# w (2 KiB), b and c (2 KiB; checkpoint dropped y * 3 after the forward),
# the loss and autograd's root gradient (4 + 4 B), and the backward's
# grad of c, the recomputed y * 3, its cos and the grad of y * 3 (4 KiB).
HAND_PEAK = 2 * KIB + 2 * KIB + 8 + 4 * KIB
# Read and written, views counting nothing: x * 2 (2 KiB), add_ (reads
# 1 KiB; its result aliases its input), a + x (3), w * 3 (2), sin (2),
# c * b (3), sum (1 KiB + 4 B), the root gradient (4 + 4 B), grad of c =
# expanded root * b (3 KiB), the recompute of w * 3 (2), cos (2), grad of
# y * 3 (3), the grad of w (2).
HAND_ACCESSED = (2 + 1 + 3 + 2 + 2 + 3) * KIB + KIB + 4 + 8 \
    + (3 + 2 + 2 + 3 + 2) * KIB


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_hand_counted_step(device):
    x = torch.zeros(256, device=device)
    w = torch.zeros(256, device=device).requires_grad_(True)
    stats = trace_step(_hand_step, x, w)
    assert stats["argument_bytes"] == 2 * KIB
    assert stats["output_bytes"] == KIB
    assert stats["peak_bytes"] == HAND_PEAK
    # the output (the grad of w) is born after the peak
    assert stats["temp_bytes"] == HAND_PEAK - 2 * KIB
    assert stats["bytes_accessed"] == HAND_ACCESSED
    assert stats["compile_s"] is None


def test_books_hold_under_threads_that_add_and_free():
    """The counter's books under more threads than cores, each adding
    storages and dropping them (their weakref callbacks free them, as the
    autograd engine's threads do): every add is matched by its free."""
    counter = StepCounter()

    def churn():
        for n in range(1, 200):
            t = torch.empty(n, device="meta")
            counter._add(t.untyped_storage())
            del t

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=churn)
                   for _ in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert counter.live_bytes == 0 and counter._live == {}
    assert 199 * 4 <= counter.peak_bytes <= len(threads) * 199 * 4


@functools.lru_cache(maxsize=None)
def _smoke_step(remat: bool, device: str) -> dict:
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import make_batch_for
    from repro_torch.models import transformer
    from repro_torch.training import adamw_init
    from repro_torch.training.train_loop import make_train_step

    cfg = dataclasses.replace(smoke_config(get_config("starcoder2_3b")),
                              remat=remat)
    if device == "meta":
        params = transformer.abstract_params(cfg)
    else:
        params = transformer.init_params(torch.Generator().manual_seed(0),
                                         cfg)
    batch = {k: torch.tensor(v, device=device)
             for k, v in make_batch_for(cfg, 2, 64, seed=1).items()}
    step = make_train_step(cfg)
    # the first step on a device fills the model's cached rope table there
    # (kept for later steps, as on the card); the second is the one counted
    step(params, adamw_init(params), batch)
    return trace_step(step, params, adamw_init(params), batch)


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off",
                                                      "remat_on"])
def test_smoke_train_step_same_peak_on_meta_and_cpu(remat):
    meta, cpu = _smoke_step(remat, "meta"), _smoke_step(remat, "cpu")
    for key in ("peak_bytes", "temp_bytes", "bytes_accessed",
                "argument_bytes"):
        assert meta[key] == cpu[key], (key, meta[key], cpu[key])
    assert meta["peak_bytes"] > meta["argument_bytes"] > 0


def test_remat_lowers_the_smoke_train_step_peak():
    off, on = _smoke_step(False, "meta"), _smoke_step(True, "meta")
    assert on["peak_bytes"] < off["peak_bytes"]
    assert on["temp_bytes"] < off["temp_bytes"]
    # the recompute reads and writes more
    assert on["bytes_accessed"] > off["bytes_accessed"]


CHECK = r"""
import json
for k in ("peak_bytes", "temp_bytes", "bytes_accessed"):
    assert isinstance(stats[k], int) and stats[k] > 0, (k, stats[k])
assert stats["peak_bytes"] >= stats["argument_bytes"] > 0, stats
assert stats["peak_bytes"] >= stats["temp_bytes"], stats
print("MEMORY_OK", json.dumps({k: stats[k] for k in (
    "peak_bytes", "temp_bytes", "bytes_accessed", "argument_bytes")}))
"""

MOE_TRAIN = r"""
import dataclasses
import torch
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.dryrun import StepCounter, trace_step
from repro_torch.launch.mesh import fake_mesh, init_fake_process_group
from repro_torch.launch.specs import LoweredSpec, distributed_args, lower_cell
from repro_torch.models import transformer
from repro_torch.sharding.logical import rules_for
from repro_torch.sharding.partition import param_shardings
from repro_torch.training.optimizer import OptState, adamw_init
from repro_torch.training.train_loop import make_train_step

init_fake_process_group(8)
mesh = fake_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = dataclasses.replace(smoke_config(get_config("mixtral_8x22b")),
                          remat=False)
rules = rules_for(cfg, mesh, "train")
abstract = transformer.abstract_params(cfg)
p_axes = transformer.param_axes(cfg)
opt = adamw_init(abstract)
batch = {k: torch.empty((8, 16), dtype=torch.int32, device="meta")
         for k in ("tokens", "labels")}
cell = LoweredSpec(
    "mixtral_8x22b", "train_4k", make_train_step(cfg),
    (abstract, opt, batch),
    (param_shardings(abstract, p_axes, mesh, rules),
     param_shardings(opt, OptState(step=(), mu=p_axes, nu=p_axes), mesh,
                     rules),
     param_shardings(batch, {k: ("batch", None) for k in batch}, mesh,
                     rules)), (0, 1), cfg, rules)
stats = trace_step(lambda *a: lower_cell(cell, mesh, a),
                   *distributed_args(cell))
"""

DENSE = r"""
import torch
from repro_torch.configs import ShapeSpec, smoke_config
from repro_torch.launch import specs
from repro_torch.launch.dryrun import StepCounter, trace_step
from repro_torch.launch.mesh import fake_mesh, init_fake_process_group

init_fake_process_group(4)
mesh = fake_mesh((2, 2), ("data", "model"))
real = specs.get_config
specs.get_config = lambda arch: smoke_config(real(arch))
specs.SHAPES["__SHAPE__"] = ShapeSpec("__SHAPE__", 64, 4, "__KIND__")
cell = specs.build_cell("starcoder2_3b", "__SHAPE__", mesh)
stats = trace_step(lambda *a: specs.lower_cell(cell, mesh, a),
                   *specs.distributed_args(cell))
"""

CELLS = {
    "moe_train_2x2x2": MOE_TRAIN,
    "dense_prefill_2x2": DENSE.replace("__SHAPE__", "prefill_32k").replace(
        "__KIND__", "prefill"),
    "dense_decode_2x2": DENSE.replace("__SHAPE__", "decode_32k").replace(
        "__KIND__", "decode"),
}


@pytest.fixture(scope="module")
def cell_runs():
    """The three cells' subprocesses, all started together."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {name: subprocess.Popen([sys.executable, "-c", code + CHECK],
                                    env=env, cwd=ROOT, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
             for name, code in CELLS.items()}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_reports_memory_keys(cell_runs, cell):
    out, err = cell_runs[cell].communicate(timeout=120)
    assert cell_runs[cell].returncode == 0, err[-3000:]
    assert "MEMORY_OK" in out
