"""The port's dry run (``repro_torch.launch.{mesh,specs,dryrun}``) at CI
size. Each test runs in a subprocess: a process group is its process's
default group, and the fake group of the dry run and the gloo group of the
local mesh cannot share one.

- The twin of ``tests/test_generate.py``'s
  ``test_mini_multipod_dryrun_compiles``: Mixtral's smoke config without
  remat, its train step on a 2x2x2 ("pod", "data", "model") mesh of 8
  fake ranks, every parameter, moment and batch a meta DTensor placed by
  the rules; flops counted, within 120 s.
- A dense smoke prefill cell and decode cell through ``build_cell`` /
  ``lower_cell`` on a 2x2 mesh.
- The collective accounting on hand-built collectives of known bytes.
- A 1x1 gloo mesh on the CPU: the train step with the parameters as
  DTensors under the rules equals the plain step bit for bit.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(code: str, timeout: int) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


MINI_DRYRUN = r"""
import dataclasses
import torch
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.dryrun import StepCounter
from repro_torch.launch.mesh import fake_mesh, init_fake_process_group
from repro_torch.launch.specs import LoweredSpec, lower_cell
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
p_shard = param_shardings(abstract, p_axes, mesh, rules)
opt = adamw_init(abstract)
opt_shard = param_shardings(opt, OptState(step=(), mu=p_axes, nu=p_axes),
                            mesh, rules)
batch = {k: torch.empty((8, 16), dtype=torch.int32, device="meta")
         for k in ("tokens", "labels")}
b_shard = param_shardings(batch, {k: ("batch", None) for k in batch}, mesh,
                          rules)
cell = LoweredSpec("mixtral_8x22b", "train_4k", make_train_step(cfg),
                   (abstract, opt, batch), (p_shard, opt_shard, b_shard),
                   (0, 1), cfg, rules)
with StepCounter() as counter:
    params, opt_state, metrics = lower_cell(cell, mesh)
assert counter.flops > 0, counter.flops
assert counter.collective_bytes.get("all-gather", 0) > 0
w = params["slots"]["slot0"]["moe"]["w_in"]
assert w.device.type == "meta" and tuple(w.shape) == (2, 4, 128, 2, 128)
print("MINI_DRYRUN_OK", counter.flops, counter.collective_bytes)
"""


def test_mini_multipod_dryrun_runs():
    """A 2x2x2 'pod/data/model' mesh must trace the MoE smoke config's
    train step end to end: the CI-speed version of the production dry
    run."""
    assert "MINI_DRYRUN_OK" in run(MINI_DRYRUN, timeout=120)


DENSE_CELLS = r"""
import torch
from torch.distributed.tensor import DTensor
from repro_torch.configs import SHAPES, ShapeSpec, get_config, smoke_config
from repro_torch.launch import specs
from repro_torch.launch.dryrun import StepCounter, local_bytes
from repro_torch.launch.mesh import fake_mesh, init_fake_process_group

init_fake_process_group(4)
mesh = fake_mesh((2, 2), ("data", "model"))
real = specs.get_config
specs.get_config = lambda arch: smoke_config(real(arch))
specs.SHAPES["prefill_32k"] = ShapeSpec("prefill_32k", 64, 4, "prefill")
specs.SHAPES["decode_32k"] = ShapeSpec("decode_32k", 64, 4, "decode")
for shape in ("prefill_32k", "decode_32k"):
    cell = specs.build_cell("starcoder2_3b", shape, mesh)
    args = specs.distributed_args(cell)
    with StepCounter() as counter:
        logits, cache = specs.lower_cell(cell, mesh, args)
    assert isinstance(logits, DTensor) and logits.device.type == "meta"
    assert tuple(logits.shape) == (4, cell.cfg.vocab_size), logits.shape
    k = cache["slot0"]["k"]
    assert tuple(k.shape) == (cell.cfg.num_periods(), 4,
                              cell.cfg.num_kv_heads, 64,
                              cell.cfg.resolved_head_dim)
    assert counter.flops > 0 and local_bytes(args) > 0
    print("CELL_OK", shape, counter.flops, counter.collective_bytes)
"""


def test_dense_smoke_prefill_and_decode_cells():
    out = run(DENSE_CELLS, timeout=120)
    assert "CELL_OK prefill_32k" in out and "CELL_OK decode_32k" in out


COLLECTIVES = r"""
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.launch.dryrun import StepCounter
from repro_torch.launch.mesh import fake_mesh, init_fake_process_group

init_fake_process_group(4)
mesh = fake_mesh((2, 2), ("data", "model"))
x = DTensor.from_local(torch.empty((2, 16), device="meta"), mesh,
                       (Shard(0), Replicate()), run_check=False)
p = DTensor.from_local(torch.empty((4, 4), dtype=torch.bfloat16,
                                   device="meta"), mesh,
                       (Replicate(), Partial()), run_check=False)
with StepCounter() as counter:
    x.redistribute(mesh, (Replicate(), Replicate()))     # [4, 16] float32
    p.redistribute(mesh, (Replicate(), Replicate()))     # [4, 4] bf16
print("BYTES", counter.collective_bytes, counter.collective_counts)
assert counter.collective_bytes == {"all-gather": 4 * 16 * 4,
                                    "all-reduce": 4 * 4 * 2}
assert counter.collective_counts == {"all-gather": 1, "all-reduce": 1}
print("COLLECTIVES_OK")
"""


def test_collective_accounting_of_known_bytes():
    """An all-gather of a float32 [2, 16] shard over 2 ranks and an
    all-reduce of a bf16 [4, 4] partial: each counted once, by the bytes
    of its result on one rank."""
    assert "COLLECTIVES_OK" in run(COLLECTIVES, timeout=60)


LOCAL_MESH = r"""
import copy
import dataclasses
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import make_batch_for
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import transformer
from repro_torch.sharding.logical import rules_for, use_rules
from repro_torch.sharding.partition import distribute_tree, param_shardings
from repro_torch.training import adamw_init
from repro_torch.training.train_loop import make_train_step
from repro_torch.training.tree import leaves_with_names

cfg = dataclasses.replace(smoke_config(get_config("starcoder2_3b")),
                          remat=True, compute_dtype="float32")
mesh = make_local_mesh("cpu")
rules = rules_for(cfg, mesh, "train")
step = make_train_step(cfg)
params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
batch = {k: torch.from_numpy(v)
         for k, v in make_batch_for(cfg, 2, 16, seed=1).items()}
plain = copy.deepcopy(params)
p0, o0, m0 = step(plain, adamw_init(plain), batch)
dist_params = distribute_tree(params, param_shardings(
    params, transformer.param_axes(cfg), mesh, rules))
with use_rules(rules, mesh), implicit_replication():
    p1, o1, m1 = step(dist_params, adamw_init(dist_params), batch)
for k in m0:
    assert float(m0[k]) == float(m1[k]), (k, m0[k], m1[k])
for (name, a), (_, b) in zip(leaves_with_names((p0, o0)),
                             leaves_with_names((p1, o1))):
    assert isinstance(b, DTensor) or ".step" in name, name
    b = b.full_tensor() if isinstance(b, DTensor) else b
    assert torch.equal(a, b), name
print("LOCAL_MESH_OK", {k: float(v) for k, v in m0.items()})
"""


def test_local_mesh_train_step_equals_the_plain_step():
    assert "LOCAL_MESH_OK" in run(LOCAL_MESH, timeout=120)
