"""The dry run's count of what each rank runs under DTensor
(``repro_torch.launch.dryrun.StepCounter``) and the sharded step's
per-device work (``repro_torch.sharding.logical``, the models).

Each case runs in a subprocess with a fake process group of its own (a
process group is its process's default group), all started together, the
cards hidden from it. Its meshes are ``launch.mesh.fake_mesh``'s, typed
``"cuda"`` as a card run's are, so DTensor launches the collectives it
would launch on the cards:

- operations DTensor must redistribute their inputs for, on a 2x2 mesh
  (a product of row shards; a product of column shards and an add of a
  row shard): the counter sees the implicit all-gathers and all-to-alls,
  the transient gathered copies and the local product, to hand-counted
  bytes and flops, on meta and on CPU tensors; its collective counts are
  ``CommDebugMode``'s; a second call (the sharding propagator's cache hit)
  counts what the first did; a shard moved from one dim to another on one
  mesh axis is one all-to-all of the local shard, and no all-gather;
  an operation whose sharding DTensor finds by tracing its decomposition
  on global-shape meta tensors counts the same on meta and CPU tensors
  (where those meta tensors could not count) and on either call;
- ``logical_new`` makes only the rank's shard, and a small prefill cell's
  peak is lower than with the whole cache behind each shard by exactly the
  global cache less the rank's;
- on a 2x4 mesh whose model axis does not divide the heads (so attention
  runs sequence-parallel), no weight-gradient product of a small train
  step comes out replicated over the model axis where its weight is split
  there;
- the production meshes are ``"cuda"``-typed, and a dry-run cell traced
  on the 16x16 mesh leaves CUDA unstarted.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = r"""
import json
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
from torch.distributed.tensor._utils import compute_global_tensor_info
from repro_torch.launch import mesh as launch_mesh

def fake_mesh(shape, names):
    n = 1
    for s in shape:
        n *= s
    launch_mesh.init_fake_process_group(n)
    return launch_mesh.fake_mesh(shape, names)


def on_mesh(local, mesh, place):
    # DTensor.from_local, less its move of a non-meta shard to the mesh's
    # device type: the CPU cases keep their shards on the host
    shape, stride = compute_global_tensor_info(local, mesh, place)
    spec = DTensorSpec(mesh, tuple(place), TensorMeta(
        torch.Size(shape), tuple(stride), local.dtype))
    return DTensor(local, spec, requires_grad=local.requires_grad)
"""

IMPLICIT = PRELUDE + r"""
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.launch.dryrun import StepCounter, trace_step

mesh = fake_mesh((2, 2), ("data", "model"))
out = {}
for device in ("meta", "cpu"):
    def dt(shape, place):
        return on_mesh(torch.zeros(shape, device=device), mesh, place)
    # d, e: global [8, 8] float32 split by rows over "model": d @ e
    # gathers e's rows
    d = dt((4, 8), (Replicate(), Shard(0)))
    e = dt((4, 8), (Replicate(), Shard(0)))
    # a, b: global [8, 8] split by columns over "model"; c: split by rows
    a = dt((8, 4), (Replicate(), Shard(1)))
    b = dt((8, 4), (Replicate(), Shard(1)))
    c = dt((4, 8), (Replicate(), Shard(0)))
    for name, step, args in (("rows", lambda d, e: d @ e, (d, e)),
                             ("columns", lambda a, b, c: a @ b + c,
                              (a, b, c))):
        out[f"{device}_{name}"] = [trace_step(step, *args)
                                   for _ in range(2)]
        with CommDebugMode() as comm:
            step(*args)
        out[f"{device}_{name}_comm"] = {
            str(k): v for k, v in comm.get_comm_counts().items()}
    # softplus's backward has no sharding strategy of its own: DTensor
    # traces its decomposition on global-shape meta tensors to choose one
    x = dt((8, 4), (Shard(0), Shard(1))).requires_grad_(True)

    def softplus_step(x):
        y = torch.nn.functional.softplus(x)
        return torch.autograd.grad(y.sum(), [x])[0]

    out[device + "_decomposed"] = [trace_step(softplus_step, x)
                                   for _ in range(2)]
    # a [4, 8] float32 row shard of [8, 8] over "model" moved to a column
    # shard: the local result is [8, 4]
    m = dt((4, 8), (Replicate(), Shard(0)))
    with StepCounter() as counter:
        moved = m.redistribute(mesh, (Replicate(), Shard(1)))
    out[device + "_move"] = {
        "bytes": counter.collective_bytes,
        "counts": counter.collective_counts,
        "local_shape": list(moved.to_local().shape),
        "local_device": moved.to_local().device.type}
print("RESULT", json.dumps(out))
"""

NEW = PRELUDE + r"""
import dataclasses
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)
from repro_torch.configs import ShapeSpec, smoke_config
from repro_torch.launch import dryrun, specs
from repro_torch.models import kvcache
from repro_torch.sharding import logical
from repro_torch.sharding.logical import (TRAIN_RULES, logical_new,
                                          placements, resolve_spec, use_rules)

mesh = fake_mesh((2, 2), ("data", "model"))
out = {}
shape = (4, 6, 16, 8)
axes = ("batch", None, "kv_seq", None)
# meta: on the "cuda"-typed mesh ``DTensor.from_local`` would move a host
# shard to a card
zeros = lambda s: torch.zeros(s, dtype=torch.bfloat16, device="meta")
out["plain_bytes"] = logical_new(zeros, shape, *axes).untyped_storage(
    ).nbytes()
rules = dict(TRAIN_RULES, kv_seq=("model",))
with use_rules(rules, mesh):
    t = logical_new(zeros, shape, *axes)
out["local_bytes"] = t.to_local().untyped_storage().nbytes()
out["global_shape"] = list(t.shape)
out["placements"] = [str(p) for p in t.placements]


def whole_then_placed(factory, shape, *axes):
    # the earlier contract: the whole tensor made, each rank keeping a view
    # of its slice (so the whole storage stays live behind it)
    rules, mesh = logical.current_rules(), logical.current_mesh()
    whole = factory(torch.Size(shape))
    if rules is None or mesh is None:
        return whole
    place = placements(resolve_spec(shape, axes, mesh, rules), mesh)
    local, offset = compute_local_shape_and_global_offset(shape, mesh, place)
    view = whole[tuple(slice(o, o + n) for o, n in zip(offset, local))]
    return DTensor.from_local(view, mesh, place, run_check=False,
                              shape=torch.Size(shape), stride=whole.stride())


real = specs.get_config
specs.get_config = lambda arch: smoke_config(real(arch))
specs.SHAPES["prefill_32k"] = ShapeSpec("prefill_32k", 64, 4, "prefill")
cell = specs.build_cell("starcoder2_3b", "prefill_32k", mesh)


def trace():
    return dryrun.trace_step(lambda *a: specs.lower_cell(cell, mesh, a),
                             *specs.distributed_args(cell))


trace()         # fills the model's per-device caches (the rope table)
out["shard_peak"] = trace()["peak_bytes"]
kvcache.logical_new = whole_then_placed
out["whole_peak"] = trace()["peak_bytes"]
kvcache.logical_new = logical_new
cfg = cell.cfg
ring = (cfg.num_periods(), 4, cfg.num_kv_heads, 64, cfg.resolved_head_dim)
with use_rules(cell.rules, mesh):
    k = kvcache.init_cache(cfg, 4, 64, device="meta")["slot0"]["k"]
out["cache_tensors"] = 2 * len(cfg.block_pattern())
out["cache_global_bytes"] = k.numel() * k.element_size()
out["cache_local_bytes"] = k.to_local().numel() * k.element_size()
out["cache_shape"] = list(k.shape)
out["ring"] = list(ring)
print("RESULT", json.dumps(out))
"""

GRADS = PRELUDE + r"""
import dataclasses
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.specs import LoweredSpec, lower_cell
from repro_torch.models import transformer
from repro_torch.sharding.logical import resolve_spec, rules_for
from repro_torch.sharding.partition import param_shardings
from repro_torch.training.optimizer import OptState, adamw_init
from repro_torch.training.train_loop import make_train_step

mesh = fake_mesh((2, 4), ("data", "model"))
# 6 heads on a 4-way model axis: attention runs sequence-parallel, the
# case in which the row-parallel products' inputs were left replicated
cfg = dataclasses.replace(smoke_config(get_config("starcoder2_3b")),
                          num_heads=6, num_kv_heads=2, remat=True)
rules = rules_for(cfg, mesh, "train")
abstract = transformer.abstract_params(cfg)
p_axes = transformer.param_axes(cfg)
opt = adamw_init(abstract)
# many tokens against the widths, as at the production shapes: with few,
# DTensor's cost model splits those products over "model" even from a
# replicated input (its choice depends on the sizes)
batch = {k: torch.empty((8, 512), dtype=torch.int32, device="meta")
         for k in ("tokens", "labels")}
cell = LoweredSpec(
    "starcoder2_3b", "train_4k", make_train_step(cfg),
    (abstract, opt, batch),
    (param_shardings(abstract, p_axes, mesh, rules),
     param_shardings(opt, OptState(step=(), mu=p_axes, nu=p_axes), mesh,
                     rules),
     param_shardings(batch, {k: ("batch", None) for k in batch}, mesh,
                     rules)), (0, 1), cfg, rules)

# each 2-D weight (a stacked slot leaf without its periods dim) split over
# "model", by its shape and its transpose (the head's product takes table.T;
# w_up and w_down have transposed shapes, as wq and wo do)
def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in flat(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


weights = {}
axes_by_name = dict(flat(p_axes))
for name, w in flat(abstract):
    ax = axes_by_name[name]
    shape, ax = (tuple(w.shape[1:]), ax[1:]) if ax[0] == "layers" else (
        tuple(w.shape), ax)
    spec = resolve_spec(shape, ax, mesh, rules)
    if len(shape) == 2 and any(
            e == "model" or (isinstance(e, tuple) and "model" in e)
            for e in spec):
        for key in (shape, shape[::-1]):
            weights.setdefault(key, []).append(name)


class Products(TorchDispatchMode):
    # every product on DTensors, by its global output shape: placements
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.mm.default and isinstance(out, DTensor):
            self.seen.append((tuple(out.shape),
                              [str(p) for p in out.placements]))
        return out


with Products() as products:
    lower_cell(cell, mesh)
model = mesh.mesh_dim_names.index("model")
grads = [(weights[s], s, p) for s, p in products.seen if s in weights]
print("RESULT", json.dumps({"grads": grads, "model": model, "weights": sorted(
    {n for names in weights.values() for n in names})}))
"""

CARD_FREE = r"""
import json
import torch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (init_fake_process_group,
                                     make_production_mesh)

init_fake_process_group()
types = [make_production_mesh(multi_pod=m).device_type for m in (False, True)]
cell = dryrun.run_cell("starcoder2_3b", "decode_32k", make_production_mesh(),
                       verbose=False, with_roofline=False)
print("RESULT", json.dumps({"types": types, "cell": cell,
                            "cuda": torch.cuda.is_initialized()}))
"""

CASES = {"implicit": IMPLICIT, "new": NEW, "grads": GRADS,
         "card_free": CARD_FREE}


@pytest.fixture(scope="module")
def results():
    """Each case's subprocess, all started together; its RESULT line."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = {name: subprocess.Popen([sys.executable, "-c", code], env=env,
                                    cwd=ROOT, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
             for name, code in CASES.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=180)
            assert proc.returncode == 0, (name, stderr[-3000:])
            line = next(ln for ln in stdout.splitlines()
                        if ln.startswith("RESULT "))
            out[name] = json.loads(line[len("RESULT "):])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


# d @ e: e's [4, 8] float32 shard all-gathered over "model" into [8, 8]
# (256 B), the local product [4, 8] @ [8, 8] (2 * 4 * 8 * 8 flops, a 128 B
# result). Live: the arguments (2 x 128 B), the gathered rows (256) and the
# product (128), the peak; the product is the output.
ROWS = {"flops": 2 * 4 * 8 * 8,
        "collective_bytes": {"all-gather": 8 * 8 * 4},
        "collective_counts": {"all-gather": 1},
        "argument_bytes": 2 * 128,
        "output_bytes": 128,
        "peak_bytes": 2 * 128 + 256 + 128,
        "temp_bytes": 256,
        # gather 128 + 256, product 128 + 256 + 128
        "bytes_accessed": 384 + 512}
# a @ b + c: a's column shard all-gathered (a [16, 4] result, 256 B) for
# the local product [8, 8] @ [8, 4]; the product moved from column to row
# shards for the add, on the card-typed mesh by one all-to-all of the
# local shard (a [4, 8] result, 128 B). How DTensor stages that move (its
# copies, so the peak) differs between torch releases; its collectives and
# flops do not.
COLUMNS = {"flops": 2 * 8 * 8 * 4,
           "collective_bytes": {"all-gather": 16 * 4 * 4,
                                "all-to-all": 4 * 8 * 4},
           "collective_counts": {"all-gather": 1, "all-to-all": 1},
           "argument_bytes": 3 * 128,
           "output_bytes": 128}
SAME = ("flops", "peak_bytes", "temp_bytes", "bytes_accessed",
        "collective_bytes")


@pytest.mark.parametrize("case", ["rows", "columns"])
@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_implicit_redistribution_is_counted_to_hand_counts(results, device,
                                                          case):
    first, second = results["implicit"][f"{device}_{case}"]
    for key, want in {"rows": ROWS, "columns": COLUMNS}[case].items():
        assert first[key] == want, (key, first[key], want)
    # the sharding propagator's shape inference (global shapes, a cache
    # miss only) is not counted: the second call counts the same
    for key in SAME:
        assert second[key] == first[key], (key, second[key], first[key])


def test_sharding_propagation_is_not_counted(results):
    runs = [{k: run[k] for k in SAME}
            for device in ("meta", "cpu")
            for run in results["implicit"][device + "_decomposed"]]
    assert all(run == runs[0] for run in runs), runs


@pytest.mark.parametrize("case", ["rows", "columns"])
@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_collective_counts_equal_comm_debug_mode(results, device, case):
    comm = results["implicit"][f"{device}_{case}_comm"]
    kinds = {"all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_reduce": "all-reduce",
             "shard_dim_alltoall": "all-to-all"}
    counted = {}
    for op, n in comm.items():
        kind = next(v for k, v in kinds.items() if op.endswith(k))
        counted[kind] = counted.get(kind, 0) + n
    assert counted == results["implicit"][f"{device}_{case}"][0][
        "collective_counts"]


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_shard_to_shard_move_is_one_all_to_all_of_the_shard(results,
                                                            device):
    r = results["implicit"][device + "_move"]
    assert r["counts"] == {"all-to-all": 1}, r
    assert r["bytes"] == {"all-to-all": 4 * 8 * 4}, r     # the local shard
    assert r["local_shape"] == [8, 4] and r["local_device"] == device, r


def test_dry_run_mesh_is_card_typed_and_leaves_cuda_unstarted(results):
    r = results["card_free"]
    assert r["types"] == ["cuda", "cuda"], r["types"]
    cell = r["cell"]
    assert cell["ok"] and cell["mesh"] == [16, 16], cell
    assert cell["mesh_device_type"] == "cuda", cell
    assert cell["cuda_initialized"] is False and r["cuda"] is False, r
    assert cell["flops"] > 0 and cell["peak_bytes"] > 0, cell


def test_logical_new_holds_only_the_shard(results):
    r = results["new"]
    whole = 4 * 6 * 16 * 8 * 2                  # bf16
    assert r["plain_bytes"] == whole            # off a mesh: the whole
    assert r["global_shape"] == [4, 6, 16, 8]
    assert r["placements"] == ["S(0)", "S(2)"]
    assert r["local_bytes"] == whole // 4       # batch / 2, kv_seq / 2


def test_prefill_peak_falls_by_global_less_local_cache(results):
    r = results["new"]
    assert r["cache_shape"] == r["ring"]
    saved = r["cache_tensors"] * (r["cache_global_bytes"]
                                  - r["cache_local_bytes"])
    assert r["cache_local_bytes"] * 4 == r["cache_global_bytes"]
    assert r["whole_peak"] - r["shard_peak"] == saved, (r, saved)


def test_no_weight_gradient_is_replicated_over_the_model_axis(results):
    r = results["grads"]
    assert {"['slots']['slot0']['mlp']['w_down']",
            "['slots']['slot0']['attn']['wo']"} <= set(r["weights"])
    names = {name for names, _, _ in r["grads"] for name in names}
    assert {"['slots']['slot0']['mlp']['w_down']",
            "['slots']['slot0']['attn']['wo']",
            "['slots']['slot0']['attn']['wq']"} <= names, names
    replicated = [(names, shape, place) for names, shape, place in r["grads"]
                  if place[r["model"]] == "R"]
    assert not replicated, replicated
