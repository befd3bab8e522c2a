"""The train step's vocab-parallel cross-entropy
(``repro_torch.training.train_loop.cross_entropy_loss`` under rules and a
mesh that split the vocabulary) against the plain loss, on two gloo ranks
of one machine (``tcp://localhost``), the vocabulary split between them.

Float32 logits [2, 3, 16] from a seed, the columns past the logical
vocabulary at ``layers.NEG_INF`` as ``unembed`` leaves them. The cases:
labels on each side of the split; a label in the padded tail; a logical
vocabulary that leaves the second rank's whole shard padded. Loss and the
logits' gradient agree within 1e-6 (relative for the loss).
"""
import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# case: (logical vocabulary, labels [2, 3]); rank 0 holds columns 0-7
CASES = {
    "both_sides": (13, [[0, 7, 8], [12, 3, 9]]),
    "padded_tail_label": (13, [[0, 7, 8], [15, 3, 12]]),
    "padded_shard": (7, [[0, 6, 1], [2, 3, 5]]),
}

RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.models.layers import NEG_INF
from repro_torch.sharding.logical import TRAIN_RULES, use_rules
from repro_torch.training.train_loop import cross_entropy_loss

rank, port, cases = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
out = {}
for name, (lv, labels) in cases.items():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(
        rng.standard_normal((2, 3, 16)).astype(np.float32) * 3)
    logits[..., lv:] = NEG_INF
    labels = torch.tensor(labels, dtype=torch.int32)
    plain = logits.clone().requires_grad_(True)
    loss = cross_entropy_loss(plain, labels, lv)
    (grad,) = torch.autograd.grad(loss, [plain])
    split = distribute_tensor(logits, mesh, (Replicate(), Shard(2)))
    split.requires_grad_(True)
    with use_rules(dict(TRAIN_RULES), mesh):
        vp = cross_entropy_loss(split, distribute_tensor(
            labels, mesh, (Replicate(), Replicate())), lv)
        (vgrad,) = torch.autograd.grad(vp, [split])
    out[name] = {
        "loss": float(loss),
        "vp_loss": float(vp.full_tensor() if isinstance(vp, DTensor) else vp),
        "grad_err": float((vgrad.full_tensor() - grad).abs().max()),
        "grad_placements": [str(p) for p in vgrad.placements],
        "local_width": split.to_local().shape[-1]}
print("RESULT", json.dumps(out))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks():
    """Both ranks' RESULT lines."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(rank), port, json.dumps(CASES)],
        env=env, cwd=ROOT, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for rank in (0, 1)]
    results = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=120)
            assert proc.returncode == 0, stderr[-3000:]
            line = next(ln for ln in stdout.splitlines()
                        if ln.startswith("RESULT "))
            results.append(json.loads(line[len("RESULT "):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rank", [0, 1])
def test_vocab_parallel_loss_equals_the_plain_loss(ranks, case, rank):
    r = ranks[rank][case]
    assert r["local_width"] == 8                 # the vocabulary is split
    assert r["grad_placements"] == ["R", "S(2)"]  # the gradient stays so
    assert abs(r["vp_loss"] - r["loss"]) <= 1e-6 * abs(r["loss"]), r
    assert r["grad_err"] <= 1e-6, r
