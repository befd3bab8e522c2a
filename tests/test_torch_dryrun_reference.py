"""The port's dry run against the reference's, per device, on
StarCoder2-3B x train_4k over the 16x16 mesh at 1 and 2 periods (24 heads
on a 16-way model axis: attention runs sequence-parallel).

The reference's side runs ``repro.launch.dryrun._compile_stats`` in a
subprocess of its own (512 XLA host devices), its mesh built with Auto
axes: ``make_production_mesh`` calls ``jax.make_mesh`` without
``axis_types``, which jax 0.9 makes Explicit, and its sharding hints then
refuse the mesh. The port's side runs ``repro_torch.launch.dryrun.
_trace_stats`` in another, over a fake process group of 512 ranks; the two
start together.

- the argument bytes (the parameters', moments' and batch's local shards)
  are equal to the byte at both depths;
- one period's flops, the 2-period count less the 1-period count (XLA
  counts a loop body once; both lower the periods unrolled here), agree
  within 1.3x: the port computes each product on its own shards, as the
  reference's partitioner does;
- one period's collective bytes, all kinds together, are within 2x of
  the reference's: the port's mesh is typed as a card run's, so DTensor
  moves a shard between dims by an all-to-all of the shard, not by
  gathering the whole dim.

``python tests/test_torch_dryrun_reference.py`` prints both sides' numbers
at each depth and per period, as one JSON line.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = ("starcoder2_3b", "train_4k")
KEYS = ("flops", "argument_bytes", "temp_bytes", "collective_bytes")

REFERENCE = r"""
import json
import jax
import repro.launch.dryrun as dryrun          # sets XLA_FLAGS first
from repro.launch.mesh import make_production_mesh

make_mesh = jax.make_mesh


def auto_mesh(shape, axes, **kw):
    return make_mesh(shape, axes, axis_types=(jax.sharding.AxisType.Auto,)
                     * len(axes), **kw)


jax.make_mesh = auto_mesh
mesh = make_production_mesh()
out = {n: dryrun._compile_stats(__ARCH__, __SHAPE__, mesh, n_periods=n)
       for n in (1, 2)}
print("RESULT", json.dumps({n: {k: v[k] for k in __KEYS__}
                            for n, v in out.items()}))
"""

PORT = r"""
import json
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (init_fake_process_group,
                                     make_production_mesh)

init_fake_process_group()
mesh = make_production_mesh()
out = {n: dryrun._trace_stats(__ARCH__, __SHAPE__, mesh, n_periods=n)
       for n in (1, 2)}
print("RESULT", json.dumps({n: {k: v[k] for k in __KEYS__}
                            for n, v in out.items()}))
"""


def _code(template: str) -> str:
    return (template.replace("__ARCH__", repr(CELL[0]))
            .replace("__SHAPE__", repr(CELL[1]))
            .replace("__KEYS__", repr(KEYS)))


def run_sides() -> dict:
    """{"reference": {1: stats, 2: stats}, "port": ...}, both subprocesses
    started together."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _code(code)], env=env, cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for name, code in (("reference", REFERENCE), ("port", PORT))}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, (name, stderr[-3000:])
            line = next(ln for ln in stdout.splitlines()
                        if ln.startswith("RESULT "))
            out[name] = {int(n): v for n, v in
                         json.loads(line[len("RESULT "):]).items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


@pytest.fixture(scope="module")
def sides():
    return run_sides()


@pytest.mark.parametrize("periods", [1, 2])
def test_argument_bytes_equal_the_reference(sides, periods):
    assert sides["port"][periods]["argument_bytes"] \
        == sides["reference"][periods]["argument_bytes"], sides


def test_flops_of_one_period_within_1_3x_of_the_reference(sides):
    def period(side):
        return sides[side][2]["flops"] - sides[side][1]["flops"]

    ratio = period("port") / period("reference")
    assert 1 / 1.3 <= ratio <= 1.3, (ratio, sides)


def test_collective_bytes_of_one_period_within_2x_of_the_reference(sides):
    def period(side):
        return sum(sides[side][2]["collective_bytes"].values()) \
            - sum(sides[side][1]["collective_bytes"].values())

    ratio = period("port") / period("reference")
    assert 1 / 2 <= ratio <= 2, (ratio, sides)


if __name__ == "__main__":
    both = run_sides()
    for side in both.values():
        side["period"] = {
            k: side[2][k] - side[1][k] if k != "collective_bytes" else {
                kind: side[2][k].get(kind, 0) - side[1][k].get(kind, 0)
                for kind in set(side[1][k]) | set(side[2][k])}
            for k in KEYS}
    print(json.dumps({"cell": CELL, "mesh": [16, 16], **both}))
