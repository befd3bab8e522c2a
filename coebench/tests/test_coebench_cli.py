"""The benchmark's command without a card, or without the program beside
it: a non-zero exit and no result."""
import os
import shutil
import subprocess
import sys

from coebench import bench
from coebench.tests import smoke

CELL = "starcoder2_3b_nobias_x14.switch128"


def _cli(cwd, *args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "coebench/run.py", *args],
                          capture_output=True, text=True, timeout=120,
                          cwd=cwd, env=env)


def test_no_card_no_result():
    proc = _cli(str(smoke.ROOT), "--workload", CELL, "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A checkout of only ``BENCHMARK.json`` and the benchmark's folder
    lacks the program: no result, a non-zero exit."""
    spec = bench.Benchmark()
    shutil.copy(smoke.ROOT / "BENCHMARK.json", tmp_path)
    for p in spec.spec["paths"]:
        shutil.copytree(smoke.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['.']\n"
            "from coebench import run\n"
            f"sys.exit(run.main(['--workload', {CELL!r}, '--seed', '1', "
            "'--seconds', '1'], device='cpu'))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert not any(line.startswith('{"correct"')
                   for line in proc.stdout.splitlines())
