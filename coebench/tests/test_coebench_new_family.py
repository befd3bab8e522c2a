"""A model family enters the benchmark through new files alone.

In a copy of ``BENCHMARK.json`` and the benchmark's folder, a family is
planted as a copy of StarCoder2's reference and FLOPs modules under a new
``model_type``, with its widths file, a configuration, and one cell on
``switch128`` whose name is appended to the ``workloads`` lists of the
metrics that the StarCoder2 ``switch128`` cell reports. The checks that hold
for every configuration then pass for it, a run of the cell at smoke widths
prints a correct last line with the cell's metrics, and no file the
benchmark had has changed but for those list entries.
"""
import copy
import json
import os
import shutil
import subprocess
import sys

from coebench import bench
from coebench.tests import smoke

LIKE = "starcoder2_3b_nobias_x14"        # the family and cell copied
FAMILY = "starcoder2_planted"
CONFIG = "starcoder2_planted_x14"
CELL = f"{CONFIG}.switch128"
NEW_FILES = {f"reference/{FAMILY}.py", f"flops/{FAMILY}.py",
             f"tests/widths/{FAMILY}.json", f"configs/{CONFIG}.json"}
# the checks that hold for every configuration, run in the copy
GENERIC = [
    "coebench/tests/test_coebench_files.py",
    "coebench/tests/test_coebench_weights.py::"
    f"test_layout_is_the_programs_init_params_tree[{CONFIG}]",
    "coebench/tests/test_coebench_reference.py::"
    f"test_reference_is_the_programs_function[{CONFIG}]",
    "coebench/tests/test_coebench_control.py::"
    f"test_control_reads_above_the_program[{CONFIG}]",
]


def _checkout(root):
    """``BENCHMARK.json`` and the benchmark's folder, with the program's
    sources beside them."""
    shutil.copy(smoke.ROOT / "BENCHMARK.json", root)
    for p in bench.Benchmark().spec["paths"]:
        shutil.copytree(smoke.ROOT / p, root / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(smoke.ROOT / "src")


def _files(folder):
    return {str(p.relative_to(folder)): p.read_bytes()
            for p in folder.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def plant(root):
    """The family's new files and the cell's list entries."""
    cb = root / "coebench"
    for kind in ("reference", "flops"):
        shutil.copy(cb / kind / "starcoder2.py", cb / kind / f"{FAMILY}.py")
    shutil.copy(cb / "tests" / "widths" / "starcoder2.json",
                cb / "tests" / "widths" / f"{FAMILY}.json")
    cfg = json.loads((cb / "configs" / f"{LIKE}.json").read_text())
    cfg.update(name=CONFIG, model_type=FAMILY)
    (cb / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg, indent=2))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = dict(next(c for c in spec["configs"] if c["name"] == LIKE))
    entry.update(name=CONFIG, file=f"coebench/configs/{CONFIG}.json")
    spec["configs"].append(entry)
    spec["workloads"].append({"name": CELL, "config": CONFIG,
                              "traffic": "switch128", "chips": 1,
                              "why": "a family planted by a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if f"{LIKE}.switch128" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))


def _unplanted(spec):
    out = copy.deepcopy(spec)
    out["configs"] = [c for c in out["configs"] if c["name"] != CONFIG]
    out["workloads"] = [w for w in out["workloads"] if w["name"] != CELL]
    for m in out["end_to_end"] + out["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    return out


def test_a_family_enters_through_new_files_alone(tmp_path):
    _checkout(tmp_path)
    had = _files(tmp_path / "coebench")
    spec_had = json.loads((tmp_path / "BENCHMARK.json").read_text())
    plant(tmp_path)
    has = _files(tmp_path / "coebench")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert {k: has[k] for k in had} == had
    assert set(has) - set(had) == NEW_FILES
    assert _unplanted(spec) == spec_had
    assert any(CELL in m.get("workloads", []) for m in spec["per_layer"])

    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("PYTEST_")}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         *GENERIC], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    passed = {line.split(" ")[0] for line in proc.stdout.splitlines()
              if " PASSED" in line}
    for node in GENERIC[1:] + [
            "coebench/tests/test_coebench_files.py::"
            f"test_config_found_and_cut_honestly[{CONFIG}]",
            f"coebench/tests/test_coebench_files.py::"
            f"test_workload_found[{CELL}]"]:
        assert node in passed, node

    rc, lines, err = smoke.run_cell(CELL, 2 ** 32 + 5, 1.0, root=tmp_path)
    assert rc == 0, err
    out = json.loads(lines[-1])
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    want = {m["name"] for m in spec["end_to_end"]
            if CELL in m.get("workloads", [CELL])}
    assert want == {"throughput_rps.switch128", "latency_p95_s.switch128",
                    "setup_s"}
    assert set(out["metrics"]) == want
