"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its copies of the pure-Python control plane and of the model configs
are the reference's sources with only the package name changed."""
import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")
REF = os.path.join(SRC, "repro")

# control-plane modules the port carries as renamed copies of the reference
VERBATIM = (
    [f"core/{n}.py" for n in (
        "__init__", "coe", "scheduler", "executor", "expert_manager",
        "memory", "profiler", "serving", "simulator", "decode", "workload",
        "reference")]
    + [f"{pkg}/{f}" for pkg in ("memory", "fleet", "serve", "obs")
       for f in sorted(os.listdir(os.path.join(REF, pkg)))
       if f.endswith(".py")]
    + ["api/spec.py", "api/artifacts.py", "analysis/cachesan.py",
       "models/config.py", "launch/elastic.py", "data/__init__.py",
       "data/pipeline.py"]
    + [f"configs/{f}" for f in sorted(os.listdir(os.path.join(REF, "configs")))
       if f.endswith(".py")])


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top.startswith("jax") or top == "repro"


def _port_files():
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n"
        "print(' '.join(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True).stdout
    count, loaded = out.strip().split("\n")
    assert int(count) >= len(VERBATIM)
    bad = [m for m in loaded.split() if _forbidden(m)]
    assert bad == []


@pytest.mark.parametrize("path", [*_port_files(),
                                  os.path.join(ROOT, "chip_smoke.py")],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_jax_or_reference(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert bad == []


@pytest.mark.parametrize("rel", VERBATIM)
def test_control_plane_copy_is_the_reference_renamed(rel):
    with open(os.path.join(REF, rel), encoding="utf-8") as f:
        want = re.sub(r"\brepro\.", "repro_torch.", f.read())
    with open(os.path.join(PORT, rel), encoding="utf-8") as f:
        assert f.read() == want
