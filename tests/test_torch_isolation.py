"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its copies of the pure-Python control plane, of the model configs and
of the static analyzer's checks and CLI are the reference's sources with
only the package name changed."""
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


# the static analyzer's twin: the reference's text with ``repro.`` renamed,
# and besides that only these lines, which name the package as a bare path
# component (``module_name`` and the docstrings that describe it); its
# registry is the port's own
ANALYZER_TWIN = {
    "analysis/__main__.py": [],
    "analysis/checks.py": [
        ("``src/repro/...`` are checked with the real registries.",
         "``src/repro_torch/...`` are checked with the real registries."),
        ('    """Dotted module for a file path: everything from the last '
         '``repro``',
         '    """Dotted module for a file path: everything from the last '
         '``repro_torch``'),
        ("    path component on (``.../src/repro/core/executor.py`` ->",
         "    path component on (``.../src/repro_torch/core/executor.py`` "
         "->"),
        ('    ``repro_torch.core.executor``). Files outside a ``repro`` tree '
         'get ""',
         '    ``repro_torch.core.executor``). Files outside a '
         '``repro_torch`` tree get ""'),
        ('    if "repro" not in parts:', '    if "repro_torch" not in parts:'),
        ('    i = len(parts) - 1 - parts[::-1].index("repro")',
         '    i = len(parts) - 1 - parts[::-1].index("repro_torch")'),
    ],
}


@pytest.mark.parametrize("rel", sorted(ANALYZER_TWIN))
def test_analyzer_twin_is_the_reference_renamed(rel):
    with open(os.path.join(REF, rel), encoding="utf-8") as f:
        want = re.sub(r"\brepro\.", "repro_torch.", f.read()).split("\n")
    with open(os.path.join(PORT, rel), encoding="utf-8") as f:
        got = f.read().split("\n")
    assert len(got) == len(want)
    assert [(a, b) for a, b in zip(want, got) if a != b] \
        == ANALYZER_TWIN[rel]
