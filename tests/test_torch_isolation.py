"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its copies of the pure-Python control plane, of the model configs and
of the static analyzer's checks and CLI are the reference's sources with
only the package name changed (the control plane's copies that carry the
port's wall clock: the reference's lines but those listed, in order, and
lines of their own)."""
import ast
import difflib
import hashlib
import json
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


# copies the port has grown past the reference: its flight recorder's wall
# clock (the recorder, the spans the simulator, the scheduler's assign and
# the executor record, the wall-clock timeline and export; the recorder also
# reads a forward's MoE counters with its device time), and the model
# config's switches for Jamba2-Mini (held experts, the dropless layer, the
# top-k weights as they are, attention without RoPE, the mixer's dt, B and
# C norms), whose parameter count counts the held experts. Each keeps every
# line of the reference renamed, in order, but the lines listed here, which
# it changed; ``GROWN_DELTA`` pins every line it changed, deleted or added
# (the sha256 of ``_delta``), so that a later edit of such a copy fails
# until its new digest is written here.
GROWN = {
    "obs/tracer.py": [
        "    runs of the same seeded spec produce identical event streams.",
        "from typing import Any, Dict, List",
        '               "admit", "shed", "scale", "decode", "kv")',
        '        return {"t": self.t, "kind": self.kind, "actor": self.actor,',
        '                "name": self.name, "dur": self.dur, '
        '"attrs": self.attrs}',
        '                   attrs=dict(d.get("attrs", {})))',
        '    """The ring-buffer recorder. ``enabled``/``full`` are plain '
        'booleans so',
        '    disabled call sites cost one attribute read and nothing else."""',
        "                 capacity: int = DEFAULT_CAPACITY):",
        "             dur: float = 0.0, **attrs):"],
    "obs/timeline.py": [
        "def stage_records(events: Iterable[Event]) -> List[Stage]:",
        '    """Join assign / exec / demand-load events into per-stage '
        'records."""'],
    "obs/export.py": [
        '    """Render events as a Chrome trace-event JSON object."""'],
    "core/simulator.py": [],
    "core/serving.py": [],
    "core/executor.py": [
        '            tracer.emit(now, "load", self.id, expert_id, dur=lat,',
        '            self.tracer.emit(now, "exec", self.id, eid, dur=lat,'],
    "models/config.py": [
        "                e = self.moe_top_k if active_only else "
        "self.moe_num_experts"],
}
GROWN_DELTA = {
    "obs/tracer.py":
        "22126ccba2ce2aad0eaa424bc41da5abcb963d935090e05da25d9a229d5b7a14",
    "obs/timeline.py":
        "f83ca25e68a1555c4529cff6251ce6d90497dfa6795a6702139fb8bb7ddc3500",
    "obs/export.py":
        "967ffd984ac1efa1f91bf596c51438765f77965c4f7ecfff83cbb5272f686231",
    "core/simulator.py":
        "b4b7c5b7a95622dc464b599707e61f5ee02834e8879bb6e17effce208171bd74",
    "core/serving.py":
        "c21c91af1565edbb1c566a0ae669712e265f29d790d375cf520f7dbba3d9381e",
    "core/executor.py":
        "dc1bdef6a3c2504255c1bcae29934e9314179acaa515dbc3bd93f45a3d14598a",
    "models/config.py":
        "873ab98b76e99a154e50101ba6b9eb12f55ce5d7d34b8fe7697f43881fad97fa",
}


def _delta(want, got):
    """The opcodes by which a grown copy's lines differ from the
    reference's, each with the lines on both sides."""
    ops = difflib.SequenceMatcher(None, want, got,
                                  autojunk=False).get_opcodes()
    return [(tag, want[i1:i2], got[j1:j2])
            for tag, i1, i2, j1, j2 in ops if tag != "equal"]


@pytest.mark.parametrize("rel", VERBATIM)
def test_control_plane_copy_is_the_reference_renamed(rel):
    with open(os.path.join(REF, rel), encoding="utf-8") as f:
        want = re.sub(r"\brepro\.", "repro_torch.", f.read())
    with open(os.path.join(PORT, rel), encoding="utf-8") as f:
        got = f.read()
    if rel not in GROWN:
        assert got == want
        return
    delta = _delta(want.split("\n"), got.split("\n"))
    changed = [line for tag, old, _ in delta if tag != "insert"
               for line in old]
    assert changed == GROWN[rel]
    text = json.dumps(delta, indent=1)
    assert hashlib.sha256(text.encode()).hexdigest() == GROWN_DELTA[rel], \
        f"{rel} differs from the reference by other lines than pinned:\n" \
        + text


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
