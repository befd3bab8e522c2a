"""The static analyzer's twin (``repro_torch.analysis``) on the port's
package, as ``tests/test_analysis.py`` holds the reference's on its own:
each of the five checks fires on a planted violation under a
``src/repro_torch`` path (the reference's fixture files, copied there) and
stays silent on the corrected twin, the port's tree is clean under
``--strict``, and the CLI's exit codes hold."""
import os
import shutil
import subprocess
import sys

import pytest

from repro_torch.analysis import CHECK_NAMES, module_name, run_checks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
FIX = os.path.join(ROOT, "tests", "fixtures", "analysis")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The reference's fixture trees under ``src/repro_torch`` paths."""
    root = tmp_path_factory.mktemp("analysis")
    out = {}
    for kind in ("bad", "good"):
        dst = root / kind / "src" / "repro_torch"
        shutil.copytree(os.path.join(FIX, kind, "src", "repro"), dst)
        out[kind] = str(dst)
    return out


def _checks_of(path, checks=CHECK_NAMES):
    return [v.check for v in run_checks([path], checks).violations]


def test_module_name_derivation():
    assert module_name("src/repro_torch/core/executor.py") \
        == "repro_torch.core.executor"
    assert module_name("src/repro_torch/memory/__init__.py") \
        == "repro_torch.memory"
    # the reference's tree and files outside a package are unscoped here
    assert module_name("src/repro/core/executor.py") == ""
    assert module_name("benchmarks/run.py") == ""


# (file under the fixture tree, the checks its planted violations fire)
PLANTED = [
    ("core/wallclock_bad.py", ["wallclock", "wallclock", "wallclock"]),
    ("core/setiter_bad.py", ["wallclock", "wallclock"]),
    ("memory/residency.py", ["epoch"]),
    ("memory/epoch_bad.py", ["epoch", "epoch"]),
    ("core/tracer_bad.py", ["tracer", "tracer"]),
    ("api/frozenspec_bad.py", ["frozenspec", "frozenspec"]),
    ("memory/nodoc_bad.py", ["docstring"]),
]


@pytest.mark.parametrize("rel,want", PLANTED,
                         ids=[rel for rel, _ in PLANTED])
def test_planted_violation_fires_and_twin_passes(trees, rel, want):
    assert sorted(_checks_of(os.path.join(trees["bad"], rel))) == want
    twin = rel.replace("_bad", "_good")
    assert _checks_of(os.path.join(trees["good"], twin)) == []


def test_every_check_fires_on_the_port_path(trees):
    fired = set(_checks_of(trees["bad"]))
    assert fired == set(CHECK_NAMES)


def test_port_tree_is_clean_and_strict():
    rep = run_checks([os.path.join(SRC, "repro_torch")])
    assert rep.violations == [], [v.render() for v in rep.violations]
    assert rep.warnings == [], [w.render() for w in rep.warnings]
    assert rep.ok(strict=True) and rep.files > 90


def test_cli_exit_codes(trees):
    env = dict(os.environ, PYTHONPATH=SRC)

    def cli(*argv):
        return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                               *argv], cwd=ROOT, env=env,
                              capture_output=True, text=True)

    tree = cli("--strict", "src/repro_torch")
    assert tree.returncode == 0, tree.stdout + tree.stderr
    assert "0 violation(s), 0 warning(s)" in tree.stdout
    bad = cli(os.path.dirname(os.path.dirname(trees["bad"])))
    assert bad.returncode == 1, bad.stdout
    good = cli(os.path.dirname(os.path.dirname(trees["good"])))
    assert good.returncode == 0, good.stdout
