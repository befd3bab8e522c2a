"""Smoke-width stand-ins for the benchmark's configurations and mixes, for
the CPU tests: every width and the count of domains cut, the structure and
the code path kept."""
import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

WIDTHS_DIR = HERE / "tests" / "widths"


def widths(model_type: str) -> dict:
    """A family's sizes for the CPU tests, from the file the family adds
    (``tests/widths/<model_type>.json``): ``published`` and ``port`` hold
    the smoke widths over the configuration's published keys and over its
    ``port.overrides``, and ``control_crosses_limits`` (optional) the
    checks whose configured limit the control crosses and the program does
    not at smoke widths."""
    path = WIDTHS_DIR / f"{model_type}.json"
    if not path.exists():
        raise FileNotFoundError(
            f"no smoke widths for model_type {model_type!r}: the family "
            f"adds {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def params(cfg: dict, seed: int = 0) -> dict:
    """An expert's weights of ``cfg`` drawn on the CPU, in float32."""
    import torch

    from coebench import reference, weights

    layout = reference.family(cfg["model_type"]).layout(cfg)
    named, _, _ = weights.make_expert(layout, seed, torch.device("cpu"))
    return {k: v.float() for k, v in named.items()}


def config(name: str) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    sizes = widths(cfg["model_type"])
    cfg = copy.deepcopy(cfg)
    cfg.update(sizes["published"])
    cfg["port"]["overrides"].update(sizes["port"])
    # six domains, three experts in the pool: the structure kept, the
    # host's work cut
    cfg["coe"].update(domains=cfg["coe"]["domains"][:6], pool_experts=3)
    return cfg


def mix(name: str) -> dict:
    m = json.loads((HERE / "mixes" / f"{name}.json").read_text())
    m.update({"round_size": 12, "prompt_tokens": 16, "check_fraction": 0.5,
              "check_requests": 4})
    return m


def run_cell(workload: str, seed: int, seconds: float, trace: int = 0,
             timeout: float = 120.0, root: Path = ROOT):
    """``run.py``'s main for ``workload`` at smoke widths on the CPU, in a
    process of its own (the benchmark refuses to print a result in a
    process that holds JAX, which the repository's test suite loads), from
    the checkout at ``root``; returns (exit code, stdout lines, stderr)."""
    import subprocess
    import sys

    config, traffic = workload.split(".")
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(root)!r}, {str(root / 'src')!r}]\n"
        "from coebench import run\n"
        "from coebench.tests import smoke\n"
        f"sys.exit(run.main(['--workload', {workload!r}, '--seed', "
        f"'{seed}', '--seconds', '{seconds}', '--trace', '{trace}'], "
        f"device='cpu', overrides={{'config': smoke.config({config!r}), "
        f"'mix': smoke.mix({traffic!r})}}))\n")
    env = {k: v for k, v in __import__("os").environ.items()
           if k not in ("PYTHONPATH",)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, cwd=str(root), env=env)
    return proc.returncode, proc.stdout.splitlines(), proc.stderr
