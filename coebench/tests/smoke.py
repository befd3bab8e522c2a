"""Smoke-width stand-ins for the benchmark's configurations and mixes, for
the CPU tests: every width and the count of domains cut, the structure and
the code path kept."""
import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

WIDTHS = {
    "starcoder2": ({"hidden_size": 64, "intermediate_size": 128,
                    "num_attention_heads": 4, "num_key_value_heads": 2,
                    "num_hidden_layers": 2, "vocab_size": 512},
                   {"d_model": 64, "d_ff": 128, "num_heads": 4,
                    "num_kv_heads": 2, "head_dim": 16, "num_layers": 2,
                    "vocab_size": 512}),
    "falcon_mamba": ({"hidden_size": 64, "intermediate_size": 128,
                      "time_step_rank": 4, "num_hidden_layers": 2,
                      "vocab_size": 512},
                     {"d_model": 64, "num_layers": 2, "vocab_size": 512}),
}


def config(name: str) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    published, port = WIDTHS[cfg["model_type"]]
    cfg = copy.deepcopy(cfg)
    cfg.update(published)
    cfg["port"]["overrides"].update(port)
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
             timeout: float = 120.0):
    """``run.py``'s main for ``workload`` at smoke widths on the CPU, in a
    process of its own (the benchmark refuses to print a result in a
    process that holds JAX, which the repository's test suite loads);
    returns (exit code, stdout lines, stderr)."""
    import subprocess
    import sys

    config, traffic = workload.split(".")
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from coebench import run\n"
        "from coebench.tests import smoke\n"
        f"sys.exit(run.main(['--workload', {workload!r}, '--seed', "
        f"'{seed}', '--seconds', '{seconds}', '--trace', '{trace}'], "
        f"device='cpu', overrides={{'config': smoke.config({config!r}), "
        f"'mix': smoke.mix({traffic!r})}}))\n")
    env = {k: v for k, v in __import__("os").environ.items()
           if k not in ("PYTHONPATH",)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, cwd=str(ROOT), env=env)
    return proc.returncode, proc.stdout.splitlines(), proc.stderr
