"""Find a cell's parts by the names in ``BENCHMARK.json``: its
configuration file, its traffic mix (``mixes/<traffic>.json``), the readers
of its metrics (``metrics/<metric>.py``, each with ``read(record)``; a
metric split by cells, ``<base>.<part>``, reads with ``metrics/<base>.py``
unless it has a file of its own) and the limits of its correctness checks
(the configuration's ``limits``, with ``limits/<workload>.json`` over them
where a cell has one)."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Benchmark:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def metrics(self, kind: str, workload: str) -> list:
        """The metrics of ``kind`` ("end_to_end" or "per_layer") that
        ``workload`` reports."""
        return [m for m in self.spec[kind]
                if workload in m.get("workloads", [workload])]


def mix(name: str) -> dict:
    return json.loads((HERE / "mixes" / f"{name}.json").read_text())


def limits(cfg: dict, workload: str) -> dict:
    out = dict(cfg["limits"])
    own = HERE / "limits" / f"{workload}.json"
    if own.exists():
        out.update(json.loads(own.read_text()))
    return out


def reader(metric: str):
    """``read(record)`` of ``metrics/<metric>.py``, or, for a metric split
    by cells (``<base>.<part>``), of ``metrics/<base>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"coebench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
