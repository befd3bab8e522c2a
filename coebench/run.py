"""Run one cell of the benchmark of the PyTorch/CUDA port once, on the card
of the machine it is started on:

  python3 coebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration file and a traffic mix
(``coebench/mixes/<traffic>.json``). Set-up makes every expert's weights
from the seed, builds the program's CoE system, profiles it and runs one
warm round; the window then runs closed-loop rounds for ``--seconds``; once
it has closed, the compared rows are checked against the plain reference.
With ``--trace 1`` the window runs under ``torch.profiler`` and the cell's
per-layer metrics are reported instead of its end-to-end ones. The last line
of standard output is the result, one JSON object; the lines before it give
the host, the profile and the window's counts. No card (or fewer than the
cell asks for): exit 2 and no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the benchmark's modules are imported as ``coebench.*``, never as top-level
# names from the script's own directory
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def host_facts() -> dict:
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith(("MemAvailable:", "MemTotal:")):
                    key, kb = line.split()[:2]
                    out[key[:-1] + "_GB"] = int(kb) * 1024 / 1e9
    except OSError:
        pass
    if shutil.which("nvidia-smi"):
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        out["nvidia_smi"] = q.stdout.strip().splitlines()[:1]
    return out


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, *, device=None, overrides=None) -> int:
    """Run a cell; ``device`` (tests only) skips the look for a card and
    runs there, ``overrides`` (tests only) replaces the cell's
    ``config``, ``mix`` or ``limits``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from coebench import bench, cell, correct, devtrace, weights

    spec = bench.Benchmark(ROOT)
    work = spec.workload(args.workload)
    overrides = overrides or {}
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < work["chips"]:
            print(f"{args.workload} needs {work['chips']} CUDA device(s); "
                  f"this machine has {have}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cfg = overrides.get("config") or spec.config(work["config"])
    mix = overrides.get("mix") or bench.mix(work["traffic"])
    limits = overrides.get("limits") or bench.limits(cfg, args.workload)
    print(json.dumps({"host": host_facts(), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    st = cell.Setup(cfg, mix, args.seed, device)
    st.port_cfg = cell.port_config(cfg)
    t_weights = time.perf_counter()
    cell.make_weights(st)
    t_weights = time.perf_counter() - t_weights
    record = cell.drive(st, args.seconds, bool(args.trace), devtrace.profiler)
    record["setup_s"] = record["window_start"] - T_START
    if record["traced"]:
        record["trace"] = devtrace.reduce(record.pop("profiler"),
                                          record["spans"])
    print(json.dumps({
        "profile": st.profile, "expert_bytes": st.expert_bytes,
        "rounds": record["rounds"], "window_s": record["window_s"],
        "loads": record["after"]["switches"] - record["before"]["switches"],
        "bytes_loaded": (record["after"]["switches"]
                         - record["before"]["switches"]) * st.expert_bytes,
        "forwards": len(record["forwards"]),
        "trace": ({k: record["trace"][k] for k in ("busy_s", "window_s",
                                                   "outside",
                                                   "first_kernel_s")}
                  if record["traced"] else None),
        "setup_clock": {"weights_s": t_weights, **record["clock"]}}),
        flush=True)

    t_judge = time.perf_counter()
    verdict = correct.judge(record, st.host, limits, args.seed, device)
    t_judge = time.perf_counter() - t_judge
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics(kind, args.workload):
        value = bench.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": work["chips"],
           "memory_peak_bytes": record["memory_peak_bytes"]}
    result = {"correct": correct.passed(verdict["checks"]),
              "attempted": record["attempted"],
              "failed": record["attempted"] - record["completed"],
              "metrics": metrics, "device": dev}
    if record["traced"]:
        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = devtrace.breakdown(record["trace"])
    result["checks"] = verdict["checks"]

    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the port may import neither JAX nor "
              "the JAX package", file=sys.stderr)
        return 3
    print(f"compared rows: {verdict['rows']} in {t_judge:.1f} s; "
          f"{time.perf_counter() - T_START:.1f} s since the start",
          file=sys.stderr)
    for name, c in verdict["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    if device.type == "cuda":     # unlocking first halves the exit's time
        for buf in st.buffers:
            weights.unpin(buf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
