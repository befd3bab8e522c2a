"""Read the correctness numbers of a cell on many seeds, for the program
and for the control, to set the cell's limits (run on the card; the
benchmark's own runs never run this):

  python3 coebench/control.py --workload <cell> --seeds 11,12,13 \\
      --control-seeds 3 --seconds 5

For each seed, in one process: the cell's set-up from that seed (weights,
drawn anew into the page-locked host buffers of the first seed; system,
profile, warm round), a window of ``--seconds`` at the cell's own load, then
the comparison of the compared rows with the reference, and for the first
``--control-seeds`` seeds the control's numbers on the same rows: the
reference with every matrix weight in float8 e4m3 (one scale per output
channel) standing in for the program, judged by the cell's limits as a run
judges the program. One JSON line a seed, then a summary: the program's
largest reading and the control's smallest of each number.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def read_seed(cfg, mix, limits, seed, seconds, control, device,
              buffers=None):
    """One seed's line; returns (line, the page-locked host buffers, which
    the next seed refills). ``correct`` and ``control_correct`` are
    ``correct.passed`` of the program's checks and of the same checks with
    the control's numbers in the program's place."""
    from coebench import cell, correct

    st = cell.Setup(cfg, mix, seed, device)
    st.port_cfg = cell.port_config(cfg)
    cell.make_weights(st, buffers)
    record = cell.drive(st, seconds, False)
    rows = correct.selected(record, seed)
    refs = correct.reference_rows(rows, st.host, cfg, device,
                                  control=control)
    faults = correct.chain_faults(record)
    prog = correct.numbers(rows, refs)
    out = {"seed": seed, "rows": len(rows),
           "attempted": record["attempted"], "chain_faults": faults,
           "max_batch": st.profile["max_batch"], "program": prog,
           "correct": correct.passed(correct.checks(
               {"chain_faults": faults, **prog}, limits))}
    if control:
        out["control"] = correct.numbers(rows, refs, "control")
        out["control_correct"] = correct.passed(correct.checks(
            {"chain_faults": faults, **out["control"]}, limits))
    buffers = st.buffers
    del st, record, rows, refs
    gc.collect()
    return out, buffers


def main(argv=None, *, device=None, overrides=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch

    from coebench import bench, weights

    spec = bench.Benchmark(ROOT)
    work = spec.workload(args.workload)
    overrides = overrides or {}
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cfg = overrides.get("config") or spec.config(work["config"])
    mix = overrides.get("mix") or bench.mix(work["traffic"])
    limits = overrides.get("limits") or bench.limits(cfg, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    lines, buffers = [], None
    for i, seed in enumerate(seeds):
        line, buffers = read_seed(cfg, mix, limits, seed, args.seconds,
                                  i < args.control_seeds, device, buffers)
        lines.append(line)
        print(json.dumps(line), flush=True)
    if device.type == "cuda":
        for buf in buffers:
            weights.unpin(buf)
    summary = {"workload": args.workload, "seeds": len(lines),
               "program_correct": sum(x["correct"] for x in lines),
               "control_correct": sum(x.get("control_correct", False)
                                      for x in lines)}
    for key in ("token_gap", "logit_rel_rms"):
        summary[key] = {
            "program_max": max(x["program"][key] for x in lines),
            "control_min": min((x["control"][key] for x in lines
                                if "control" in x), default=None)}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
