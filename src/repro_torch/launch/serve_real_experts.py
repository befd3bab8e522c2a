"""Real-backend serving example: actual PyTorch expert parameters move
across disk -> host -> device tiers and batched forwards execute, driven by
the same dependency-aware scheduler the simulator uses. The twin of the JAX
package's ``examples/serve_real_experts.py``: 16 components, 3 detection
experts, a pool of 5 experts on the device, 150 requests, under COSERVE and
then SAMBA_PARALLEL.

  PYTHONPATH=src python -m repro_torch.launch.serve_real_experts             # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve_real_experts --device cpu
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np

from repro_torch.api.build import build_real_system
from repro_torch.core import COSERVE, SAMBA_PARALLEL, Request, run_real

N_COMPONENTS, N_REQS = 16, 150


def make_requests():
    needs_det = np.random.RandomState(0).rand(N_COMPONENTS) < 0.5
    det_assign = np.random.RandomState(0).randint(0, 3, N_COMPONENTS)
    local = np.random.RandomState(7)
    out = []
    for i in range(N_REQS):
        c = int(local.randint(N_COMPONENTS))
        out.append(Request(
            id=i, expert_id=f"cls{c:03d}",
            data={"component": c, "x": local.randn(64).astype(np.float32),
                  "needs_detection": bool(needs_det[c]),
                  "det_expert": int(det_assign[c])}))
    return out


def main(argv=None):
    """Serve the requests under each policy; returns {policy name:
    Metrics}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the CUDA card (default; no card is an error) or "
                         "the host CPU")
    args = ap.parse_args(argv)
    results = {}
    for policy in (COSERVE, SAMBA_PARALLEL):
        with tempfile.TemporaryDirectory(prefix="coserve_") as store:
            system, coe = build_real_system(
                n_components=N_COMPONENTS, n_detection=3, pool_experts=5,
                n_executors=2, policy=policy, store_root=store,
                device=args.device)
            m = run_real(system, make_requests())
        print(f"{policy.name:20s}: {m.completed} requests | "
              f"{m.throughput:8.0f} req/s (wall) | {m.switches:3d} real "
              f"device loads | makespan {m.makespan * 1e3:.0f} ms")
        results[policy.name] = m
    return results


if __name__ == "__main__":
    main()
