"""End-to-end training example: a ~100M-parameter dense LM (starcoder2-family
reduction) for a few hundred steps with fault-tolerant checkpointing. The
loss falls on the synthetic Markov-chain corpus. The twin of the JAX
package's ``examples/train_100m.py``, with the same two runs.

  PYTHONPATH=src python -m repro_torch.launch.train_100m            # ~300 steps
  PYTHONPATH=src python -m repro_torch.launch.train_100m --fast     # 20M model, 60 steps

Restart behaviour: re-running the same command resumes from the newest
committed checkpoint (kill it mid-run to see the fault-tolerance path).
``--device`` is passed on to ``repro_torch.launch.train`` (``cuda`` by
default).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.fast:
        train_argv = ["--preset", "20m", "--steps", "60", "--batch", "8",
                      "--seq", "128", "--ckpt-dir", args.ckpt_dir,
                      "--ckpt-every", "20", "--log-every", "10", "--resume"]
    else:
        train_argv = ["--preset", "100m", "--steps", "300", "--batch", "8",
                      "--seq", "256", "--ckpt-dir", args.ckpt_dir,
                      "--ckpt-every", "50", "--log-every", "10", "--resume"]

    history = train_main(train_argv + ["--device", args.device])
    ok = len(history) >= 2 and history[-1]["loss"] < history[0]["loss"]
    if ok:
        print("OK: loss decreased")
    else:
        print("WARNING: loss did not decrease", file=sys.stderr)
    return history, ok


if __name__ == "__main__":
    main()
