"""The comparison that decides ``correct``.

Two layers are held to account:

- the control plane: every request submitted in the window completes, and
  its chain ran exactly its domain's expert, then the safety expert, each
  once (``chain_faults``, exact);
- the model step through the kernels: for a sample of the window's
  requests drawn from the seed (both stages of each), the last-position
  logits that the timed path served, from its padded batches, against the
  plain float32 reference over the same prompt with the weights of the
  expert the routing names: ``token_gap``, the widest gap by which the
  served token's reference logit lies below the reference's best, and
  ``logit_rel_rms``, the largest row's RMS error over the reference row's
  RMS.

The reference runs on the device one expert at a time, with TF32 off, from
the host weights the benchmark made. The control puts the reference in the
program's place at the next precision below the served bfloat16: the same
forward with every matrix weight rounded to float8 e4m3 with a scale per
output channel.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from coebench import reference, traffic
from coebench.cell import expected_chain

CHECKS = ("chain_faults", "token_gap", "logit_rel_rms")
ROWS_A_CALL = 8      # the reference's rows a forward: a 1024-token
#                      StarCoder2 attention then holds 0.8 GB of scores


def chain_faults(record: dict) -> int:
    """Window requests that did not complete, or whose stages were not
    their domain's expert then the safety expert, once each."""
    bad = 0
    for rid, domain in record["domains"].items():
        if rid not in record["done"] \
                or record["stages"].get(rid) != expected_chain(domain):
            bad += 1
    return bad


def selected(record: dict, seed: int) -> List[dict]:
    """The compared rows: both stages of ``check_requests`` of the marked
    requests that completed, drawn from the seed."""
    by_root: Dict[int, List[dict]] = {}
    for smp in record["samples"]:
        by_root.setdefault(smp["root"], []).append(smp)
    whole = [r for r, rows in by_root.items()
             if len(rows) == 2 and r in record["done"]]
    roots = traffic.pick(whole, record["mix"]["check_requests"], seed)
    return [smp for r in roots for smp in by_root[r]]


def fp8_weights(params: dict, layout) -> dict:
    """The control's weights: each ``dense`` weight rounded to float8 e4m3
    with one scale per output channel (its last dim; a table's rows, the
    embedding's and the head's), back in float32."""
    out = dict(params)
    for name, _, _, init, _ in layout:
        if init != "dense":
            continue
        w = params[name]
        dim = -1 if name.endswith(".table") else -2
        scale = w.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
        out[name] = (w / scale).to(torch.float8_e4m3fn).float() * scale
    return out


def _row_numbers(cand: np.ndarray, ref: np.ndarray) -> tuple:
    if not np.all(np.isfinite(cand)):
        return math.inf, math.inf
    gap = float(ref.max() - ref[int(cand.argmax())])
    rel = float(np.sqrt(np.mean((cand.astype(np.float64) - ref) ** 2))
                / np.sqrt(np.mean(ref.astype(np.float64) ** 2)))
    return gap, rel


def reference_rows(rows: List[dict], host: dict, cfg: dict,
                   device: torch.device, control: bool = False
                   ) -> List[dict]:
    """Per compared row: the reference's logits and, with ``control``, the
    control's (float64 numpy), expert by expert."""
    fam = reference.family(cfg["model_type"])
    layout = fam.layout(cfg)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: List[Optional[dict]] = [None] * len(rows)
    try:
        for eid in sorted({_expert(r) for r in rows}):
            params = {k: v.to(device).float() for k, v in host[eid].items()}
            sides = [("ref", params)]
            if control:
                sides.append(("control", fp8_weights(params, layout)))
            idx = [i for i, r in enumerate(rows) if _expert(r) == eid]
            for i in idx:
                out[i] = {}
            for side, p in sides:
                for c in range(0, len(idx), ROWS_A_CALL):
                    part = idx[c:c + ROWS_A_CALL]
                    x = torch.from_numpy(np.stack(
                        [rows[i]["tokens"] for i in part])).long().to(device)
                    with torch.no_grad():
                        logits = fam.forward(p, x, cfg).double().cpu().numpy()
                    for i, row in zip(part, logits):
                        out[i][side] = row
            del params, sides, p
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
    return out


def _expert(row: dict) -> str:
    """The expert the routing names for this stage: its domain's, then the
    safety expert."""
    chain = expected_chain(row["domain"])
    return chain[min(row["stage"], len(chain) - 1)]


def numbers(rows: List[dict], refs: List[dict],
            side: Optional[str] = None) -> dict:
    """``token_gap`` and ``logit_rel_rms`` of the served logits (``side``
    None) or of a reference side standing in for them."""
    if not rows:                       # nothing compared is no pass
        return {"token_gap": math.inf, "logit_rel_rms": math.inf}
    gap = rel = 0.0
    for row, ref in zip(rows, refs):
        cand = row["logits"] if side is None else ref[side]
        g, r = _row_numbers(np.asarray(cand, np.float64), ref["ref"])
        gap, rel = max(gap, g), max(rel, r)
    return {"token_gap": gap, "logit_rel_rms": rel}


def judge(record: dict, host: dict, limits: dict, seed: int,
          device: torch.device) -> dict:
    """The checks, each with its value and limit."""
    rows = selected(record, seed)
    refs = reference_rows(rows, host, record["cfg"], device)
    values = {"chain_faults": chain_faults(record), **numbers(rows, refs)}
    return {"rows": len(rows), "checks": checks(values, limits)}


def checks(values: dict, limits: dict) -> dict:
    """Each check's value beside its limit."""
    return {k: {"value": values[k], "limit": limits[k]} for k in CHECKS}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
