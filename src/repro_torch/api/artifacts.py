"""Run artifacts: workload traces and placement plans as JSON files.

Source of truth: the only file format for ``WorkloadTrace`` and
``PlacementPlan`` persistence (the objects own their ``to_dict`` /
``from_dict``; this module owns the envelope and the io). Closing ROADMAP
"Trace capture end-to-end": a serving run dumps the traffic it observed
(``Session.save_trace`` / ``serve --dump-trace``), the placement search
replays that file tomorrow (``fleet.trace_path``), and the searched plan
itself is saved (``Session.save_plan`` / ``serve --save-plan``) and applied
verbatim on the next launch (``fleet.placement="plan"``) — no re-search, no
re-derivation from static priors.

Every artifact is a small JSON envelope ``{"kind": ..., "version": 1,
"payload": {...}}`` so loading the wrong file kind fails with a message
instead of a KeyError.
"""
from __future__ import annotations

import json
from typing import TYPE_CHECKING, Mapping, Optional

from repro_torch.fleet import PlacementPlan, WorkloadTrace

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.coe import CoEModel

TRACE_KIND = "coserve.workload_trace"
PLAN_KIND = "coserve.placement_plan"
ARTIFACT_VERSION = 1


def _dump(kind: str, payload: dict, path: str):
    with open(path, "w") as f:
        json.dump({"kind": kind, "version": ARTIFACT_VERSION,
                   "payload": payload}, f, indent=2, sort_keys=True)
        f.write("\n")


def _read(kind: str, path: str) -> dict:
    try:
        with open(path) as f:
            d = json.load(f)
    except OSError as e:
        what = "trace" if kind == TRACE_KIND else "plan"
        raise ValueError(
            f"cannot read {what} artifact {path}: {e.strerror or e} — "
            f"{what}s are written by "
            f"{'save_trace/--dump-trace' if kind == TRACE_KIND else 'save_plan/--save-plan'}"
        ) from None
    except json.JSONDecodeError as e:
        raise ValueError(f"{path} is not valid JSON: {e}") from None
    got = d.get("kind") if isinstance(d, dict) else None
    if got != kind:
        raise ValueError(
            f"{path} is not a {kind!r} artifact (found kind={got!r}) — "
            "traces come from save_trace/--dump-trace, plans from "
            "save_plan/--save-plan")
    if d.get("version") != ARTIFACT_VERSION:
        raise ValueError(
            f"{path}: artifact schema v{d.get('version')!r}, this build "
            f"reads v{ARTIFACT_VERSION}")
    return d["payload"]


# --------------------------------------------------------------------------- #
def save_trace(trace: WorkloadTrace, path: str):
    """Persist a workload trace (observed traffic or expected chains)."""
    _dump(TRACE_KIND, trace.to_dict(), path)


def load_trace(path: str) -> WorkloadTrace:
    return WorkloadTrace.from_dict(_read(TRACE_KIND, path))


def save_plan(plan: PlacementPlan, path: str):
    """Persist a placement plan (searched or greedy) with its pool shape."""
    _dump(PLAN_KIND, plan.to_dict(), path)


def load_plan(path: str, coe: "CoEModel",
              capacities: Optional[Mapping[str, int]] = None
              ) -> PlacementPlan:
    """Rebuild a saved plan against ``coe``; when ``capacities`` is given
    (the pools of the fleet about to apply it), a shape mismatch fails with
    a re-search hint instead of silently misplacing experts."""
    try:
        return PlacementPlan.from_dict(coe, _read(PLAN_KIND, path),
                                       capacities=capacities)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
