"""The port's flight recorder on the wall clock (``Tracer(..., wall=True)``),
on the CPU: the span tree a real-engine run records, the wall-clock
timeline, the span analyses, the export, and that a recorder left off (or
on sim time) records what it did before, as the JAX package's does."""
import collections
import threading

import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro_torch.core.simulator import run_real
from repro_torch.launch import lm_coe_router as lm
from repro_torch.models import transformer
from repro_torch.obs import NULL_TRACER, Event, Tracer
from repro_torch.obs import tracer as obs_tracer
from repro_torch.obs.export import chrome_trace, validate_chrome_trace
from repro_torch.obs.timeline import (idle_by_span, self_times,
                                      stage_records)

# the host spans of one execution, under its ``exec``
EXEC_CHILDREN = ["batch", "apply", "fetch_out", "interpret"]


def _lm_run(tracer, requests=24, seed=0):
    """The LM CoE at smoke width on the CPU, served through ``run_real``;
    returns (system, requests served)."""
    cfg = lm.lm_config("smoke", 0, "starcoder2_3b")
    system, _ = lm.build_lm_system(cfg, device="cpu", tracer=tracer)
    reqs = lm.make_requests(np.random.RandomState(seed), cfg, requests)
    m = run_real(system, reqs)
    assert m.completed == requests
    return system, reqs


@pytest.fixture(scope="module")
def wall_run():
    tracer = Tracer("full", wall=True)
    system, reqs = _lm_run(tracer)
    return tracer, system, reqs


def _children(events):
    out = collections.defaultdict(list)
    for e in events:
        out[e.parent].append(e)
    return out


def test_spans_nest_inside_their_parents_and_carry_the_batch(wall_run):
    tracer, _, reqs = wall_run
    events = list(tracer.events)
    assert all(e.wall_ns is not None and e.id for e in events)
    assert len({e.id for e in events}) == len(events)
    by_id = {e.id: e for e in events}
    for e in events:
        if e.parent is None or e.name == "transfer":
            continue                  # a transfer runs on its own thread
        up = by_id[e.parent]
        assert up.wall_ns <= e.wall_ns and e.wall_end_ns <= up.wall_end_ns
    served = collections.Counter()
    kids = _children(events)
    for ex in (e for e in events if e.kind == "exec"):
        batch = [c for c in kids[ex.id] if c.name == "batch"]
        assert batch[0].attrs["rows"] == ex.attrs["n"] \
            == len(ex.attrs["requests"]) == ex.attrs["rows"]
        assert batch[0].attrs["padded"] == ex.attrs["padded"]
        served.update(ex.attrs["requests"])
    # each request ran its domain stage; the safety stage is a follow-up
    assert {r.id for r in reqs} <= set(served)


def test_a_traced_run_yields_the_whole_tree_for_every_batch(wall_run):
    tracer, system, _ = wall_run
    events = list(tracer.events)
    kids = _children(events)
    runs = [e for e in events if e.kind == "host" and e.name == "run"]
    assert len(runs) == 1 and runs[0].parent is None
    root = runs[0].id
    execs = [e for e in events if e.kind == "exec"]
    assert execs and sum(e.attrs["n"] for e in execs) == \
        sum(x.stats.completed for x in system.executors)
    for ex in execs:
        assert ex.parent == root and ex.dur > 0 and ex.wall_dur_ns > 0
        assert [c.name for c in kids[ex.id]] == EXEC_CHILDREN
        apply = kids[ex.id][1]
        (fwd,) = kids[apply.id]
        assert fwd.name == "forward" and fwd.actor == "model"
        assert fwd.attrs["tokens"] == (ex.attrs["rows"] + ex.attrs["padded"]) \
            * kids[ex.id][0].attrs["seq"]
        assert "device_us" not in fwd.attrs          # no card, no events
    loads = {e.id: e for e in events if e.kind == "load"}
    assert loads and all(e.parent == root for e in loads.values())
    assert len(loads) == sum(x.stats.switches for x in system.executors)
    transfers = [e for e in events if e.name == "transfer"]
    waits = [e for e in events if e.name == "load_wait"]
    assert sorted(e.parent for e in transfers) == sorted(loads)
    assert {e.attrs["load"] for e in waits} <= set(loads)
    assert all(e.attrs["bytes"] > 0 for e in transfers)
    for kind in ("assign", "load"):
        assert all(e.parent == root for e in events if e.kind == kind)
    for name in ("evict_decide", "load_wait", "complete"):
        assert all(e.parent == root for e in events if e.name == name)
    done = [e for e in events if e.name == "complete"]
    assert len(done) == sum(len(e.attrs["requests"]) for e in execs)
    assert runs[0].attrs["events"] > 0
    # rows and padding as ``bucket_pad`` made them: a power of two in all
    for ex in execs:
        rows = ex.attrs["rows"] + ex.attrs["padded"]
        assert rows & (rows - 1) == 0 and ex.attrs["padded"] < ex.attrs["rows"]
    assert all(isinstance(e.attrs["landed"], bool) for e in waits)
    # the scheduler's instants are held by their ``assign``: stamped at its
    # start, recorded at its close
    assigns = {e.id: e for e in events if e.kind == "assign"}
    sched = [e for e in events if e.kind == "sched"]
    assert sched and all(e.parent in assigns for e in sched)
    assert all(e.wall_ns == assigns[e.parent].wall_ns for e in sched)


def test_wall_stage_records_sum_exactly(wall_run):
    tracer, _, _ = wall_run
    stages = stage_records(tracer.events, clock="wall")
    assert len(stages) == sum(len(e.attrs["requests"])
                              for e in tracer.events if e.kind == "exec")
    for s in stages:
        for part in (s.queue_wait, s.switch_load_wait, s.peer_copy_wait,
                     s.exec):
            assert float(part).is_integer()              # nanoseconds
        assert all(isinstance(t, int) for t in (s.arrival, s.start, s.end))
        assert s.queue_wait >= 0 and s.exec > 0
        assert s.queue_wait + s.switch_load_wait + s.peer_copy_wait \
            + s.exec == s.end - s.arrival
    assert any(s.switch_load_wait > 0 for s in stages)
    with pytest.raises(ValueError):
        stage_records(tracer.events, clock="host")


def test_no_event_dropped_below_capacity(wall_run):
    tracer, _, _ = wall_run
    assert tracer.dropped == 0 and len(tracer.events) < tracer.capacity
    assert tracer.snapshot()["by_kind"]["host"] > 0


def test_drops_are_counted_when_threads_overflow_the_ring():
    import sys

    tracer = Tracer("full", capacity=500, wall=True)

    def spans():
        for _ in range(400):
            with tracer.span("host", threading.current_thread().name, "x"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=spans) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(tracer.events) == 500
    assert tracer.dropped == 12 * 400 - 500
    assert all(e.parent is None for e in tracer.events)   # own stacks


def test_an_untraced_real_engine_run_creates_no_event(monkeypatch):
    """The tiny experts of ``test_torch_engine.py``, served on the CPU with
    no tracer: no event, span or device-time pair is made."""
    def refuse(*a, **kw):
        raise AssertionError("an untraced run recorded")

    for name in ("emit", "open", "close", "span", "defer"):
        monkeypatch.setattr(Tracer, name, refuse)
    monkeypatch.setattr(obs_tracer, "Event", refuse)
    spec = tapi.DeploymentSpec(
        model=tapi.ModelSpec(kind="tiny"),
        serving=tapi.ServingSection(mode="real"),
        workload=tapi.WorkloadSection(requests=20))
    sess = tapi.Session(spec, device="cpu")
    out = sess.run()
    assert out["completed"] == 20
    assert sess.system.tracer is NULL_TRACER and not NULL_TRACER.events
    assert type(sess.system.engine).__name__ == "RealEngine"


def test_forward_records_only_inside_an_activated_wall_tracer():
    cfg = lm.lm_config("smoke", 0, "starcoder2_3b")
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros((2, 8), dtype=torch.int32)
    summary = Tracer("full")
    wall = Tracer("full", wall=True)
    with torch.no_grad():
        want, _ = transformer.forward(params, x, cfg)
        with obs_tracer.activated(summary):
            transformer.forward(params, x, cfg)
        with obs_tracer.activated(wall):
            got, _ = transformer.forward(params, x, cfg)
    assert obs_tracer.active() is NULL_TRACER
    assert not summary.events
    (fwd,) = wall.events
    # on the CPU the kernels' entry points run their plain versions, which
    # count no launch
    assert (fwd.kind, fwd.name, fwd.attrs) == (
        "host", "forward", {"tokens": 16, "norm_launches": 0,
                            "rope_launches": 0, "moe_launches": 0})
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _spec(mod):
    board = mod.BoardSection(name="OBS", n_components=40, n_active=24,
                             avg_quantity=2.0, n_detection=6, zipf_s=1.4)
    return mod.DeploymentSpec(
        model=mod.ModelSpec(kind="board", board="OBS", boards=(board,)),
        fleet=mod.FleetSection(gpu_per_device=2, cpu=1),
        serving=mod.ServingSection(mode="sim"),
        workload=mod.WorkloadSection(requests=250),
        observability=mod.ObservabilitySection(trace="full"))


def test_sim_event_stream_equals_the_reference_recorder():
    """With the wall clock off, a seeded sim run records the JAX package's
    event stream, key for key and value for value."""
    want, got = japi.Session(_spec(japi)), tapi.Session(_spec(tapi))
    want.run()
    got.run()
    dicts = got.system.tracer.to_dicts()
    assert dicts and dicts == want.system.tracer.to_dicts()
    assert all(list(d) == ["t", "kind", "actor", "name", "dur", "attrs"]
               for d in dicts)


def test_event_dict_round_trip_keeps_the_wall_fields():
    e = Event(1.5, "exec", "gpu0", "e1", 0.25, {"n": 2}, wall_ns=10,
              wall_dur_ns=5, id=3, parent=1)
    d = e.to_dict()
    assert d["wall_ns"] == 10 and d["parent"] == 1
    assert Event.from_dict(d) == e
    assert list(Event(0.0, "load", "a", "b").to_dict()) == \
        ["t", "kind", "actor", "name", "dur", "attrs"]
    for level in ("off", "summary"):
        with pytest.raises(ValueError):
            Tracer(level, wall=True)


def test_instants_inside_a_hold_span_wait_for_its_close():
    tracer = Tracer("full", wall=True)
    tracer.emit(0.5, "sched", "scheduler", "a")          # no span open
    holder = tracer.open("assign", "scheduler", "e1", hold=True)
    tracer.emit(1.0, "sched", "scheduler", "e1", request=7)
    with tracer.span("host", "scheduler", "inner"):
        tracer.emit(1.0, "sched", "scheduler", "e1", mode="reorder")
    assert [e.name for e in tracer.events] == ["a", "inner"]
    tracer.close(holder)
    tracer.emit(2.0, "sched", "scheduler", "b")
    first, inner, held1, held2, closed, after = tracer.events
    assert closed is holder and inner.parent == holder.id
    for e, attrs in ((held1, {"request": 7}), (held2, {"mode": "reorder"})):
        assert (e.t, e.kind, e.attrs) == (1.0, "sched", attrs)
        assert e.wall_ns == holder.wall_ns and e.parent == holder.id
        assert e.wall_dur_ns == 0
    assert first.parent is None and after.parent is None
    assert after.wall_ns >= holder.wall_end_ns
    assert len({e.id for e in tracer.events}) == 6


def _ev(i, parent, name, start, dur, kind="host"):
    return Event(0.0, kind, "x", name, 0.0, {}, wall_ns=start,
                 wall_dur_ns=dur, id=i, parent=parent)


# a synthetic tree: run [0, 100) > exec [10, 60) > apply [20, 50) >
# forward [25, 45); a transfer [5, 90) on its own thread
SYNTH = [_ev(1, None, "run", 0, 100), _ev(2, 1, "e", 10, 50, kind="exec"),
         _ev(3, 2, "apply", 20, 30), _ev(4, 3, "forward", 25, 20),
         _ev(5, 2, "transfer", 5, 85)]


def test_self_times_subtract_children_on_the_serving_thread():
    assert self_times(SYNTH) == {"run": 50, "exec": 20, "apply": 10,
                                 "forward": 20}


def test_idle_gaps_go_to_the_innermost_span_at_their_middle():
    busy = [(27, 43), (70, 80)]
    got = idle_by_span(SYNTH, busy, -10, 110)
    # gaps: [-10, 27) mid 8 in run; [43, 70) mid 56 in exec;
    # [80, 110) mid 95 in run
    assert got == {"run": 37 + 30, "exec": 27}
    assert idle_by_span(SYNTH, [], 200, 300) == {"outside": 100}
    assert idle_by_span(SYNTH, [(0, 100)], 0, 100) == {}
    assert idle_by_span(SYNTH, [(0, 20), (24, 30)], 0, 30) == {"apply": 4}


def test_wall_export_lays_spans_on_the_wall_clock(wall_run):
    tracer, _, _ = wall_run
    doc = chrome_trace(tracer.events)
    validate_chrome_trace(doc)
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    first = min(e.wall_ns for e in tracer.events)
    assert min(e["ts"] for e in slices) >= first / 1e3 - 1
    names = {e["name"] for e in slices}
    assert {"run", "batch", "apply", "forward", "fetch_out", "interpret",
            "transfer", "load_wait"} <= names
    threads = {e["args"]["name"] for e in doc["traceEvents"]
               if e["name"] == "thread_name"}
    assert {"loop", "model", "scheduler"} <= threads
    # an ``assign`` keeps its request's chain parent beside its span parent
    by_id = {e.id: e for e in tracer.events}
    assigns = [e for e in slices if e["cat"] == "assign"]
    assert any(e["args"]["parent"] is not None for e in assigns)
    for e in assigns:
        ev = by_id[e["args"]["id"]]
        assert e["args"]["parent"] == ev.attrs["parent"]
        assert e["args"]["span_parent"] == ev.parent is not None
