"""Every configuration, mix and metric that ``BENCHMARK.json`` names is
found by name, and the file keeps to the contract's form."""
import json
import re

import pytest

from coebench import bench, cell, reference, roofline
from coebench.tests import smoke

SPEC = bench.Benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|^(hidden_size|intermediate_size|"
                    r"state_size|time_step_rank|conv_kernel|expand|"
                    r"num_experts_per_tok)$")


def test_top_level_keys():
    assert set(SPEC.spec) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert SPEC.spec["command"] == ["python3", "coebench/run.py"]
    assert 1 <= SPEC.spec["run_seconds"] <= 51
    assert len((smoke.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("entry", SPEC.spec["configs"],
                         ids=lambda c: c["name"])
def test_config_found_and_cut_honestly(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    cfg = SPEC.config(entry["name"])
    assert cfg["name"] == entry["name"]
    assert entry["file"].startswith("coebench/")
    for key in entry["reduced"]:
        assert NAME.match(key) and not WIDTHS.search(key), key
        assert key in cfg["changed_from_source"]
    assert set(cfg["changed_from_source"]) == set(entry["reduced"])
    for key in cfg["not_run"]:     # a program gap: published value, no cut
        assert key in cfg and key not in entry["reduced"], key
    coe = cfg["coe"]                 # more experts than the pool holds
    assert len(coe["domains"]) + 1 > coe["pool_experts"]
    pc = cell.port_config(cfg)                  # every matched key agrees
    assert pc.num_layers == cfg["num_hidden_layers"]
    assert reference.family(cfg["model_type"]).layout(cfg)
    assert roofline.prompt_flops(cfg, 16) > 0
    assert set(cfg["limits"]) == {"chain_faults", "token_gap",
                                  "logit_rel_rms"}
    assert cfg["limits"]["chain_faults"] == 0


@pytest.mark.parametrize("work", SPEC.spec["workloads"],
                         ids=lambda w: w["name"])
def test_workload_found(work):
    assert set(work) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(work["name"]) and work["chips"] == 1
    assert len(work["why"]) <= 200
    SPEC.config(work["config"])
    mix = bench.mix(work["traffic"])
    assert mix["name"] == work["traffic"]
    kinds = {m["name"] for m in SPEC.metrics("end_to_end", work["name"])}
    assert "setup_s" in kinds and len(kinds) >= 2
    assert SPEC.metrics("per_layer", work["name"])
    assert bench.limits(SPEC.config(work["config"]), work["name"])


@pytest.mark.parametrize("metric", SPEC.spec["end_to_end"]
                         + SPEC.spec["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(bench.reader(metric["name"]))
    if "_roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] in {m["name"] for m in SPEC.spec["end_to_end"]}
        layers = {m["layer"] for m in SPEC.spec["per_layer"]}
        assert metric["layer"] in layers
    for w in metric.get("workloads", []):
        SPEC.workload(w)
        if "moves" in metric:      # each listed cell reports what it moves
            assert metric["moves"] in {
                m["name"] for m in SPEC.metrics("end_to_end", w)}


def test_readers_are_silent_without_their_source():
    record = {"cfg": SPEC.config("falcon_mamba_7b_nomixnorm_x19"), "traced": False,
              "forwards": [], "window_s": 1.0, "completed": 0,
              "latencies": [], "setup_s": 1.0, "expert_bytes": 1,
              "before": {"switches": 0, "sched_s": 0.0, "load_s": 0.0},
              "after": {"switches": 0, "sched_s": 0.0, "load_s": 0.0}}
    for name in ("h2d_gbps", "forward_us_per_token", "mfu_pct",
                 "device_idle_pct", "mamba_scan_roofline",
                 "flash_attention_roofline", "latency_p95_s",
                 "loads_per_100req"):
        assert bench.reader(name)(record) is None, name


@pytest.mark.parametrize("name", ["switch128"])
def test_mix_files(name):
    mix = json.loads((bench.HERE / "mixes" / f"{name}.json").read_text())
    assert {"round_size", "domains", "prompt_tokens", "check_fraction",
            "check_requests"} <= set(mix)
