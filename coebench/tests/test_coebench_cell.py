"""One cell end to end at smoke widths on the CPU: the last line is
the run's JSON result, with its checks last."""
import json

from coebench import bench
from coebench.tests import smoke

CELL = "starcoder2_3b_nobias_x14.switch128"
FM_CELL = "falcon_mamba_7b_nomixnorm_x19.switch128"


def _result(lines):
    out = json.loads(lines[-1])
    assert list(out)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in out
    return out


def test_cell_end_to_end_prints_a_valid_last_line():
    rc, lines, err = smoke.run_cell(CELL, 3000000019, 1.0)
    assert rc == 0, err
    out = _result(lines)
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    spec = bench.Benchmark()
    want = {m["name"]: m["unit"] for m in spec.metrics("end_to_end", CELL)}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, check in out["checks"].items():
        assert f"check {name} " in err
        assert check["value"] <= check["limit"]


def test_traced_run_reports_per_layer_metrics():
    rc, lines, err = smoke.run_cell(FM_CELL, 7, 1.0, trace=1)
    assert rc == 0, err
    out = _result(lines)
    assert out["correct"] is True
    # the CPU has no kernels to trace: the device metrics stay silent
    assert {"loads_per_100req.switch128", "sched_us_per_req.switch128",
            "forward_us_per_token.switch128", "mfu_pct.switch128"} \
        <= set(out["metrics"])
    assert "mamba_scan_roofline.switch128" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}

