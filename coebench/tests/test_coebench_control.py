"""The control, the reference with every matrix weight in float8 e4m3 in
the program's place, reads well above the program on the same rows: on the
CPU at smoke widths, and on the card at a cell's own size."""
import json

import pytest
import torch

from coebench import bench, cell, control, correct
from coebench.tests import smoke

CONFIGS = [c["name"] for c in bench.Benchmark().spec["configs"]]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_control_reads_above_the_program(name):
    cfg, mix = smoke.config(name), smoke.mix("switch128")
    st = cell.Setup(cfg, mix, 5, torch.device("cpu"))
    st.port_cfg = cell.port_config(cfg)
    cell.make_weights(st)
    record = cell.drive(st, 0.4, False)
    rows = correct.selected(record, 5)
    refs = correct.reference_rows(rows, st.host, cfg, st.device,
                                  control=True)
    prog = correct.numbers(rows, refs)
    ctrl = correct.numbers(rows, refs, "control")
    assert ctrl["logit_rel_rms"] >= 3 * prog["logit_rel_rms"]
    if name.startswith("starcoder2"):
        assert ctrl["logit_rel_rms"] > cfg["limits"]["logit_rel_rms"] \
            > prog["logit_rel_rms"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


CELLS = {}
for _w in bench.Benchmark().spec["workloads"]:      # one cell a config
    CELLS.setdefault(_w["config"], _w["name"])


@pytest.mark.cuda
@pytest.mark.parametrize("work", sorted(CELLS.values()))
def test_control_fails_at_the_cells_size(card, capsys, work):
    """A cell of each configuration at its own size, three seeds, judged
    by ``correct.passed`` against the cell's limits: the program correct on
    each, the control not correct on each."""
    assert control.main(["--workload", work, "--seeds", "71,72,73",
                         "--control-seeds", "3", "--seconds", "8"],
                        device=card) == 0
    out = capsys.readouterr().out
    with capsys.disabled():
        print(out)
    lines = [json.loads(x) for x in out.splitlines()]
    assert len(lines) == 4
    for line in lines[:-1]:
        assert line["chain_faults"] == 0 and line["rows"] > 0
        assert line["correct"] is True
        assert line["control_correct"] is False
