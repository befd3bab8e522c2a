"""The comparison that decides ``correct`` fails where the timed path is
broken underneath: the rest of a run (set-up, warm round, window, the
reference) driven at smoke widths on the CPU, the look for a card skipped,
with one fault planted at a time."""
import torch

from coebench import bench, cell, correct
from coebench.tests import smoke

NAME = "starcoder2_3b_nobias_x14"


def _run(seed=21):
    cfg, mix = smoke.config(NAME), smoke.mix("switch128")
    st = cell.Setup(cfg, mix, seed, torch.device("cpu"))
    st.port_cfg = cell.port_config(cfg)
    cell.make_weights(st)
    record = cell.drive(st, 0.4, False)
    verdict = correct.judge(record, st.host,
                            bench.limits(cfg, f"{NAME}.switch128"), seed,
                            st.device)
    return record, verdict["checks"]


def test_sound_run_passes():
    record, checks = _run()
    assert correct.passed(checks), checks
    assert record["attempted"] > 0 and checks["chain_faults"]["value"] == 0


def _wrap_forward(monkeypatch, fault):
    from repro_torch.models import transformer

    inner = transformer.forward

    def forward(params, tokens, cfg, *a, **kw):
        logits, aux = inner(params, tokens, cfg, *a, **kw)
        return fault(params, tokens, cfg, logits, inner, a, kw), aux

    monkeypatch.setattr(transformer, "forward", forward)


def test_half_the_batch_left_out(monkeypatch):
    """The forward runs only the first half of each batch's rows; the rest
    take the mean of those rows' logits."""
    def fault(params, tokens, cfg, logits, inner, a, kw):
        half = max(1, tokens.shape[0] // 2)
        kept = inner(params, tokens[:half], cfg, *a, **kw)[0]
        fill = kept.mean(0, keepdim=True).expand(
            tokens.shape[0] - half, *kept.shape[1:])
        return torch.cat([kept, fill])

    _wrap_forward(monkeypatch, fault)
    _, checks = _run()
    assert not correct.passed(checks), checks


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    """One row's last-position logits are altered in the forward."""
    def fault(params, tokens, cfg, logits, inner, a, kw):
        out = logits.clone()
        out[0, -1] = out[0, -1].roll(1)
        return out

    _wrap_forward(monkeypatch, fault)
    _, checks = _run()
    assert not correct.passed(checks), checks


def test_a_stage_on_the_wrong_expert(monkeypatch):
    """The engine runs the safety stage with another resident expert's
    weights."""
    from repro_torch.core.engines import RealEngine

    inner = RealEngine.execute

    def execute(self, ex, expert_id, batch):
        if expert_id == cell.SAFETY:
            other = next(e for e in self.device_params if e != cell.SAFETY)
            saved = self.device_params[cell.SAFETY]
            self.device_params[cell.SAFETY] = self.device_params[other]
            try:
                return inner(self, ex, expert_id, batch)
            finally:
                self.device_params[cell.SAFETY] = saved
        return inner(self, ex, expert_id, batch)

    monkeypatch.setattr(RealEngine, "execute", execute)
    _, checks = _run()
    assert not correct.passed(checks), checks


def test_a_chain_cut_short(monkeypatch):
    """The system drops the safety stage of every other request."""
    from repro_torch.core.serving import CoServeSystem

    inner = CoServeSystem.route_followup

    def route_followup(self, req, expert_id, output):
        if req.id % 2:
            return None
        return inner(self, req, expert_id, output)

    monkeypatch.setattr(CoServeSystem, "route_followup", route_followup)
    _, checks = _run()
    assert checks["chain_faults"]["value"] > 0
    assert not correct.passed(checks)
