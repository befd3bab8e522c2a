"""The benchmark's weight maker lays out exactly the program's parameter
tree (names, shapes, dtypes) for every configuration, draws the same weights
from the same seed and different ones for each expert. The full-width sizes
counted by hand are each family's own
(``test_coebench_family_<model_type>.py``)."""
import pytest
import torch

from coebench import bench, cell, reference, weights
from coebench.tests import smoke

NAMES = [c["name"] for c in bench.Benchmark().spec["configs"]]


@pytest.mark.parametrize("name", NAMES)
def test_layout_is_the_programs_init_params_tree(name):
    from repro_torch.convert import flatten_params
    from repro_torch.models import transformer

    cfg = smoke.config(name)
    pc = cell.port_config(cfg)
    gen = torch.Generator().manual_seed(0)
    theirs = flatten_params(transformer.init_params(gen, pc))
    ours, _, _ = weights.make_expert(
        reference.family(cfg["model_type"]).layout(cfg), 5,
        torch.device("cpu"))
    assert list(ours) == list(theirs)
    for k in theirs:
        assert ours[k].shape == theirs[k].shape, k
        assert ours[k].dtype == theirs[k].dtype, k


def test_seeded_and_distinct():
    cfg = smoke.config("falcon_mamba_7b_nomixnorm_x19")
    layout = reference.family(cfg["model_type"]).layout(cfg)
    cpu = torch.device("cpu")
    a, _, _ = weights.make_expert(layout, weights.expert_seed(11, 0), cpu)
    b, _, _ = weights.make_expert(layout, weights.expert_seed(11, 0), cpu)
    c, _, _ = weights.make_expert(layout, weights.expert_seed(11, 1), cpu)
    d, _, _ = weights.make_expert(layout,
                                  weights.expert_seed(2 ** 31 + 11, 0), cpu)
    for k in a:
        assert torch.equal(a[k], b[k])
    w = "slots.slot0.mamba.in_proj"
    assert not torch.equal(a[w], c[w]) and not torch.equal(a[w], d[w])
    # the S4D-real A and the dt bias's softplus range
    a_log = a["slots.slot0.mamba.A_log"]
    assert torch.allclose(a_log[0, 0], torch.arange(1, 17.).log())
    dt = torch.nn.functional.softplus(
        a["slots.slot0.mamba.dt_bias"].float())
    assert dt.min() >= 9e-4 and dt.max() <= 0.11


def test_views_share_one_buffer():
    cfg = smoke.config("starcoder2_3b_nobias_x14")
    layout = reference.family(cfg["model_type"]).layout(cfg)
    named, buf, _ = weights.make_expert(layout, 3, torch.device("cpu"))
    entries, nbytes = weights.plan(layout)
    assert buf.numel() == nbytes
    for t in named.values():
        assert t.untyped_storage().data_ptr() == buf.data_ptr()
