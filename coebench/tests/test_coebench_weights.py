"""The benchmark's weight maker lays out exactly the program's parameter
tree (names, shapes, dtypes), draws the same weights from the same seed and
different ones for each expert."""
import pytest
import torch

from coebench import cell, reference, weights
from coebench.tests import smoke

NAMES = ["starcoder2_3b_nobias_x14", "falcon_mamba_7b_nomixnorm_x19"]


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


def _hand_count(name):
    if name.startswith("starcoder2"):   # d 3072, 24 + 2 heads of 128, ff
        d, kv, ff, v, layers = 3072, 256, 12288, 49152, 30
        layer = 4 * d + 2 * d * d + 2 * d * kv + 2 * d * ff
        return v * d + layers * layer + 2 * d, 0
    d, di, n, rk, v, layers = 4096, 8192, 16, 256, 65024, 16
    layer = (d + d * 2 * di + 4 * di + di + di * (rk + 2 * n) + rk * di
             + di + di * d)
    return 2 * v * d + layers * layer + d, layers * (di * n + di)


@pytest.mark.parametrize("name", NAMES)
def test_full_width_layout_sizes(name):
    """At the published widths: the parameters counted by hand, bf16 but
    Mamba's A and D in float32 (3.030 B and 2.218 B parameters, the
    latter with its untied head)."""
    cfg = smoke.json.loads((smoke.HERE / "configs" / f"{name}.json")
                           .read_text())
    layout = reference.family(cfg["model_type"]).layout(cfg)
    n16 = sum(torch.Size(s).numel() for _, s, dt, *_ in layout
              if dt == "bfloat16")
    n32 = sum(torch.Size(s).numel() for _, s, dt, *_ in layout
              if dt == "float32")
    assert (n16, n32) == _hand_count(name)


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
