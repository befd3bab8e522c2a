"""Each configuration's plain reference against the program computing in
float32 at smoke widths: the two compute one function. The check against an
independent computation is the family's own
(``test_coebench_family_<model_type>.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

from coebench import bench, cell, reference
from coebench.tests import smoke

CONFIGS = [c["name"] for c in bench.Benchmark().spec["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_is_the_programs_function(name):
    """The program computing in float32 on its plain path gives the
    reference's logits at smoke widths: the two compute one function."""
    from repro_torch.convert import nest_params
    from repro_torch.models import transformer

    cfg = smoke.config(name)
    cfg["served_dtype"] = "float32"
    cfg["port"]["overrides"].update(param_dtype="float32")
    pc = dataclasses.replace(cell.port_config(cfg), compute_dtype="float32",
                             attn_impl="xla")
    p = smoke.params(cfg, seed=9)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg["vocab_size"], (3, 40)).astype(np.int32))
    with torch.no_grad():
        prog = transformer.forward(nest_params(p), toks, pc,
                                   mode="eval")[0][:, -1]
        ref = reference.family(cfg["model_type"]).forward(p, toks.long(),
                                                          cfg)
    torch.testing.assert_close(prog, ref, rtol=2e-4, atol=2e-4)
