"""The port's LM stack for Jamba-v0.1 with its MoE layers on, against
``repro.models``: its smoke config's period of eight slots (seven mamba
mixers and one attention mixer at offset 4; MoE FFNs with 4 experts, top-2,
on the odd slots), so one model runs all three of the port's kernels'
paths and the MoE layer. The checks and their tolerances are those of
``test_torch_moe_models.py``.
"""
import pytest

from test_torch_moe_models import (check_forward_prefill_decode_logits,
                                   check_greedy_generate,
                                   check_trees_convert)

ARCH = "jamba_v0_1_52b"


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_prefill_decode_logits(impl):
    check_forward_prefill_decode_logits(ARCH, impl)


def test_greedy_generate_matches_teacher_forcing_and_the_reference():
    check_greedy_generate(ARCH)


def test_reference_tree_converts_and_nests_back():
    check_trees_convert(ARCH)
