"""The port's LM stack for the hybrid family against ``repro.models``:
Jamba's smoke config with its MoE switched off, one period of eight slots
with an attention slot at offset 4 among seven mamba slots. The checks and
their tolerances are those of ``test_torch_ssm_models.py``.
"""
import pytest

from test_torch_ssm_models import (check_bf16_compute,
                                   check_forward_prefill_decode_logits,
                                   check_greedy_generate,
                                   check_reference_pallas_path)

ARCH = "jamba_v0_1_52b"


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_prefill_decode_logits(impl):
    check_forward_prefill_decode_logits(ARCH, impl)


def test_reference_pallas_path_agrees():
    check_reference_pallas_path(ARCH)


def test_bf16_compute():
    check_bf16_compute(ARCH)


def test_greedy_generate_matches_teacher_forcing_and_the_reference():
    check_greedy_generate(ARCH)
