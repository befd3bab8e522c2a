"""The port's train steps against the reference's on the MoE, SSM and
encoder-decoder families: one step of ``make_train_step`` on the smoke
configs of Mixtral-8x22B (MoE in every layer, a sliding window; the aux
loss weighted by 0.01 into the loss) and Falcon-Mamba-7B (the port's
chunked scan, rematerialised chunk by chunk, against the reference's), and
of
``make_whisper_train_step`` on Whisper-medium's, with remat on, in float32
compute. Helpers and tolerances are those of ``test_torch_train_step.py``.
At these sizes every MoE group has at most 64 tokens, so routing is
dropless in both packages and ties go to the lower expert index in both.
"""
import pytest

from test_torch_train_step import both_steps, check_step


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "falcon_mamba_7b",
                                  "whisper_medium"])
def test_train_step_matches_the_reference(arch):
    want, got = both_steps(arch)
    check_step(want, got, "float32")
    if arch == "mixtral_8x22b":
        assert float(got[2]["aux_loss"]) > 0
