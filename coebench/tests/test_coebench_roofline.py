"""The frozen FLOP and byte counts against hand values for one shape (each
family's prompt FLOPs: ``test_coebench_family_<model_type>.py``)."""
import pytest

from coebench import bench, roofline


def test_causal_pairs():
    assert roofline.causal_pairs(4, 4) == 1 + 2 + 3 + 4
    assert roofline.causal_pairs(4, 4, window=2) == 1 + 2 + 2 + 2
    assert roofline.causal_pairs(128, 128) == 128 * 129 // 2


def test_flash_launch_starcoder2_batch():
    """B 8, 24 query and 2 KV heads of 128, S 128, bf16."""
    got = roofline.flash_attention_launch(8, 24, 2, 128, 128)
    assert got["ops"] == 4 * 8 * 24 * 128 * 8256
    assert got["bytes"] == (2 * 8 * 24 * 128 * 128 + 2 * 8 * 2 * 128 * 128) * 2
    assert got["bound_by"] == "bytes"
    assert got["bound_s"] == pytest.approx(13631488 / 3.35e12)


def test_scan_launch_falcon_mamba_batch():
    """B 8, S 128, D 8192, N 16: x bf16, dt, B, C float32."""
    got = roofline.mamba_scan_launch(8, 128, 8192, 16)
    b, s, d, n = 8, 128, 8192, 16
    assert got["bytes"] == (b * s * d * (2 + 2 + 4) + 2 * b * s * n * 4
                            + d * n * 4 + d * 4 + b * d * n * 4)
    assert got["ops"] == b * s * d * (7 * n + 3)
    assert got["bound_by"] == "bytes"


def test_launches_from_forwards():
    sc = bench.Benchmark().config("starcoder2_3b_nobias_x14")
    got = roofline.launches(sc, [(8, 6, 128), (4, 3, 128)])
    one8 = roofline.flash_attention_launch(8, 24, 2, 128, 128, "bfloat16",
                                           4096)["bound_s"]
    one4 = roofline.flash_attention_launch(4, 24, 2, 128, 128, "bfloat16",
                                           4096)["bound_s"]
    assert got["flash_attention"]["launches"] == 60
    assert got["flash_attention"]["bound_s"] == pytest.approx(
        30 * (one8 + one4))
