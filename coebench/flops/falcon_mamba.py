"""Falcon-Mamba: FLOPs of a served prompt and ``mamba_scan`` launches of a
forward, from shapes."""
from coebench import roofline


def prompt_flops(cfg: dict, s: int) -> float:
    """Every layer's in-, x-, dt- and out-projections and depthwise conv at
    every position, the scan's state update and read-out (4 operations per
    channel and state), the LM head at the last position only. Norms, the
    softplus, SiLU, the gate and the embedding lookup are not counted."""
    d = cfg["hidden_size"]
    di = cfg["intermediate_size"]
    n = cfg["state_size"]
    rk = cfg["time_step_rank"]
    w = cfg["conv_kernel"]
    per_token = (2 * d * 2 * di + 2 * w * di + 2 * di * (rk + 2 * n)
                 + 2 * rk * di + 4 * di * n + 2 * di * d)
    return cfg["num_hidden_layers"] * s * per_token \
        + 2 * d * cfg["vocab_size"]


def launches(cfg: dict, rows: int, s: int) -> dict:
    """One scan launch a layer over the padded batch: x in the served
    dtype, dt, B and C in float32, as the program's Mamba block hands them
    to the kernel."""
    return {"mamba_scan": (cfg["num_hidden_layers"],
                           roofline.mamba_scan_launch(
                               rows, s, cfg["intermediate_size"],
                               cfg["state_size"], cfg["served_dtype"],
                               "float32", "float32"))}
