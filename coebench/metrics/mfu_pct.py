"""Useful FLOPs of the window's forwards (``roofline.prompt_flops`` per
served prompt, padded rows left out) over the window's wall time times the
H100's dense bf16 peak, in percent; read beside the card's power limit."""
from coebench import roofline


def read(record):
    flops = sum(rows * roofline.prompt_flops(record["cfg"], s)
                for _, rows, s in record["forwards"])
    if not flops or record["window_s"] <= 0:
        return None
    return 100.0 * flops / (record["window_s"] * roofline.BF16_OPS_PER_S)
