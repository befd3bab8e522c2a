"""The ``moe_grouped`` launches' bounds from their shapes
(``flops/jamba.py``'s ``moe_grouped_layer``: the held experts' weights read
once and the expected rows in and out, against their operations) summed,
over their device time in the trace, in percent. Nothing to read where the
trace holds no launch of it or not the launches the window's forwards
imply."""
from coebench import devtrace


def read(record):
    return devtrace.roofline_pct(record, "moe_grouped", "moe_grouped")
