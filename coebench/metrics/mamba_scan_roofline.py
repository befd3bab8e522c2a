"""The ``mamba_scan`` launches' bounds from their shapes
(``roofline.mamba_scan_launch``) summed, over their device time in the
trace, in percent. Nothing to read where the trace holds no launch of it or
not the launches the window's forwards imply."""
from coebench import devtrace


def read(record):
    return devtrace.roofline_pct(record, "mamba_scan", "mamba_scan")
