"""The 95th percentile (nearest rank), over every request completed in the
window, of the wall time from its round's submission to the program's
completion callback for its last stage."""
import math


def read(record):
    xs = sorted(record["latencies"])
    if not xs:
        return None
    return xs[min(len(xs) - 1, math.ceil(0.95 * len(xs)) - 1)]
