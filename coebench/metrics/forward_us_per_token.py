"""The benchmark's timer around each forward of the window, a device
synchronisation on each side, over the prompt tokens served (padded rows
left out), in microseconds a token. Traced runs only."""


def read(record):
    if not record["traced"]:
        return None
    tokens = sum(rows * s for _, rows, s in record["forwards"])
    if not tokens:
        return None
    return 1e6 * record["forward_s"] / tokens
