"""Share of the traced window in which no kernel ran on the card (copies
and memsets do not count as busy), in percent."""


def read(record):
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
