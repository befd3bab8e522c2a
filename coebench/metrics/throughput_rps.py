"""Requests whose whole chain (domain expert, then safety expert) completed
in the window, over the window's wall time."""


def read(record):
    if record["window_s"] <= 0:
        return None
    return record["completed"] / record["window_s"]
