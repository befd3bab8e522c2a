"""Bytes of the window's expert loads over the growth of the engine's
``measured_load_time`` (the transfer threads' wall time, read after each
channel's stream synchronised), in GB/s. Nothing to read without loads."""


def read(record):
    loads = record["after"]["switches"] - record["before"]["switches"]
    secs = record["after"]["load_s"] - record["before"]["load_s"]
    if loads <= 0 or secs <= 0:
        return None
    return loads * record["expert_bytes"] / secs / 1e9
