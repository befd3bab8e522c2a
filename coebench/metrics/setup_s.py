"""Process start to the window's first submission: imports, weights made and
page-locked, the profile, the system's warm placement and the warm round
(and, in a checkout's first run, the kernels' build)."""


def read(record):
    return record["setup_s"]
