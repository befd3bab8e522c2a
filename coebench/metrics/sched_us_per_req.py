"""Host wall time of the control plane's decisions in the window (growth of
the system's ``sched_time`` plus the executors' ``mgmt_time``) per completed
request, in microseconds."""


def read(record):
    if not record["completed"]:
        return None
    grown = record["after"]["sched_s"] - record["before"]["sched_s"]
    return 1e6 * grown / record["completed"]
