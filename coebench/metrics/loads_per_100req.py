"""Expert loads onto the card in the window (growth of the executors'
``stats.switches``) per 100 completed requests."""


def read(record):
    if not record["completed"]:
        return None
    loads = record["after"]["switches"] - record["before"]["switches"]
    return 100.0 * loads / record["completed"]
