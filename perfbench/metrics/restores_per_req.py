"""State restores (the state cache's counter, reset before the window)
per request answered in the window."""


def read(run):
    answered = sum(r.ok for r in run.records)
    return run.counters["n_restores"] / answered if answered else None
