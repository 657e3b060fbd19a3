"""Queries per dispatch at the front end: the port's ``Coalescer``
counters, ``n_queries / n_dispatches``, over the window."""


def read(run, name):
    n = run.counters.get("dispatches")
    return run.counters["coalesced"] / n if n else None
