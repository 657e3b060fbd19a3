"""CE pairs per score-matrix entry delivered: every row the CE was handed
in the window (slab padding included) over the entries returned."""


def read(run, name):
    n = run.counters.get("entries")
    return run.counters.get("ce_pairs", 0) / n if n else None
