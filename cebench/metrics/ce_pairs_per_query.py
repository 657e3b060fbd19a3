"""CE pairs per query answered: every row the harness's wrapper of the
CE's ``score`` was handed in the window, padding included, over the
queries answered."""


def read(run, name):
    q = run.counters.get("queries")
    return run.counters.get("ce_pairs", 0) / q if q else None
