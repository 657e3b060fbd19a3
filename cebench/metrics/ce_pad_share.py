"""Share of the CE pairs that padded a batch: Σ ``ce.pad_pairs`` / Σ
``ce.pairs`` over the port's engine calls (``utils/tracker.py``; the rows
``query_tokens_batch`` hands the CE, and those of its padding queries)
that started in the window, less those the profiled sub-window disturbed,
by the rule ``queue_wait_p95_ms`` keeps its waits by: the backlog the
profiler's stop leaves is served in large, padded dispatches, which an
untraced run does not see. So it reads the padding of the steady load,
which ``ce_pairs_per_query`` (every call's rows, from outside) cannot
tell apart. None where the program records no such samples."""

from cebench.metrics.queue_wait_p95_ms import tracer, undisturbed


def read(run, name):
    trc = tracer()
    if trc is None:
        return None
    waits = trc.samples("serve.queue_wait")
    pairs = sum(s.value for s in undisturbed(run, trc.samples("ce.pairs"), waits))
    pad = sum(s.value for s in undisturbed(run, trc.samples("ce.pad_pairs"), waits))
    return 100.0 * pad / pairs if pairs else None
