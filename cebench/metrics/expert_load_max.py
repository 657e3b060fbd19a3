"""The expert layers' straggler factor: rows the busiest expert computed
over the mean expert's, from the program's device counter
``moe.expert_rows`` ((expert layers, experts), ``utils/tracker.py``),
which the driver zeroes when set-up ends and which is read after the
window. Layers are weighted by their rows, Σ_layers max / Σ_layers mean,
so the final layer's few rows (its experts run at one position a pair)
count for what they cost. None where the program keeps no such counter."""

from cebench.metrics.queue_wait_p95_ms import tracer


def read(run, name):
    trc = tracer()
    rows = trc.read_counter("moe.expert_rows") if trc is not None and hasattr(trc, "read_counter") else None
    if rows is None or not int(rows.sum()):
        return None
    rows = rows.double()
    return float(rows.max(dim=1).values.sum() / rows.mean(dim=1).sum())
