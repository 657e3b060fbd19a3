"""Share of the profiled sub-window in which no operation ran on the card:
1 - (union of device operation intervals) / (window length)."""


def read(run, name):
    trace = run.profiler.trace
    if trace is None or trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
