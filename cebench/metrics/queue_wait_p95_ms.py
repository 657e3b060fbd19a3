"""95th percentile of the time a query waited in the front end's queue:
the port's ``serve.queue_wait`` samples (``utils/tracker.py``; from
``Coalescer.submit`` enqueuing a query to its worker taking it) of the
queries enqueued in the window, less those the profiled sub-window
disturbed. The profiler's stop holds the host for about 1.5 s, and at
four fifths of the knee the backlog that builds then takes seconds to
drain, so the stretch left out runs from the sub-window's start to the
first query after its end that was taken at once (a wait under
``QUIET_NS``: the queue was empty again). None where the program records
no such samples."""

import math
import time

from cebench.lib.yardstick import percentile

# a wait this short found the worker idle and the queue empty: it waited
# for no dispatch (one takes 50 ms or more)
QUIET_NS = 5_000_000


def tracer():
    """The port's tracer, or None for a program without one."""
    try:
        from anncur_tpu_torch.utils.tracker import TRACER
    except ImportError:
        return None
    return TRACER


def to_ns(t: float, offset: int) -> float:
    """A time on the run's host clock (``time.perf_counter``) on ``time.time_ns``."""
    return t if math.isinf(t) else int(t * 1e9) + offset


def undisturbed(run, items, waits):
    """The samples of ``items`` that start in the window and lie outside
    the stretch the profiled sub-window disturbed: from its start until
    the first query after its end that the worker took at once, read from
    ``waits`` (the ``serve.queue_wait`` samples); all of them where the
    run traced nothing."""
    if run.window_start is None:
        return []
    offset = time.time_ns() - time.perf_counter_ns()
    lo, hi = to_ns(run.window_start, offset), to_ns(run.deadline, offset)
    c0, c1 = (to_ns(t, offset) for t in run.traced_span) if run.traced_span else (math.inf, math.inf)
    drained = min((s.start_ns for s in waits if s.start_ns >= c1 and s.value < QUIET_NS), default=math.inf)
    return [s for s in items if lo <= s.start_ns < hi and (s.end_ns <= c0 or s.start_ns >= max(c1, drained))]


def kept_waits(run, waits):
    """The ``serve.queue_wait`` samples of queries enqueued in the window,
    less those enqueued from the profiled sub-window's start until the
    queue drained after its end, and those whose wait overlaps it."""
    return undisturbed(run, waits, waits)


def read(run, name):
    trc = tracer()
    if trc is None:
        return None
    waits = [s.value / 1e6 for s in kept_waits(run, trc.samples("serve.queue_wait"))]
    return percentile(waits, 95) if waits else None
