"""Share of the profiled sub-window in which the card idled while the host
ran the program: the parts of the device's idle stretches
(``lib/trace.py::DeviceTrace``) during which one of the port's spans
(``utils/tracker.py``, recorded while the profiler records) was open on
some thread, over the sub-window. It is part of ``device_idle``; the rest
is idle time with no program span open (an empty queue, the harness
between calls). A stretch is cut where spans open and close, not counted
whole by where it begins: the stretch that starts at a dispatch's last
copy to the host lasts, with an empty queue, until the next dispatch.
The split by innermost span (the open span that started last) goes to
standard error. None where the program recorded no span there."""

import sys
from typing import Dict

from cebench.lib.yardstick import gaps
from cebench.metrics.queue_wait_p95_ms import tracer


def idle_by_span(trace, spans) -> Dict[str, float]:
    """Seconds of device idle time by the innermost span open at the time;
    idle time with no span open is left out."""
    # a sweep over the ends of idle stretches and spans, in time order;
    # at equal times ends come before starts
    events = []
    for g0, g1 in gaps(((a, b) for _, a, b in trace.ops), trace.t0_ns, trace.t1_ns):
        events += [(g0, 1, "gap", None), (g1, 0, "gap", None)]
    for s in spans:
        events += [(s.start_ns, 1, "span", s), (s.end_ns, 0, "span", s)]
    events.sort(key=lambda e: (e[0], e[1]))
    open_spans, idle, by, t = {}, False, {}, None
    for when, starts, kind, span in events:
        if idle and open_spans and t is not None and when > t:
            inner = max(open_spans.values(), key=lambda s: (s.start_ns, s.seq))
            by[inner.name] = by.get(inner.name, 0.0) + (when - t) / 1e9
        t = when
        if kind == "gap":
            idle = bool(starts)
        elif starts:
            open_spans[span.seq] = span
        else:
            open_spans.pop(span.seq, None)
    return by


def read(run, name):
    trace, trc = run.profiler.trace, tracer()
    if trace is None or trace.window_s <= 0 or not trace.ops or trc is None:
        return None
    spans = [s for s in trc.spans() if s.end_ns > trace.t0_ns and s.start_ns < trace.t1_ns]
    if not spans:
        return None
    by = idle_by_span(trace, spans)
    split = ", ".join(f"{k} {v:.6f}" for k, v in sorted(by.items(), key=lambda kv: -kv[1]))
    print(f"cebench: {name}: device idle seconds by innermost program span, of a {trace.window_s:.6f} s "
          f"sub-window: {split or 'none'}", file=sys.stderr)
    return 100.0 * sum(by.values()) / trace.window_s
