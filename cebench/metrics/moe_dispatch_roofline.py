"""The expert layer's two dispatch kernels' share of their roofline: Σ
bound / Σ device time over the ``moe_permute`` and ``moe_combine``
launches of the profiled sub-window. A launch's bound counts what its
inputs need (``lib/dsv2_cost.py``: each row read once and written once);
the launches' shapes come from the driver's wrappers
(``drivers/build_decoder.py``), their device time from the trace. None
where the program has no such kernels."""

import sys

from cebench.lib.yardstick import bound_s

KERNELS = ("moe_permute", "moe_combine")


def read(run, name):
    costs, trace = getattr(run, "dispatch_costs", None), run.profiler.trace
    if trace is None or not costs:
        return None
    ops = [(s, e) for n, s, e in trace.ops if any(k in n for k in KERNELS)]
    secs = sum(e - s for s, e in ops) / 1e9
    if secs <= 0:
        return None
    total = sum(bound_s(b, o) for b, o in costs)
    # one kernel a launch; where the profiler kept fewer records than
    # launches were made, the bounds are scaled to the kernels it kept
    if len(ops) > len(costs):
        print(f"cebench: {name}: {len(ops)} kernels for {len(costs)} launches; no share", file=sys.stderr)
        return None
    if len(ops) < len(costs):
        print(f"cebench: {name}: {len(ops)} kernels for {len(costs)} launches; bounds scaled", file=sys.stderr)
        total *= len(ops) / len(costs)
    return 100.0 * total / secs
