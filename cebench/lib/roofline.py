"""A kernel's share of its roofline over a profiled sub-window: the sum of
its launches' bounds over the sum of its device time."""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

from cebench.lib.yardstick import bound_s


def share(costs: List[Tuple[float, float]], group: str, trace, kernels_per_launch: Optional[int] = None) -> Optional[float]:
    """100 Σ bound / Σ device seconds of ``group``'s kernels. Where the
    profiler kept fewer of a one-kernel-per-launch group's kernels than
    launches were made (it drops records), the bounds are scaled to the
    kernels it kept; where it saw more, the launches are miscounted and
    there is no share."""
    if trace is None or not costs:
        return None
    secs = trace.group_seconds(group)
    if secs <= 0:
        return None
    total = sum(bound_s(b, o) for b, o in costs)
    if kernels_per_launch:
        seen = trace.count(group) / kernels_per_launch
        if seen > len(costs):
            print(f"cebench: {group}: {trace.count(group)} kernels for {len(costs)} launches; no share",
                  file=sys.stderr)
            return None
        if seen < len(costs):
            print(f"cebench: {group}: {trace.count(group)} kernels for {len(costs)} launches; bounds scaled",
                  file=sys.stderr)
            total *= seen / len(costs)
    return 100.0 * total / secs
