"""Kernel B's share of its roofline: Σ bound / Σ device time of its score,
select and sort kernels over its launches in the profiled sub-window. The
products are counted at the bf16 peak whatever route computes them
(``lib/yardstick.py::mips_cost``)."""

from cebench.lib.roofline import share


def read(run, name):
    return share(run.launches.mips, "kernel_B_mips_topk", run.profiler.trace)
