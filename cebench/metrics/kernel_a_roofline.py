"""Kernel A's share of its roofline: Σ bound / Σ device time over its
launches in the profiled sub-window. A launch's bound counts what its
inputs need (valid keys only; ``lib/yardstick.py::attention_cost``)."""

from cebench.lib.roofline import share


def read(run, name):
    return share(run.launches.attention_costs(), "kernel_A_attention", run.profiler.trace, kernels_per_launch=1)
