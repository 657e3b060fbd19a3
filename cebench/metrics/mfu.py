"""Model FLOPs of the work completed over the time it took, as a share of
the bf16 peak: the driver counts nominal sequences completed times one
sequence's FLOPs at the configuration's length (padding and wasted work
lower it), and the seconds (the window, or, under an open loop, the sum of
the dispatches' wall times), both without the profiled sub-window
(``Run.model_work``)."""

from cebench.lib.yardstick import MFU_PEAK, share_pct


def read(run, name):
    flop, secs = run.counters.get("model_flop"), run.counters.get("model_seconds")
    if not flop or not secs:
        return None
    return share_pct(flop / secs, MFU_PEAK)
