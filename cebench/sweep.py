"""Find the knee of an open-loop cell: its window run at each of a list of
offered rates, one process, with each rate's latencies and whether the
backlog grew.

    python3 cebench/sweep.py --workload ce-yugioh.fixed-c600.open --rates 6 7 8 9 10 --seconds 40

A backlog grows when requests due late in the window wait longer than
those due early: the line prints the mean latency of the last quarter of
requests over that of the first, and the slope of latency against due
time. The knee is the highest rate whose backlog stays flat; the cell's
traffic file holds four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cebench.lib.harness import Run  # noqa: E402
from cebench.lib.yardstick import percentile  # noqa: E402


def sweep_point(cell: str, rate: float, seconds: float, seed: int, device: str) -> dict:
    import importlib

    run = Run(cell, seed, seconds, False, device, overrides={"params": {"rate_qps": rate}})
    driver = importlib.import_module(f"cebench.drivers.{run.traffic['driver']}")
    run.launches.install()
    st = driver.setup(run)
    run.open_window()
    driver.window(run, st)
    due = run.window_start + st.due
    lat = (st.done - due) * 1e3
    ok = np.isfinite(lat)
    q = max(1, len(lat) // 4)
    first, last = np.nanmean(lat[:q]), np.nanmean(lat[-q:])
    slope = float(np.polyfit(st.due[ok], lat[ok], 1)[0]) if ok.sum() > 2 else float("nan")
    return {"rate_qps": rate, "requests": len(lat), "answered": int(ok.sum()),
            "p50_ms": percentile(lat[ok], 50), "p95_ms": percentile(lat[ok], 95),
            "last_over_first_quarter": float(last / first), "slope_ms_per_s": slope,
            "queries_per_dispatch": run.counters["coalesced"] / max(1, run.counters["dispatches"]),
            "served_qps": run.counters["queries"] / (np.nanmax(st.done) - run.window_start)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=40)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    card = torch.cuda.get_device_name(0)
    for rate in args.rates:
        point = sweep_point(args.workload, rate, args.seconds, args.seed, "cuda:0")
        print(json.dumps({"card": card, **point}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
