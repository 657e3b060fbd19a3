"""One run of one cell: find its files by name, set up, measure the
window, check what the timed path produced against the plain reference,
read the per-layer metrics, and print the result line.

A cell's files, all found by name from ``BENCHMARK.json``:

- ``traffic/<cell>.json``: its configuration, driver, parameters, the
  traced sub-window and the limits of its checks;
- ``configs/<config>.json``: the model and the deployment;
- ``drivers/<driver>.py``: ``setup(run)``, ``window(run, state)``,
  ``release(run, state)``, ``check(run, state)`` and ``control(run)``;
- ``metrics/<family>.py`` for each per-layer metric ``<family>.<suffix>``
  that lists the cell: ``read(run, name)``, a number or None.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from cebench.lib.trace import Launches, Profiler, Spans
from cebench.lib.world import HERE, load_config

ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "anncur_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (``anncur_tpu_torch`` is another name)."""
    return sorted({name.split(".")[0] for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def load_benchmark(root: str = ROOT) -> Dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json")) as fin:
        return json.load(fin)


def find_cell(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_traffic(cell: str) -> Dict[str, Any]:
    with open(os.path.join(HERE, "traffic", f"{cell}.json")) as fin:
        return json.load(fin)


class Run:
    """The state of one run, handed to the cell's driver and readers."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
                 overrides: Optional[Dict[str, Any]] = None, t_start: Optional[float] = None):
        self.bench = load_benchmark()
        self.cell = find_cell(self.bench, cell)
        self.name = cell
        self.traffic = load_traffic(cell)
        if (self.traffic["config"], self.traffic["traffic"]) != (self.cell["config"], self.cell["traffic"]):
            raise ValueError(f"traffic/{cell}.json names {self.traffic['config']}/{self.traffic['traffic']}, "
                             f"BENCHMARK.json {self.cell['config']}/{self.cell['traffic']}")
        overrides = overrides or {}
        self.cfg = load_config(self.cell["config"], overrides.get("config"))
        self.params = {**self.traffic["params"], **overrides.get("params", {})}
        self.limits = {**self.traffic["limits"], **overrides.get("limits", {})}
        self.seed, self.seconds, self.tracing = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.spans = Spans()
        self.launches = Launches()
        self.profiler = Profiler()
        self.counters: Dict[str, float] = {}
        self.e2e: Dict[str, float] = {}
        self.checks: Dict[str, Tuple[float, float]] = {}
        self.attempted = self.failed = 0
        self.window_start = self.deadline = None
        # host-clock (start, end) of the profiled sub-window, the profiler's
        # start and stop included; None until it opens, end inf until it closes
        self.traced_span: Optional[Tuple[float, float]] = None
        self.memory_peak = 0
        sub = self.traffic.get("trace", {})
        self.trace_from = float(sub.get("start_s", 0.0))
        self.trace_to = self.trace_from + float(sub.get("seconds", seconds))

    # ------------------------------------------------------------ clock

    def now(self) -> float:
        return time.perf_counter()

    def open_window(self) -> None:
        """Set-up is over: the window starts now and lasts ``seconds``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.window_start = self.now()
        self.deadline = self.window_start + self.seconds
        self.e2e["setup_s"] = self.window_start - self.t_start

    def elapsed(self) -> float:
        return self.now() - self.window_start

    def trace_tick(self) -> None:
        """Between two units of work: start the profiler when the traced
        sub-window opens, stop it when it closes (traced runs only)."""
        if not self.tracing or self.device.type != "cuda" or self.profiler.trace is not None:
            return
        t = self.elapsed()
        if not self.profiler.active and self.trace_from <= t < self.trace_to:
            t0 = self.now()
            self.profiler.start()
            self.launches.recording = True
            self.traced_span = (t0, math.inf)
        elif self.profiler.active and t >= self.trace_to:
            self.close_trace()

    def close_trace(self) -> None:
        if self.profiler.active:
            self.launches.recording = False
            self.profiler.stop()
            self.traced_span = (self.traced_span[0], self.now())

    def model_work(self, units: List[Tuple[float, float, float]], closed: bool) -> None:
        """Set the counters ``mfu`` reads from ``units`` (start, end, model
        FLOPs) of the window: the FLOPs of the units that lie outside the
        profiled sub-window, over the time they took. A closed loop's time
        is the window's up to the last unit's end, less the sub-window; an
        open loop's is the units' own (its window is set by the offered
        load). The sub-window, whose profiler slows the work and whose stop
        reduces the events on the host, counts in neither."""
        if not units:
            return
        c0, c1 = self.traced_span or (math.inf, math.inf)
        kept = [(s, e, f) for s, e, f in units if e <= c0 or s >= c1]
        if closed:
            end = max(e for _, e, _ in units)
            secs = end - self.window_start - max(0.0, min(end, c1) - max(self.window_start, c0))
        else:
            secs = sum(e - s for s, e, _ in kept)
        self.counters.update(model_flop=sum(f for _, _, f in kept), model_seconds=secs)

    def count(self, key: str, n: float = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def check(self, name: str, value: float, limit: Optional[float] = None) -> None:
        """Record a compared number beside its limit (the traffic file's
        ``limits[name]`` unless given)."""
        self.checks[name] = (float(value), float(self.limits[name] if limit is None else limit))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def wrap_counting(obj: Any, attr: str, counter: Callable[[tuple, dict], None]) -> None:
    """Replace the bound method ``obj.attr`` by one that calls ``counter``
    with its arguments first (the harness counts the rows the CE and the
    towers are handed, padding included)."""
    fn = getattr(obj, attr)

    def counted(*args, **kw):
        counter(args, kw)
        return fn(*args, **kw)

    setattr(obj, attr, counted)


def per_layer_metrics(run: Run) -> Dict[str, Dict[str, Any]]:
    """Each per-layer metric that lists this cell, by its reader; those
    whose reader finds nothing are left out."""
    out = {}
    for metric in run.bench["per_layer"]:
        if run.name not in metric.get("workloads", [run.name]):
            continue
        family = metric["name"].split(".")[0]
        reader = importlib.import_module(f"cebench.metrics.{family}")
        value = reader.read(run, metric["name"])
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def end_to_end_metrics(run: Run) -> Dict[str, Dict[str, Any]]:
    out = {}
    for metric in run.bench["end_to_end"]:
        if run.name in metric.get("workloads", [run.name]) and metric["name"] in run.e2e:
            out[metric["name"]] = {"value": run.e2e[metric["name"]], "unit": metric["unit"]}
    return out


def device_info(run: Run) -> Dict[str, Any]:
    info: Dict[str, Any] = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
                            "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
                            "count": 1, "memory_peak_bytes": int(run.memory_peak)}
    trace = run.profiler.trace
    if run.tracing and trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def execute(run: Run) -> Dict[str, Any]:
    """Set up, measure, check; the result's object (not yet printed)."""
    if run.device.type == "cuda":
        torch.cuda.set_device(run.device)
    driver = importlib.import_module(f"cebench.drivers.{run.traffic['driver']}")
    run.launches.install()
    if run.tracing and run.device.type == "cuda":
        run.profiler.warm()
    state = driver.setup(run)
    run.open_window()
    driver.window(run, state)
    run.close_trace()
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        run.memory_peak = torch.cuda.max_memory_allocated(run.device)
    driver.release(run, state)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    driver.check(run, state)
    result: Dict[str, Any] = {
        "correct": run.correct,
        "attempted": int(run.attempted),
        "failed": int(run.failed),
        "metrics": per_layer_metrics(run) if run.tracing else end_to_end_metrics(run),
        "device": device_info(run),
    }
    if run.tracing and run.profiler.trace is not None:
        result["breakdown"] = {"device_ops": run.profiler.trace.top_ops(),
                               "idle_gaps": run.profiler.trace.idle_by_span(run.spans)}
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in run.checks.items()}
    return result


def check_lines(result: Dict[str, Any]) -> List[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in result["checks"].items()]
