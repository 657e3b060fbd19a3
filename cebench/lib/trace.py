"""What a run records besides its clock: the harness's host spans, the
shapes of kernel A and kernel B launches (wrappers around the port's
entries), and the device timeline of a profiled sub-window.

The wrappers replace every binding of ``ops.attention.attention_fwd`` and
``ops.mips_kernel.mips_topk_fused`` in the port's loaded modules, so calls
made through any import of them pass here; the originals still run and
still count their launches. Events are reduced in memory; no trace file is
written.
"""

from __future__ import annotations

import functools
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from cebench.lib.yardstick import attention_cost, gaps, group_kernel, mips_cost, union_seconds

PACKAGE = "anncur_tpu_torch"


class Spans:
    """Host spans (name, start ns, end ns) on ``time.time_ns``, the clock
    the profiler's events are stamped on."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.items.append((name, t0, t1))

    def covering(self, t_ns: int) -> Optional[str]:
        """The innermost span open at ``t_ns`` (the latest started), or None."""
        best = None
        for name, s, e in self.items:
            if s <= t_ns < e and (best is None or s > best[1]):
                best = (name, s)
        return None if best is None else best[0]


def patch_everywhere(module_name: str, attr: str, wrapper_factory: Callable[[Callable], Callable]) -> Callable:
    """Replace ``module.attr`` and every other binding of the same function
    in the port's loaded modules by ``wrapper_factory(original)``; returns
    the original. A binding to an earlier run's wrapper in the same process
    (a module imported while that run's wrapper was bound) is replaced
    too, so every call passes this run's wrapper."""
    original = getattr(sys.modules[module_name], attr)
    # the wrapper carries the original's attributes (its launch counters):
    # the original counts through its module's binding, now the wrapper
    wrapped = functools.update_wrapper(wrapper_factory(original), original)
    wrapped.cebench_wrapper = attr
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == PACKAGE or name.startswith(PACKAGE + ".")):
            continue
        for key, val in list(vars(mod).items()):
            if val is original or (val is not wrapped and getattr(val, "cebench_wrapper", None) == attr):
                setattr(mod, key, wrapped)
    return original


class Launches:
    """Kernel A and kernel B launches seen while ``recording``: each one's
    (bytes, operations) as the yardstick counts them. Kernel B's outputs
    are also kept, with their queries, while ``capturing`` (a run's check
    follows the program from its own kernel B inputs)."""

    def __init__(self):
        self.recording = False
        self.capturing = False
        self.attention: List[Tuple[Tuple[int, ...], Any, int]] = []  # (b, g, s, nh, hd), n_keys tensor, elem bytes
        self.mips: List[Tuple[float, float]] = []
        self.captured: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []  # (queries, ids, scores)
        self._keys: Dict[int, Tuple[Any, torch.Tensor]] = {}

    def install(self) -> None:
        import anncur_tpu_torch.ops.attention  # noqa: F401  (loaded before patching)
        import anncur_tpu_torch.ops.mips_kernel  # noqa: F401

        patch_everywhere("anncur_tpu_torch.ops.attention", "attention_fwd", self._wrap_attention)
        patch_everywhere("anncur_tpu_torch.ops.mips_kernel", "mips_topk_fused", self._wrap_mips)

    def _n_keys(self, key_valid: torch.Tensor):
        # one device sum per mask: the layers of a forward share it
        hit = self._keys.get(id(key_valid))
        if hit is None or hit[0] is not key_valid:
            hit = (key_valid, key_valid.sum())
            self._keys = {id(key_valid): hit}
        return hit[1]

    def _wrap_attention(self, fn):
        def attention_fwd(q, k, v, key_valid, *args, **kw):
            if self.recording:
                b, g, nh, hd = q.shape
                self.attention.append(((b, g, k.shape[1], nh, hd), self._n_keys(key_valid), q.element_size()))
            return fn(q, k, v, key_valid, *args, **kw)
        return attention_fwd

    def _wrap_mips(self, fn):
        def mips_topk_fused(queries, items, k, n_valid=None, exclude=None):
            out = fn(queries, items, k, n_valid, exclude)
            if self.recording:
                nv = items.shape[0] if n_valid is None else int(n_valid)
                n_ex = 0 if exclude is None else exclude.shape[1]
                self.mips.append(mips_cost(queries.shape[0], queries.shape[1], nv, k, n_ex))
            if self.capturing:
                self.captured.append((queries, out[1], out[0]))
            return out
        return mips_topk_fused

    def attention_costs(self) -> List[Tuple[float, float]]:
        """(bytes, operations) of every recorded kernel A launch."""
        out = []
        for (b, g, s, nh, hd), n_keys, es in self.attention:
            out.append(attention_cost(b, g, s, nh, hd, int(n_keys), es))
        return out


class DeviceTrace:
    """The profiled sub-window, reduced: device operations (name, start ns,
    end ns), the window's host bounds, and what follows from them."""

    def __init__(self, ops: List[Tuple[str, int, int]], t0_ns: int, t1_ns: int):
        self.ops = [(n, max(s, t0_ns), min(e, t1_ns)) for n, s, e in ops if e > t0_ns and s < t1_ns]
        self.t0_ns, self.t1_ns = t0_ns, t1_ns

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    @property
    def busy_s(self) -> float:
        return union_seconds((s, e) for _, s, e in self.ops) / 1e9

    def group_seconds(self, group: str) -> float:
        return sum(e - s for n, s, e in self.ops if group_kernel(n) == group) / 1e9

    def count(self, group: str) -> int:
        return sum(1 for n, _, _ in self.ops if group_kernel(n) == group)

    def top_ops(self, n: int = 10) -> List[List[Any]]:
        """The device operations that took most time, by group and name."""
        by: Dict[str, float] = {}
        for name, s, e in self.ops:
            key = f"{group_kernel(name)}: {short_name(name)}"
            by[key] = by.get(key, 0.0) + (e - s) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_span(self, spans: Spans, n: int = 10) -> List[List[Any]]:
        """Idle stretches of the device, summed by the harness span the host
        was in when each began (``none`` outside every span)."""
        by: Dict[str, float] = {}
        for s, e in gaps(((a, b) for _, a, b in self.ops), self.t0_ns, self.t1_ns):
            name = spans.covering(s) or "none"
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def short_name(name: str) -> str:
    """A kernel's name cut at its argument list, at most 100 characters."""
    return name.replace("(anonymous namespace)::", "").split("(")[0][:100]


class Profiler:
    """torch.profiler over a sub-window, device activity only."""

    def __init__(self):
        self._prof = None
        self.t0_ns = self.t1_ns = 0
        self.trace: Optional[DeviceTrace] = None

    def warm(self) -> None:
        """One empty session at set-up: the profiler's first start loads and
        starts its tracing library, seconds that belong to no window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        ops = []
        for evt in prof.profiler.kineto_results.events():
            if evt.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = evt.start_ns()
            ops.append((evt.name(), s, s + evt.duration_ns()))
        self.trace = DeviceTrace(ops, self.t0_ns, self.t1_ns)
