"""Experiment tracking + profiling.

Counterpart of ``anncur_tpu/utils/tracker.py``; the profiler is
``torch.profiler`` in place of ``jax.profiler``.

The reference streams losses/LR/progress fractions to wandb with an
online -> offline fallback chain (models/pairwise_trainer.py:183-189,
run_cross_encoder_for_ment_ent_matrix_zeshel.py:351-377). This tracker
keeps that contract with zero mandatory dependencies: metrics append to
a JSONL file and mirror to the logger; if wandb is importable AND
usable, it is attached transparently (never required, never fatal —
and unlike the reference, no API keys are ever hardcoded; see the
explicit warning about run_retrieval_..._w_fixed_train_test_splits.py:458
in SURVEY §5.5).

Profiling: :func:`trace_profile` wraps a block in a ``torch.profiler``
trace of the host and, where there is one, the card (the reference's PL
'simple' profiler analogue, SURVEY §5.1), written as a Chrome trace with
the program's own spans beside the profiler's events.

Tracing: :data:`TRACER` holds the serving path's spans and samples.
Spans (``with TRACER.span("name"):``) mark the layer boundaries of a
dispatch or a request and are recorded only while a ``torch.profiler``
session records; outside one a span costs one attribute read and enters
a shared no-op context. Samples (``TRACER.sample``) are the few values
that health checks and metrics read over a whole run (a query's wait in
the front end's queue, the CE rows an engine call scores and how many of
them pad the batch); they are always recorded, each in a bounded ring.
Device counters (``TRACER.device_counter``) are integer tensors on the
card that the program adds to inside its forwards, with no host sync (rows
each expert computed, per layer); they are read after the work
(``read_counter``), never inside it.
Spans never enter the device timeline (no ``record_function``, no NVTX
range), so a profile's device operations are the same with or without
them. Both stay in memory; nothing is written while the program runs.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import threading
import time
from typing import Any, Deque, Dict, List, NamedTuple, Optional, Tuple

from torch.autograd import profiler as _autograd_profiler

LOGGER = logging.getLogger(__name__)


class ExperimentTracker:
    def __init__(
        self,
        run_dir: str,
        project: str = "anncur_tpu",  # the JAX package's project name: one dashboard
        config: Optional[Dict] = None,
        use_wandb: bool = False,
    ):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.metrics_path = os.path.join(run_dir, "metrics.jsonl")
        self._t0 = time.time()
        self._step = 0
        self._wandb = None
        if config:
            with open(os.path.join(run_dir, "tracker_config.json"), "w") as fout:
                json.dump(config, fout, indent=2, default=str)
        if use_wandb:
            self._wandb = self._try_wandb(project, run_dir, config)

    @staticmethod
    def _try_wandb(project, run_dir, config):
        """online -> offline -> disabled fallback chain (reference
        behavior, pairwise_trainer.py:183-189)."""
        try:
            import wandb  # noqa

            for mode in ("online", "offline"):
                try:
                    run = wandb.init(project=project, dir=run_dir, config=config, mode=mode)
                    LOGGER.info("wandb attached (mode=%s)", mode)
                    return run
                except Exception:
                    continue
        except ImportError:
            pass
        LOGGER.info("wandb unavailable; tracking to %s only", run_dir)
        return None

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        step = self._step if step is None else step
        self._step = step + 1
        rec = {"step": step, "time": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()})
        with open(self.metrics_path, "a") as fout:
            fout.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            try:
                self._wandb.log(metrics, step=step)
            except Exception:
                pass

    def progress(self, name: str, frac: float) -> None:
        """Progress-fraction stream (reference 'frac_done'/'eval_ctr_frac'
        logging)."""
        self.log({f"{name}_frac": round(frac, 4)})

    def alert(self, message: str) -> None:
        LOGGER.error("ALERT: %s", message)
        self.log({"alert": message})

    def finish(self) -> None:
        if self._wandb is not None:
            try:
                self._wandb.finish()
            except Exception:
                pass


class Span(NamedTuple):
    """One recorded span, stamped on ``time.time_ns`` (the clock the
    profiler stamps its host and device events on)."""

    name: str
    start_ns: int
    end_ns: int
    seq: int  # unique per span of the tracer
    parent: Optional[int]  # ``seq`` of the span open on the same thread when this one opened
    thread: int  # the thread's native id (the profiler's ``tid``)
    trace_id: int  # shared by every span of one dispatch or request


class Sample(NamedTuple):
    """One value, with the stretch of time it is about on ``time.time_ns``."""

    start_ns: int
    end_ns: int
    value: float


# the span entered while no profiler session records
_NO_SPAN = contextlib.nullcontext()
# spans kept, the newest (a profiled stretch of a serving run records
# hundreds a second)
SPAN_CAPACITY = 1 << 16
# samples kept a name, the newest
SAMPLE_CAPACITY = 4096


class _OpenSpan:
    __slots__ = ("_tracer", "_name", "_trace_id", "_seq", "_parent", "_start", "_stack", "_thread")

    def __init__(self, tracer: "Tracer", name: str, trace_id: Optional[int]):
        self._tracer, self._name, self._trace_id = tracer, name, trace_id

    def __enter__(self):
        stack, self._thread = self._tracer._thread()
        self._stack = stack
        outer = stack[-1] if stack else None
        self._parent = None if outer is None else outer._seq
        if self._trace_id is None:
            self._trace_id = next(self._tracer._trace_ids) if outer is None else outer._trace_id
        self._seq = next(self._tracer._seqs)
        stack.append(self)
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._stack.pop()
        self._tracer._add_span(Span(self._name, self._start, end, self._seq, self._parent, self._thread,
                                    self._trace_id))
        return False


class Tracer:
    """Spans at the layer boundaries of the program and samples over a run
    (module doc). One tracer serves the process, as one profiler does: the
    spans of a profiled stretch come from every thread that runs the
    program. Readers take copies (:meth:`spans`, :meth:`samples`) and keep
    what lies in the time they look at."""

    def __init__(self):
        self._spans: Deque[Span] = collections.deque(maxlen=SPAN_CAPACITY)
        self._samples: Dict[str, Deque[Sample]] = {}
        self._counters: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._seqs = itertools.count()
        self._trace_ids = itertools.count()

    def span(self, name: str, trace_id: Optional[int] = None):
        """A context that records a span named ``name`` while a
        ``torch.profiler`` session records (the gate is read once, here).
        A span opened inside another on its thread takes its trace id;
        an outermost one takes ``trace_id`` or a fresh number."""
        if not _autograd_profiler._is_profiler_enabled:
            return _NO_SPAN
        return _OpenSpan(self, name, trace_id)

    def sample(self, name: str, value: float, start_ns: int, end_ns: Optional[int] = None) -> None:
        """Record ``value`` under ``name`` (always on; the ring keeps the
        newest ``SAMPLE_CAPACITY``)."""
        item = Sample(start_ns, start_ns if end_ns is None else end_ns, value)
        with self._lock:
            ring = self._samples.get(name)
            if ring is None:
                ring = self._samples[name] = collections.deque(maxlen=SAMPLE_CAPACITY)
            ring.append(item)

    def device_counter(self, name: str, shape: Tuple[int, ...], device) -> "torch.Tensor":
        """The int64 counter ``name`` of ``shape`` on ``device``, zeros when
        first asked for (or asked for with another shape or device). The
        program adds to it on the device; nothing here reads it."""
        import torch

        device = torch.device(device)
        with self._lock:
            cur = self._counters.get(name)
            if cur is None or tuple(cur.shape) != tuple(shape) or cur.device.type != device.type \
                    or (device.index is not None and cur.device.index != device.index):
                cur = self._counters[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            return cur

    def read_counter(self, name: str) -> Optional["torch.Tensor"]:
        """A host copy of the counter ``name`` (waits for the device), or
        None where the program made none."""
        with self._lock:
            cur = self._counters.get(name)
        return None if cur is None else cur.cpu()

    def reset_counter(self, name: str) -> None:
        """Zero the counter ``name``, where there is one."""
        with self._lock:
            cur = self._counters.get(name)
        if cur is not None:
            cur.zero_()

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def samples(self, name: str) -> List[Sample]:
        with self._lock:
            return list(self._samples.get(name, ()))

    def _thread(self) -> Tuple[List[_OpenSpan], int]:
        """This thread's stack of open spans, and its native id: read once
        a thread, since on some hosts the system call behind it costs
        more than a millisecond, far more than the rest of a span."""
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.native_id = [], threading.get_native_id()
        return local.stack, local.native_id

    def _add_span(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)


TRACER = Tracer()


@contextlib.contextmanager
def trace_profile(log_dir: Optional[str], enabled: bool = True):
    """``torch.profiler`` trace context; the trace is written to
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing). The
    program's spans recorded during the session (:data:`TRACER`) are added
    to it as complete events on the host track of the thread that ran
    them, on the trace's own clock, so they sit beside the operators and
    the device timeline they enclose."""
    if not enabled or not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    t1 = time.time_ns()
    prof.export_chrome_trace(path)
    _add_spans_to_chrome_trace(path, [s for s in TRACER.spans() if s.start_ns >= t0 and s.end_ns <= t1])
    LOGGER.info("profile trace written to %s", log_dir)


def _add_spans_to_chrome_trace(path: str, spans: List[Span]) -> None:
    """Append ``spans`` to a Chrome trace as complete ("X") events: ``ts``
    and ``dur`` in microseconds from the trace's ``baseTimeNanoseconds``."""
    with open(path) as fin:
        trace = json.load(fin)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    trace.setdefault("traceEvents", []).extend(
        {
            "ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.thread,
            "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"trace_id": s.trace_id, "seq": s.seq, "parent": s.parent},
        }
        for s in spans
    )
    with open(path, "w") as fout:
        json.dump(trace, fout)
