"""The readers of the port's tracer: the queue wait's and the CE padding's
window filter, and the device idle time that begins inside a program span;
each gives None for a program without the tracer."""

import sys
import time
import types
from types import SimpleNamespace

import pytest

from cebench.lib.harness import Run
from cebench.lib.trace import DeviceTrace
from cebench.metrics import ce_pad_share, host_bound_idle, queue_wait_p95_ms
from anncur_tpu_torch.utils.tracker import Span, Tracer

MS = 1_000_000


@pytest.fixture
def tracer(monkeypatch):
    trc = Tracer()
    for mod in (queue_wait_p95_ms, ce_pad_share, host_bound_idle):
        monkeypatch.setattr(mod, "tracer", lambda: trc)
    return trc


def _run():
    """A fixed-cell run whose 10 s window opened now, its sub-window traced
    from 2 s to 4 s; and the window's start on ``time.time_ns``."""
    run = Run("ce-yugioh.fixed-c600.open", 1, 10.0, False, "cpu")
    run.window_start = time.perf_counter()
    run.deadline = run.window_start + 10.0
    run.traced_span = (run.window_start + 2.0, run.window_start + 4.0)
    return run, int(run.window_start * 1e9) + time.time_ns() - time.perf_counter_ns()


def test_queue_wait_keeps_the_window_and_drops_waits_over_the_traced_span(tracer):
    run, w = _run()
    kept = [(100 * MS, 50), (1500 * MS, 200), (6000 * MS, 30), (9000 * MS, 80)]
    dropped = [
        (-100 * MS, 900),  # queued before the window
        (1900 * MS, 400),  # its wait runs into the traced span
        (3000 * MS, 10),  # inside it
        (3900 * MS, 500),  # out of it
        (4100 * MS, 700),  # after it, behind the backlog its end left
        (4400 * MS, 300),
        (10_100 * MS, 5),  # queued after the deadline
    ]
    # the first query after the traced span that is taken at once: the
    # backlog has drained, and from here on waits count
    kept.append((5000 * MS, 0.2))
    for t, wait_ms in kept + dropped:
        tracer.sample("serve.queue_wait", int(wait_ms * MS), w + t, w + t + int(wait_ms * MS))
    waits = sorted(x.value / MS for x in queue_wait_p95_ms.kept_waits(run, tracer.samples("serve.queue_wait")))
    assert waits == sorted(ms for _, ms in kept)
    # the 95th percentile of 0.2, 30, 50, 80, 200 by linear interpolation
    assert queue_wait_p95_ms.read(run, "queue_wait_p95_ms.fixed") == pytest.approx(80 + 0.8 * 120)


def test_queue_wait_without_a_quiet_query_after_the_traced_span_keeps_the_waits_before_it(tracer):
    run, w = _run()
    for t, wait_ms in [(100, 40), (1000, 60), (4500, 300), (8000, 250)]:
        tracer.sample("serve.queue_wait", wait_ms * MS, w + t * MS, w + (t + wait_ms) * MS)
    assert queue_wait_p95_ms.read(run, "queue_wait_p95_ms.fixed") == pytest.approx(40 + 0.95 * 20)


def test_ce_pad_share_leaves_out_the_calls_the_traced_span_disturbed(tracer):
    run, w = _run()
    # the queue drained at 5 s: the first query after the traced span
    # (2-4 s) that was taken at once
    for t, wait_ms in [(4300, 400), (5000, 0.2), (7000, 30)]:
        tracer.sample("serve.queue_wait", int(wait_ms * MS), w + t * MS, w + t * MS + int(wait_ms * MS))
    # (start ms, pairs, pad pairs) of each engine call, 100 ms long
    calls = {
        "before the window": (-500, 9600, 4200),
        "kept, before the traced span": (500, 4800, 0),
        "runs into the traced span": (1950, 9600, 4200),
        "inside it": (2500, 4800, 0),
        "after it, serving its backlog": (4200, 9600, 4200),
        "kept, once the queue drained": (5000, 600, 0),
        "kept, later": (7000, 9600, 4200),
        "after the deadline": (10_500, 600, 0),
    }
    for t, pairs, pad in calls.values():
        tracer.sample("ce.pairs", pairs, w + t * MS, w + (t + 100) * MS)
        tracer.sample("ce.pad_pairs", pad, w + t * MS, w + (t + 100) * MS)
    kept = [v for k, v in calls.items() if k.startswith("kept")]
    share = ce_pad_share.read(run, "ce_pad_share.fixed")
    assert share == pytest.approx(100.0 * sum(p for *_, p in kept) / sum(n for _, n, _ in kept))
    assert share == pytest.approx(100.0 * 4200 / (4800 + 600 + 9600))
    # a run that traced nothing counts every call of the window
    run.traced_span = None
    assert ce_pad_share.read(run, "ce_pad_share.fixed") == pytest.approx(
        100.0 * (4200 * 3) / (4800 + 9600 + 4800 + 9600 + 600 + 9600))


def test_host_bound_idle_counts_idle_time_inside_program_spans(tracer, capsys, monkeypatch):
    t0 = 1_000 * MS
    # device busy 0-10, 20-30, 60-70, 90-100 ms of a 100 ms sub-window,
    # idle 10-20, 30-60 and 70-90. Spans: a dispatch from -5 to 35 holding
    # "fixed.anchor" 5-22; a dispatch from 65 holding "fixed.rerank" 66-95.
    # Counted: 10-20 (fixed.anchor), 30-35 (the first dispatch, after its
    # last copy; 35-60 the queue was empty), 70-90 (fixed.rerank)
    ops = [("k", t0 + a * MS, t0 + b * MS) for a, b in [(0, 10), (20, 30), (60, 70), (90, 100)]]
    trace = DeviceTrace(ops, t0, t0 + 100 * MS)

    def span(name, a, b, seq, parent=None):
        return Span(name, t0 + a * MS, t0 + b * MS, seq, parent, 1, 0)

    for s in [span("serve.dispatch", -5, 35, 0), span("fixed.anchor", 5, 22, 1, 0),
              span("serve.dispatch", 65, 100, 2), span("fixed.rerank", 66, 95, 3, 2)]:
        tracer._add_span(s)
    assert host_bound_idle.idle_by_span(trace, tracer.spans()) == {
        "fixed.anchor": pytest.approx(0.010), "serve.dispatch": pytest.approx(0.005),
        "fixed.rerank": pytest.approx(0.020)}
    run = SimpleNamespace(profiler=SimpleNamespace(trace=trace))
    value = host_bound_idle.read(run, "host_bound_idle.fixed")
    assert value == pytest.approx(35.0)
    # a part of the device's idle share (60% here)
    assert value <= 100.0 * (1 - trace.busy_s / trace.window_s)
    err = capsys.readouterr().err
    assert "fixed.rerank 0.020000" in err and "fixed.anchor 0.010000" in err and "serve.dispatch 0.005000" in err
    # no span recorded in the sub-window: nothing to read
    empty = Tracer()
    monkeypatch.setattr(host_bound_idle, "tracer", lambda: empty)
    assert host_bound_idle.read(run, "host_bound_idle.fixed") is None


def test_readers_give_none_for_a_program_without_the_tracer(monkeypatch):
    monkeypatch.setitem(sys.modules, "anncur_tpu_torch.utils.tracker", types.ModuleType("anncur_tpu_torch.utils.tracker"))
    run, _ = _run()
    trace = DeviceTrace([("k", 0, 10)], 0, 100)
    run.profiler = SimpleNamespace(trace=trace)
    assert queue_wait_p95_ms.tracer() is None
    assert queue_wait_p95_ms.read(run, "queue_wait_p95_ms.fixed") is None
    assert ce_pad_share.read(run, "ce_pad_share.fixed") is None
    assert host_bound_idle.read(run, "host_bound_idle.fixed") is None
