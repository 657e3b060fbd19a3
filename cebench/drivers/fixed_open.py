"""Fixed-anchor serving under an open loop of single-query requests.

Requests arrive at a fixed mean rate with exponential gaps: the
exponential's quantiles at the rate, in one order that the traffic file
fixes (``arrival_order_seed``). Every seed replays that schedule with its
own query tokens and weights: the tail of an open loop turns on which
arrivals bunch, so a schedule drawn per seed would move the tail with the
seed rather than with the program (PERF.md has the readings).

Each request is one thread that submits its query to the port's
``Coalescer`` (``cli/serve.py``) and waits; the coalescer's worker hands
whatever is queued, up to ``batch``, to one dispatch, which calls
``CurRetriever.query_tokens_batch`` as the serving CLI's ``answer`` does.
A request is timed from when it was due to when its answer is back on
the host.
"""

from __future__ import annotations

import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from cebench.lib import checks, models, reference, world
from cebench.lib.yardstick import percentile, seq_flops


def arrivals(n: int, rate: float, order_seed: int) -> np.ndarray:
    """(n,) due times in seconds from the window's start: the exponential's
    n mid-quantiles at ``rate`` as gaps, in the order ``order_seed`` gives."""
    p = (np.arange(n) + 0.5) / n
    return np.cumsum(np.random.default_rng(order_seed).permutation(-np.log1p(-p) / rate))


def setup(run):
    from anncur_tpu_torch.cli.serve import Coalescer

    prm, dep = run.params, run.cfg["deployment"]
    ce, tree = models.make_ce(run)
    items = models.make_items(run)
    train = models.make_train(run)
    retriever = models.make_retriever(run, ce, items, train)
    n_req = int(round(prm["rate_qps"] * run.seconds))
    queries = models.make_mentions(run, n_req, "queries")
    st = SimpleNamespace(
        ce=ce, tree=tree, items=items, train=train, retriever=retriever, queries=queries,
        queries_np=queries.cpu().numpy(), due=arrivals(n_req, prm["rate_qps"], prm["arrival_order_seed"]),
        dispatches=[], done=np.full(n_req, np.nan), answers={}, errors=[], Coalescer=Coalescer,
        anchors=np.asarray(retriever.anchor_item_ids),
    )
    with run.spans.span("setup.warmup"):
        for q in prm["warmup_batches"]:
            retriever.query_tokens_batch(st.queries_np[:q], top_k=prm["top_k"], top_k_retvr=prm["top_k_retvr"])
    run.counters.clear()
    return st


def _dispatch(run, st, prm):
    def dispatch(qids, toks):
        run.trace_tick()
        t0 = time.perf_counter()
        first = len(run.launches.captured)
        with run.spans.span("coalescer.dispatch"):
            scores, ids = st.retriever.query_tokens_batch(
                np.asarray(toks, np.int32), top_k=prm["top_k"], top_k_retvr=prm["top_k_retvr"])
        st.dispatches.append((list(qids), first, t0, time.perf_counter()))
        return [(s, i) for s, i in zip(scores, ids)]
    return dispatch


def window(run, st):
    prm = run.params
    coalescer = st.Coalescer(_dispatch(run, st, prm), prm["batch"], prm["coalesce_ms"] / 1e3, threading.Lock())
    run.launches.capturing = True

    def request(i):
        try:
            rows = coalescer.submit([i], [st.queries_np[i]])
            st.done[i] = time.perf_counter()
            st.answers[i] = rows[0]
        except Exception as exc:  # noqa: BLE001 — a failed request is counted, not raised
            st.errors.append((i, repr(exc)))

    threads, late = [], []
    with run.spans.span("generator"):
        for i, due in enumerate(st.due):
            t_due = run.window_start + due
            wait = t_due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(time.perf_counter() - t_due)
            th = threading.Thread(target=request, args=(i,), daemon=True)
            th.start()
            threads.append(th)
    give_up = run.deadline + prm["drain_s"]
    for th in threads:
        th.join(timeout=max(0.0, give_up - time.perf_counter()))
    run.close_trace()
    coalescer.stop()
    run.launches.capturing = False
    stuck = [i for i, th in enumerate(threads) if th.is_alive()]
    due_abs = run.window_start + st.due
    lat = np.where(np.isnan(st.done), give_up, st.done) - due_abs
    run.attempted = len(st.due)
    run.failed = len(st.errors) + len(stuck)
    run.e2e["query_p95_ms"] = percentile(lat * 1e3, 95)
    cfg = run.cfg
    flop = (prm["top_k_retvr"] + len(st.anchors)) * seq_flops(
        cfg["hidden_size"], cfg["num_hidden_layers"], cfg["intermediate_size"], models.pair_len(cfg))
    run.counters.update(
        queries=int(np.isfinite(st.done).sum()), dispatches=coalescer.n_dispatches, coalesced=coalescer.n_queries,
        generator_late_p95_ms=percentile(np.asarray(late) * 1e3, 95),
    )
    run.model_work([(t0, t1, len(qids) * flop) for qids, _, t0, t1 in st.dispatches], closed=False)
    print(f"cebench: the generator ran late by {run.counters['generator_late_p95_ms']:.3f} ms at p95, "
          f"{max(late) * 1e3:.3f} ms at most", file=sys.stderr)


def release(run, st):
    st.retriever = st.ce = None


def answers(st, captured, qids):
    """The program's answers of requests ``qids``: each one's anchor scores
    and candidates from its dispatch's kernel B launch, with what it
    returned."""
    where = {}
    for qlist, first, _, _ in st.dispatches:
        for row, q in enumerate(qlist):
            where[q] = (first, row)
    out = []
    for q in qids:
        first, row = where[q]
        a_scores, cands, c_scores = captured[first]
        scores, ids = st.answers[q]
        out.append(checks.FixedAnswer(q, a_scores[row], cands[row], c_scores[row], np.asarray(scores), np.asarray(ids)))
    return out


def check(run, st):
    prm, dep = run.params, run.cfg["deployment"]
    done = [q for q in range(len(st.due)) if q in st.answers]
    rng = np.random.default_rng(world.subseed(run.seed, "check"))
    qids = sorted(rng.choice(done, size=min(prm["check_requests"], len(done)), replace=False).tolist()) if done else []
    anchor_sample = np.sort(rng.choice(dep["n_anchor_items"], size=prm["check_anchors"], replace=False))
    latent = reference.cur_latent(st.train.cpu().numpy(), st.anchors)
    gaps = checks.fixed_gaps(st.tree, run.cfg, models.pair_len(run.cfg), st.queries, st.items, latent,
                             st.anchors, answers(st, run.launches.captured, qids), anchor_sample)
    for name, value in gaps.items():
        run.check(name, value)
    run.check("unanswered", len(st.due) - len(done), 0)


def control(run):
    """The control's numbers: the path computed by the reference one
    precision lower, on the requests and anchors a run's check samples."""
    prm, dep, cfg = run.params, run.cfg["deployment"], run.cfg
    tree = world.ce_weights(cfg, run.seed, run.device)
    items = models.make_items(run)
    train = models.make_train(run)
    n_items, k_i = dep["n_items"], dep["n_anchor_items"]
    # the anchor draw CurRetriever.build makes from the seed it is given
    anchors = np.asarray(sorted(np.random.default_rng(world.subseed(run.seed, "anchors")).choice(
        n_items, size=k_i, replace=False)))
    n_req = int(round(prm["rate_qps"] * run.seconds))
    queries = models.make_mentions(run, n_req, "queries")
    rng = np.random.default_rng(world.subseed(run.seed, "check"))
    qids = sorted(rng.choice(n_req, size=min(prm["check_requests"], n_req), replace=False).tolist())
    anchor_sample = np.sort(rng.choice(k_i, size=prm["check_anchors"], replace=False))
    latent = reference.cur_latent(train.cpu().numpy(), anchors)
    latent_f32 = torch.as_tensor(latent.T, dtype=torch.float32, device=run.device).contiguous()
    pl = models.pair_len(cfg)
    answers = checks.reference_fixed(tree, cfg, pl, queries, items, latent_f32, anchors, qids, prm["top_k_retvr"],
                                     prm["top_k"], reference.CONTROL_CE, reference.CONTROL_MIPS)
    return checks.fixed_gaps(tree, cfg, pl, queries, items, latent, anchors, answers, anchor_sample)
