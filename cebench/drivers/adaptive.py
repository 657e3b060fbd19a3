"""The adaptive engine's batch throughput: closed-loop batches of
``batch`` queries through the port's
``CurRetriever.query_tokens_adaptive_fused`` (CUR completion over the
index's own train matrix, ``budget`` CE calls over ``rounds`` rounds, top
``top_k``), back to back, cycling through a pool of distinct batches.

The check follows the engine from its own state: the harness wraps the
port's ``CurCompleter.queries`` to keep each round's scored ids and
scores, and kernel B's wrapper keeps each round's picks.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import torch

from cebench.lib import checks, models, reference, world
from cebench.lib.yardstick import rate_over_window, seq_flops


def _capture_completer(run, st):
    """Keep (ids, vals) of every ``CurCompleter.queries`` call while the
    run captures; the original still computes the weights."""
    from anncur_tpu_torch.core import adaptive_fused

    original = adaptive_fused.CurCompleter.queries

    @functools.wraps(original)
    def queries(self, ids, vals):
        if run.launches.capturing:
            st.completer.append((ids, vals))
        return original(self, ids, vals)

    adaptive_fused.CurCompleter.queries = queries


def _call(run, st, toks):
    prm = run.params
    return st.retriever.query_tokens_adaptive_fused(
        toks, total_budget=prm["budget"], n_rounds=prm["rounds"], top_k=prm["top_k"], seed=st.engine_seed,
        ridge_rel=prm["ridge_rel"], method="cur")


def setup(run):
    prm, dep = run.params, run.cfg["deployment"]
    ce, tree = models.make_ce(run)
    items = models.make_items(run)
    train = models.make_train(run)
    retriever = models.make_retriever(run, ce, items, train)
    n = prm["batch"]
    queries = models.make_mentions(run, prm["pool_batches"] * n, "queries")
    st = SimpleNamespace(ce=ce, tree=tree, items=items, train=train, retriever=retriever, queries=queries,
                         queries_np=queries.cpu().numpy(), anchors=np.asarray(retriever.anchor_item_ids),
                         engine_seed=world.subseed(run.seed, "engine"), calls=[], out=[], completer=[])
    _capture_completer(run, st)
    with run.spans.span("setup.warmup"):
        _call(run, st, st.queries_np[:n])
    run.counters.clear()
    return st


def window(run, st):
    prm = run.params
    n = prm["batch"]
    run.launches.capturing = True
    b = 0
    while run.now() < run.deadline:
        run.trace_tick()
        first = (len(st.completer), len(run.launches.captured))
        row0 = (b % prm["pool_batches"]) * n
        t0 = run.now()
        with run.spans.span("adaptive.batch"):
            scores, ids = _call(run, st, st.queries_np[row0:row0 + n])
        st.calls.append((t0, run.now(), n))
        st.out.append((row0, first, scores, ids))
        b += 1
    run.launches.capturing = False
    run.e2e["query_qps"] = rate_over_window(st.calls, run.window_start, run.deadline)
    cfg = run.cfg
    answered = sum(w for _, _, w in st.calls)
    run.attempted = answered
    run.counters.update(queries=answered, batches=len(st.calls))
    flop = prm["budget"] * seq_flops(cfg["hidden_size"], cfg["num_hidden_layers"], cfg["intermediate_size"],
                                     models.pair_len(cfg))
    run.model_work([(t0, t1, w * flop) for t0, t1, w in st.calls], closed=True)


def release(run, st):
    st.retriever = st.ce = None


def answers(run, st, picks):
    """The engine's answers of (batch, row) ``picks``, round by round."""
    n_rounds = run.params["rounds"] - 1
    out = []
    for b, j in picks:
        row0, (c0, k0), scores, ids = st.out[b]
        rounds = []
        for r in range(n_rounds):
            r_ids, r_vals = st.completer[c0 + r]
            weights, nid, nid_scores = run.launches.captured[k0 + r]
            rounds.append((r_ids[j], r_vals[j], weights[j], nid[j], nid_scores[j]))
        out.append(checks.AdaptiveAnswer(row0 + j, rounds, np.asarray(scores[j]), np.asarray(ids[j])))
    return out


def train_reference(train: torch.Tensor, anchors: np.ndarray) -> torch.Tensor:
    """(n_items, k_q) f64: the train matrix the index reconstructs, C U R
    with C = R[:, anchors] and U its cut pseudoinverse, held transposed."""
    r = train.double()
    latent = torch.as_tensor(reference.cur_latent(train.cpu().numpy(), anchors), device=train.device)
    return (r[:, torch.as_tensor(anchors, device=train.device)] @ latent).T.contiguous()


def check(run, st):
    prm = run.params
    rng = np.random.default_rng(world.subseed(run.seed, "check"))
    rows = [(b, j) for b in range(len(st.out)) for j in range(prm["batch"])]
    picks = [rows[i] for i in sorted(rng.choice(len(rows), size=min(prm["check_queries"], len(rows)), replace=False))]
    gaps = checks.adaptive_gaps(st.tree, run.cfg, models.pair_len(run.cfg), st.queries, st.items,
                                train_reference(st.train, st.anchors), prm["ridge_rel"], prm["budget"],
                                answers(run, st, picks))
    for name, value in gaps.items():
        run.check(name, value)


def control(run):
    """The control's numbers: the engine computed by the reference one
    precision lower, on as many queries as a run checks."""
    prm, dep, cfg = run.params, run.cfg["deployment"], run.cfg
    tree = world.ce_weights(cfg, run.seed, run.device)
    items = models.make_items(run)
    train = models.make_train(run)
    n_items = dep["n_items"]
    anchors = np.asarray(sorted(np.random.default_rng(world.subseed(run.seed, "anchors")).choice(
        n_items, size=dep["n_anchor_items"], replace=False)))
    queries = models.make_mentions(run, prm["pool_batches"] * prm["batch"], "queries")
    # round 0's shared anchors: the draw the engine makes from the seed it is given
    n_rounds = max(1, min(prm["rounds"], prm["budget"]))
    first = prm["budget"] - (prm["budget"] // n_rounds) * (n_rounds - 1)
    anchors0 = np.asarray(sorted(np.random.default_rng(world.subseed(run.seed, "engine")).choice(
        n_items, size=first, replace=False)))
    rng = np.random.default_rng(world.subseed(run.seed, "check"))
    qids = sorted(rng.choice(queries.shape[0], size=prm["check_queries"], replace=False).tolist())
    train_t = train_reference(train, anchors)
    pl = models.pair_len(cfg)
    answers = checks.reference_adaptive(tree, cfg, pl, queries, items, train_t, anchors0, qids, prm["budget"],
                                        prm["rounds"], prm["top_k"], prm["ridge_rel"], reference.CONTROL_CE,
                                        reference.CONTROL_MIPS)
    return checks.adaptive_gaps(tree, cfg, pl, queries, items, train_t, prm["ridge_rel"], prm["budget"], answers)
