"""The port's tracer (``utils/tracker.py``): spans only while a
``torch.profiler`` session records, samples always; the front end's queue
wait, the engine's CE padding, and the spans of the serving path (CPU)."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from anncur_tpu_torch.cli.serve import Coalescer, traced_health
from anncur_tpu_torch.core.retriever import CurRetriever
from anncur_tpu_torch.data.synthetic import make_tokenized_world
from anncur_tpu_torch.evalx.retrieve_rerank import embed_tokenized
from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.biencoder import BiEncoder
from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer
from anncur_tpu_torch.ops.dense_index import DenseIndex
from anncur_tpu_torch.utils import tracker
from anncur_tpu_torch.utils.tracker import TRACER, Tracer

torch.set_num_threads(2)  # xdist runs several test files side by side

K_I, TOP_K_RETVR = 6, 5  # anchors and reranked candidates of the tiny retriever


def _since(t0_ns, name=None):
    """The tracer's spans (or ``name``'s samples) that started at or after ``t0_ns``."""
    items = TRACER.spans() if name is None else TRACER.samples(name)
    return [s for s in items if s.start_ns >= t0_ns]


def test_no_span_outside_a_profiler_session_but_samples_are_kept():
    tracer = Tracer()
    with tracer.span("outer"):
        with tracer.span("inner"):
            pass
    tracer.sample("serve.queue_wait", 5, 10, 15)
    assert tracer.spans() == []
    assert [tuple(s) for s in tracer.samples("serve.queue_wait")] == [(10, 15, 5)]
    # shut, every span is the one shared no-op context
    assert tracer.span("a") is tracer.span("b")


def test_sample_rings_are_bounded(monkeypatch):
    monkeypatch.setattr(tracker, "SAMPLE_CAPACITY", 3)
    tracer = Tracer()
    for i in range(5):
        tracer.sample("x", i, i)
    assert [s.value for s in tracer.samples("x")] == [2, 3, 4]
    assert tracer.samples("never") == []


def test_spans_inside_a_session_carry_parent_thread_and_shared_id():
    tracer = Tracer()
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        with tracer.span("dispatch", trace_id=41):
            with tracer.span("stage"):
                with tracer.span("forward"):
                    pass
            with tracer.span("stage2"):
                pass
        with tracer.span("other"):
            pass

        def elsewhere():
            with tracer.span("thread"):
                pass

        th = threading.Thread(target=elsewhere)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        t1 = time.time_ns()
    by = {s.name: s for s in tracer.spans()}
    assert set(by) == {"dispatch", "stage", "forward", "stage2", "other", "thread"}
    assert by["dispatch"].parent is None and by["dispatch"].trace_id == 41
    assert by["stage"].parent == by["dispatch"].seq and by["stage2"].parent == by["dispatch"].seq
    assert by["forward"].parent == by["stage"].seq
    assert {by[n].trace_id for n in ("stage", "forward", "stage2")} == {41}
    # an outermost span without an id takes a fresh one, on its own thread too
    assert by["other"].parent is None and by["other"].trace_id != 41
    assert by["thread"].parent is None and by["thread"].trace_id not in (41, by["other"].trace_id)
    main = threading.get_native_id()
    assert {by[n].thread for n in by if n != "thread"} == {main} and by["thread"].thread != main
    for s in by.values():
        assert t0 <= s.start_ns <= s.end_ns <= t1
    assert by["dispatch"].start_ns <= by["stage"].start_ns <= by["forward"].start_ns
    assert by["forward"].end_ns <= by["stage"].end_ns <= by["stage2"].start_ns <= by["dispatch"].end_ns
    # the session's end shuts the gate again
    with tracer.span("after"):
        pass
    assert "after" not in {s.name for s in tracer.spans()}


def test_spans_stay_out_of_the_profilers_events():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TRACER.span("serve.dispatch"):
            torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert "aten::ones" in names and "serve.dispatch" not in names


def test_a_queued_query_waits_for_the_dispatch_before_it():
    hold = 0.2

    def dispatch(queries, toks):
        time.sleep(hold)
        return [q * 10 for q in queries]

    t0 = time.time_ns()
    co = Coalescer(dispatch, batch=1, window_s=0.0, device_lock=threading.Lock())
    try:
        # one request of two queries: the second waits for the first's dispatch
        assert co.submit([1, 2], [None, None]) == [10, 20]
    finally:
        co.stop()
    assert not co._worker.is_alive()
    # in the order the worker took them: the first query, then the second
    waits = dict(enumerate(_since(t0, "serve.queue_wait"), 1))
    assert set(waits) == {1, 2}
    assert waits[2].value >= hold * 1e9 and waits[2].value == waits[2].end_ns - waits[2].start_ns
    assert waits[1].value < hold * 1e9
    assert traced_health()["queue_wait_ms"]["p95"] > 0


def test_coalescer_dispatch_span_holds_the_dispatch():
    co = Coalescer(lambda queries, toks: list(queries), batch=4, window_s=0.0, device_lock=threading.Lock())
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            t0 = time.time_ns()
            assert co.submit([7], [None]) == [7]
    finally:
        co.stop()
    spans = [s for s in _since(t0) if s.name == "serve.dispatch"]
    assert len(spans) == 1 and spans[0].trace_id == co.n_dispatches


@pytest.fixture(scope="module")
def retriever():
    ment, ent, _, tok = make_tokenized_world(seed=5, n_ents=24, n_ments=12, max_ment_len=16, max_ent_len=16)
    spec = BertSpec.tiny(vocab_size=tok.vocab_size, max_position_embeddings=64)
    ce = CrossEncoder(spec, compute_dtype=torch.float32, device="cpu", seed=1)
    builder = ScoreMatrixBuilder(ce, ment_block=4, ent_block=8, pair_pad_multiple=32, device="cpu")
    # 8 queries per anchor forward, as 4096 // 500 gives at cost 600
    r = CurRetriever.build(ce, WordPieceTokenizer(tok.vocab), ment[:8], ent, n_anchor_items=K_I, builder=builder,
                           max_query_len=16, seed=3, device="cpu", target_pairs_per_step=8 * K_I)
    return r, ment, ent


@pytest.mark.parametrize("q, pad_queries", [(9, 7), (8, 0), (3, 0)])
def test_fixed_path_counts_ce_rows_and_padding(retriever, q, pad_queries):
    r, ment, _ = retriever
    t0 = time.time_ns()
    r.query_tokens_batch(np.resize(ment, (q, ment.shape[1])), top_k=3, top_k_retvr=TOP_K_RETVR)
    pairs, pad = _since(t0, "ce.pairs"), _since(t0, "ce.pad_pairs")
    assert len(pairs) == len(pad) == 1
    assert pad[0].value == pad_queries * (K_I + TOP_K_RETVR)
    assert pairs[0].value == (q + pad_queries) * (K_I + TOP_K_RETVR)
    assert pairs[0].start_ns >= t0 and pairs[0].end_ns >= pairs[0].start_ns


@pytest.fixture
def handed(monkeypatch):
    """Rows of every ``CrossEncoder.score`` call, as the caller hands them."""
    rows = []
    score = CrossEncoder.score

    def counted(self, pair_token_ids, *a, **kw):
        rows.append(int(np.shape(pair_token_ids)[0]))
        return score(self, pair_token_ids, *a, **kw)

    monkeypatch.setattr(CrossEncoder, "score", counted)
    return rows


def test_fixed_path_rows_equal_the_rows_the_ce_is_handed(retriever, handed):
    r, ment, _ = retriever
    t0 = time.time_ns()
    r.query_tokens_batch(ment[:9], top_k=3, top_k_retvr=TOP_K_RETVR)
    assert _since(t0, "ce.pairs")[0].value == sum(handed) == 16 * (K_I + TOP_K_RETVR)


def test_fixed_path_spans_nest_under_the_dispatch(retriever):
    r, ment, _ = retriever
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        with TRACER.span("serve.dispatch", trace_id=7):
            r.query_tokens_batch(ment[:9], top_k=3, top_k_retvr=TOP_K_RETVR)
    spans = [s for s in _since(t0) if s.trace_id == 7]
    by_seq = {s.seq: s for s in spans}
    stages = ["fixed.pad", "fixed.anchor", "fixed.retrieve", "fixed.rerank", "fixed.to_host"]
    top = [s for s in spans if s.parent is not None and by_seq[s.parent].name == "serve.dispatch"]
    assert [s.name for s in sorted(top, key=lambda s: s.start_ns)] == stages
    forwards = [s for s in spans if s.name == "ce.forward"]
    # 16 padded queries: two anchor forwards of 8, and the rerank's
    assert {by_seq[s.parent].name for s in forwards} == {"fixed.anchor", "fixed.rerank"}
    assert sum(by_seq[s.parent].name == "fixed.anchor" for s in forwards) == 2


@pytest.mark.parametrize("escalate, bucket_pad", [(None, 0), (18, 0), (18, 3)])
def test_adaptive_path_counts_ce_rows_and_padding(retriever, handed, monkeypatch, escalate, bucket_pad):
    import anncur_tpu_torch.core.retriever as retriever_mod

    r, ment, _ = retriever
    if bucket_pad:  # an escalation bucket with rows to spare
        monkeypatch.setattr(retriever_mod, "_bucket_size", lambda n, cap: n + bucket_pad)
    t0 = time.time_ns()
    # top 1 at 12 over 3 rounds: on this world every query escalates
    _, _, stats = r.query_tokens_adaptive_fused(ment[:5], total_budget=12, n_rounds=3, top_k=1,
                                                escalate_budget=escalate, escalate_rounds=2, return_stats=True)
    pairs, pad = _since(t0, "ce.pairs"), _since(t0, "ce.pad_pairs")
    assert len(pairs) == len(pad) == 1
    assert pairs[0].value == sum(handed)
    extra = (escalate or 12) - 12
    assert stats["frac_escalated"] == (1.0 if escalate else 0.0)
    # the real rows: every query over the budget, each escalated one over the rest
    assert pairs[0].value - pad[0].value == 5 * 12 + (5 if escalate else 0) * extra
    assert pad[0].value == bucket_pad * extra


def test_dense_path_spans():
    spec = BertSpec.tiny(vocab_size=64, max_position_embeddings=32)
    enc = BiEncoder(spec, embed_dim=spec.hidden_size, compute_dtype=torch.float32, device="cpu", seed=2)
    toks = np.random.default_rng(0).integers(1, 64, size=(5, 8)).astype(np.int32)
    index = DenseIndex(torch.randn(30, embed_tokenized(enc, toks[:1], which="input").shape[1]), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        emb = embed_tokenized(enc, toks, batch_size=2, which="input")
        index.search(emb, 4)
    names = [s.name for s in sorted(_since(t0), key=lambda s: s.start_ns)]
    assert names == ["tower.forward"] * 3 + ["embed.to_host", "index.search", "index.to_host"]
    by = {s.name: s for s in _since(t0)}
    assert by["index.to_host"].parent == by["index.search"].seq
