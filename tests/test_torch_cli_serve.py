"""Port parity, serving: ``cli/serve.py`` run by the JAX ``main(argv)``
and by the port's ``main(argv + ["--device", "cpu"])`` on one world, one
JAX-written CE checkpoint and retriever state files written by either
package (file mode, fixed and adaptive, both index formats, stdin), the
HTTP front end (routes, error codes, coalescing of concurrent clients,
the dynamic corpus) and the ``Coalescer`` alone (CPU, f32 compute).

Tolerances: scores within SCORE_ATOL (f32 on both sides, sums in other
orders), ids equal where the JAX score is more than GAP from both
neighbours. The JAX CLI pads a partial batch to --batch, the port sends
it as it is, so a query's row may differ by rounding between batches:
rows of the same query are held to the same tolerance."""

import http.client
import io
import json
import pickle
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.cli import serve as jserve
from anncur_tpu.core.cur import build_cur as jax_build_cur
from anncur_tpu.core.cur import save_cur_index as jax_save_cur_index
from anncur_tpu.core.retriever import CurRetriever as JaxRetriever
from anncur_tpu.data.synthetic import make_tokenizer, make_world
from anncur_tpu.data.tokenization import tokenize_entities, tokenize_mentions
from anncur_tpu.indexer.score_matrix import ScoreMatrixBuilder as JaxBuilder
from anncur_tpu.models.bert import BertSpec as JaxBertSpec
from anncur_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from anncur_tpu.train.checkpoint import save_pytree as jax_save_pytree

from anncur_tpu_torch.cli import serve as tserve
from anncur_tpu_torch.core.retriever import CurRetriever
from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.convert import crossencoder_from_jax_params
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer

torch.set_num_threads(2)  # xdist runs several test files side by side

SCORE_ATOL, SCORE_RTOL = 1e-4, 1e-5
GAP = 1e-4
N_ENTS, N_MENTS, N_TRAIN = 40, 24, 12
TINY = ["--hidden_size", "32", "--num_layers", "1", "--num_heads", "2", "--intermediate_size", "64"]
F32 = ["--compute_dtype", "f32", "--max_query_len", "16"]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Vocab, a JAX CE checkpoint, a JAX-built and a port-built retriever
    state file over one train matrix, a bare CurIndex pickle with its
    entity tokens, and a JSONL of queries."""
    root = tmp_path_factory.mktemp("serve_world")
    mentions, entities = make_world(np.random.default_rng(15), n_ents=N_ENTS, n_ments=N_MENTS)
    tok = make_tokenizer()
    ment = tokenize_mentions(mentions, tok, 16)
    ent = tokenize_entities(entities, tok, 16)
    w = {"vocab": str(root / "vocab.txt"), "mentions": mentions, "ment": ment, "ent": ent}
    tok.save_vocab(w["vocab"])
    # widened init: a random CE at 0.02 scores near rank one
    spec_j = JaxBertSpec(vocab_size=tok.vocab_size, hidden_size=32, num_layers=1, num_heads=2,
                         intermediate_size=64, initializer_range=0.3)
    ce_j = JaxCrossEncoder(spec=spec_j, compute_dtype=jnp.float32)
    params = ce_j.init(jax.random.PRNGKey(4))
    w["ckpt"] = str(root / "ce.pkl")
    jax_save_pytree(w["ckpt"], {"params": params})
    tree = jax.tree_util.tree_map(np.asarray, params)
    ce_t = crossencoder_from_jax_params(
        tree, BertSpec(vocab_size=tok.vocab_size, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64),
        device="cpu", dtype=torch.float32,
    )
    builder_j = JaxBuilder(ce_j, ment_block=4, ent_block=8)
    train = builder_j(params, ment[:N_TRAIN], ent)
    r_j = JaxRetriever.build(ce_j, params, tok, ment[:N_TRAIN], ent, n_anchor_items=10, builder=builder_j,
                             train_scores=train, max_query_len=16, seed=2)
    w["jax_state"] = str(root / "jax_state.pkl")
    r_j.save(w["jax_state"])
    r_t = CurRetriever.build(ce_t, WordPieceTokenizer(tok.vocab), ment[:N_TRAIN], ent, n_anchor_items=10,
                             builder=ScoreMatrixBuilder(ce_t, device="cpu"), train_scores=train, max_query_len=16,
                             seed=2, device="cpu")
    w["port_state"] = str(root / "port_state.pkl")
    r_t.save(w["port_state"])
    anchors = np.asarray(r_j.anchor_item_ids)
    index = jax_build_cur(train, train[:, anchors], np.arange(N_TRAIN), anchors, validate=False)
    w["bare"] = str(root / "index.pkl")
    jax_save_cur_index(w["bare"], index)
    w["ent_npy"] = str(root / "ents.npy")
    np.save(w["ent_npy"], ent)
    w["queries"] = str(root / "queries.jsonl")
    with open(w["queries"], "w") as fout:
        for m in mentions[N_TRAIN:]:
            fout.write(json.dumps({k: m[k] for k in ("mention", "context_left", "context_right")}) + "\n")
    w["ce_t"], w["r_t"] = ce_t, r_t
    return w


def _read_rows(path):
    with open(path) as fin:
        return [json.loads(line) for line in fin]


def _assert_rows_close(got, want):
    """Result rows of the same queries: same query strings, scores within
    SCORE_ATOL, ids equal where the reference's scores are separated."""
    assert len(got) == len(want) > 0
    n_sep = 0
    for g, w in zip(got, want):
        assert g["query"] == w["query"]
        gi, gs = np.asarray([r[0] for r in g["results"]]), np.asarray([r[1] for r in g["results"]])
        wi, ws = np.asarray([r[0] for r in w["results"]]), np.asarray([r[1] for r in w["results"]])
        assert gi.shape == wi.shape
        np.testing.assert_allclose(gs, ws, atol=SCORE_ATOL, rtol=SCORE_RTOL)
        gaps = -np.diff(ws)
        sep = np.ones(ws.shape, bool)
        sep[:-1] &= gaps > GAP
        sep[1:] &= gaps > GAP
        np.testing.assert_array_equal(gi[sep], wi[sep])
        n_sep += sep.sum()
    assert n_sep > 0.3 * sum(len(w["results"]) for w in want), "too few separated scores"


def _serve_both(world, tmp_path, args, state_jax=None, state_port=None):
    """(port rows, JAX rows) of one query file served by both CLIs."""
    outs = {}
    for kind, main, state in (("jax", jserve.main, state_jax), ("port", tserve.main, state_port)):
        out = str(tmp_path / f"{kind}.jsonl")
        main(["--index", state or world["jax_state"], "--vocab_file", world["vocab"], "--crossenc_ckpt",
              world["ckpt"], "--queries", world["queries"], "--out", out] + TINY + F32 + args
             + (CPU if kind == "port" else []))
        outs[kind] = _read_rows(out)
    return outs["port"], outs["jax"]


@pytest.mark.parametrize("state", ["jax_state", "port_state"])
def test_fixed_mode_equals_jax_across_state_files(world, tmp_path, state):
    """A state file written by either package, served by both."""
    got, want = _serve_both(world, tmp_path, ["--top_k", "5", "--top_k_retvr", "20", "--batch", "5"],
                            world[state], world[state])
    assert len(got) == N_MENTS - N_TRAIN and len(got[0]["results"]) == 5
    _assert_rows_close(got, want)


def test_fixed_mode_bare_index_equals_jax(world, tmp_path):
    outs = {}
    for kind, main in (("jax", jserve.main), ("port", tserve.main)):
        out = str(tmp_path / f"{kind}.jsonl")
        main(["--index", world["bare"], "--ent_tokens_file", world["ent_npy"], "--vocab_file", world["vocab"],
              "--crossenc_ckpt", world["ckpt"], "--queries", world["queries"], "--out", out, "--top_k", "4",
              "--top_k_retvr", "16"] + TINY + F32 + (CPU if kind == "port" else []))
        outs[kind] = _read_rows(out)
    _assert_rows_close(outs["port"], outs["jax"])
    with pytest.raises(SystemExit, match="ent_tokens_file"):
        tserve.main(["--index", world["bare"], "--vocab_file", world["vocab"]] + TINY + CPU)


@pytest.mark.parametrize("extra", [
    ["--budget", "12", "--rounds", "3"],
    ["--budget", "8", "--rounds", "2", "--escalate_budget", "16", "--escalate_rounds", "2"],
])
def test_adaptive_mode_equals_jax(world, tmp_path, extra):
    got, want = _serve_both(world, tmp_path, ["--mode", "adaptive", "--top_k", "4", "--batch", "8"] + extra)
    _assert_rows_close(got, want)


def test_batch_size_changes_rows_only_by_rounding(world, tmp_path):
    """The port sends partial batches unpadded: rows of --batch 1 and of
    --batch 12 agree within the tolerance."""
    rows = {}
    for batch in ("1", "12"):
        out = str(tmp_path / f"b{batch}.jsonl")
        tserve.main(["--index", world["jax_state"], "--vocab_file", world["vocab"], "--crossenc_ckpt", world["ckpt"],
                     "--queries", world["queries"], "--out", out, "--batch", batch] + TINY + F32 + CPU)
        rows[batch] = _read_rows(out)
    _assert_rows_close(rows["1"], rows["12"])


def test_stdin_tsv_is_answered_line_by_line(world, tmp_path, monkeypatch):
    mentions = world["mentions"][N_TRAIN:N_TRAIN + 3]
    lines = "".join(f"{m['mention']}\t{m['context_left']}\t{m['context_right']}\n" for m in mentions)
    monkeypatch.setattr("sys.stdin", io.StringIO(lines + "\n"))
    out = str(tmp_path / "stdin.jsonl")
    tserve.main(["--index", world["jax_state"], "--vocab_file", world["vocab"], "--crossenc_ckpt", world["ckpt"],
                 "--out", out, "--top_k", "3"] + TINY + F32 + CPU)
    got = _read_rows(out)
    assert [r["query"] for r in got] == [m["mention"] for m in mentions]
    # the same queries from the JSONL file, in one batch
    file_out = str(tmp_path / "file.jsonl")
    tserve.main(["--index", world["jax_state"], "--vocab_file", world["vocab"], "--crossenc_ckpt", world["ckpt"],
                 "--queries", world["queries"], "--out", file_out, "--top_k", "3"] + TINY + F32 + CPU)
    _assert_rows_close(got, _read_rows(file_out)[:3])


# ---------------------------------------------------------------- HTTP


def _start(argv):
    tserve._serve_http.last_server = None  # an earlier test's server is stale
    t = threading.Thread(target=tserve.main, args=(argv,), daemon=True)
    t.start()
    deadline = time.time() + 60
    server = None
    while time.time() < deadline and server is None:
        server = tserve._serve_http.last_server
        time.sleep(0.02)
    assert server is not None, "HTTP server did not come up"
    return t, server


def _stop(t, server):
    server.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()


def _call(base, path, payload=None):
    req = urllib.request.Request(
        base + path,
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if payload is None else "POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _raw_post(port, path, headers, body=b""):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.putrequest("POST", path)
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.endheaders()
        if body:
            conn.send(body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _http_argv(world, *extra):
    return ["--index", world["jax_state"], "--vocab_file", world["vocab"], "--crossenc_ckpt", world["ckpt"],
            "--http", "127.0.0.1:0", "--top_k", "3", "--top_k_retvr", "60"] + TINY + F32 + CPU + list(extra)


def test_http_routes_and_dynamic_corpus(world, tmp_path):
    t, server = _start(_http_argv(world, "--batch", "2"))
    base = "http://127.0.0.1:%d" % server.server_address[1]
    queries = [{k: m[k] for k in ("mention", "context_left", "context_right")} for m in world["mentions"][N_TRAIN:N_TRAIN + 3]]
    try:
        code, health = _call(base, "/healthz")
        assert code == 200 and health["status"] == "ok" and health["n_items"] == N_ENTS and health["mode"] == "fixed"
        assert {"cost_per_query", "escalate_budget", "batch", "coalesce_ms", "dispatches", "queries_answered",
                "queue_wait_ms", "ce_pad_share"} <= set(health)
        assert set(health["queue_wait_ms"]) == {"p50", "p95"}
        # the fixed mode's cost: anchors + top_k_retvr clamped to the corpus
        assert health["cost_per_query"] == 10 + N_ENTS and health["escalate_budget"] == 0

        code, out = _call(base, "/query", {"queries": queries})
        assert code == 200 and len(out["results"]) == 3
        assert all(len(r["results"]) == 3 for r in out["results"])
        code, one = _call(base, "/query", queries[0])  # a bare query object
        assert code == 200
        _assert_rows_close(one["results"], out["results"][:1])

        # the same rows as the file mode of the JAX CLI
        jax_out = str(tmp_path / "jax.jsonl")
        jserve.main(["--index", world["jax_state"], "--vocab_file", world["vocab"], "--crossenc_ckpt", world["ckpt"],
                     "--queries", world["queries"], "--out", jax_out, "--top_k", "3", "--top_k_retvr", "60"] + TINY + F32)
        _assert_rows_close(out["results"], _read_rows(jax_out)[:3])

        code, added = _call(base, "/add", {"items": [{"title": "new thing", "description": "alpha alpha beta"},
                                                     {"title": "other", "description": "gamma"}]})
        assert code == 200 and added["ids"] == [N_ENTS, N_ENTS + 1]
        assert _call(base, "/healthz")[1]["n_items"] == N_ENTS + 2
        # the added item is scored as a full rebuild would score it
        assert server.retriever.item_tokens.shape[0] == N_ENTS + 2
        code, removed = _call(base, "/remove", {"ids": [N_ENTS, N_ENTS, N_ENTS + 1]})
        assert code == 200 and removed["removed"] == 2
        assert _call(base, "/healthz")[1]["n_items"] == N_ENTS
        code, again = _call(base, "/query", {"queries": queries})
        _assert_rows_close(again["results"], out["results"])

        # client errors are 400s, unknown paths 404s
        assert _call(base, "/query", {})[0] == 400
        assert _call(base, "/query", [{"mention": "x"}])[0] == 400
        assert _call(base, "/query", {"queries": ["just a string"]})[0] == 400
        assert _call(base, "/add", {"items": ["nope"]})[0] == 400
        assert _call(base, "/add", {})[0] == 400
        assert _call(base, "/remove", {"ids": [999]})[0] == 400
        assert _call(base, "/remove", {})[0] == 400
        assert _call(base, "/nope", {"x": 1})[0] == 404
        assert _call(base, "/nope")[0] == 404
        port = server.server_address[1]
        assert _raw_post(port, "/query", {"Content-Length": "7"}, b"{nope}}")[0] == 400
        assert _raw_post(port, "/query", {"Content-Length": "-1"})[0] == 400
        assert _raw_post(port, "/query", {"Transfer-Encoding": "chunked"})[0] == 411
        assert _raw_post(port, "/query", {"Content-Length": str(tserve.MAX_BODY_BYTES + 1)})[0] == 413
        assert type(server).request_queue_size == 128
    finally:
        _stop(t, server)


def test_http_server_error_is_a_500(world, monkeypatch):
    t, server = _start(_http_argv(world))
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        def boom(*a, **k):
            raise RuntimeError("device fault")

        monkeypatch.setattr(server.retriever, "query_tokens_batch", boom)
        code, out = _call(base, "/query", {"mention": "alpha"})
        assert code == 500 and "device fault" in out["error"]
    finally:
        _stop(t, server)


def test_http_concurrent_clients_coalesce(world):
    """Single-query requests fired together share dispatches, and every
    client gets its own answer."""
    t, server = _start(_http_argv(world, "--batch", "4", "--coalesce_ms", "300"))
    base = "http://127.0.0.1:%d" % server.server_address[1]
    queries = [{k: m[k] for k in ("mention", "context_left", "context_right")} for m in world["mentions"][N_TRAIN:N_TRAIN + 4]]
    try:
        code, out = _call(base, "/query", {"queries": queries})
        assert code == 200
        barrier = threading.Barrier(8)
        results, errors, lock = {}, [], threading.Lock()

        def client(i):
            try:
                barrier.wait(timeout=30)
                code, got = _call(base, "/query", queries[i % 4])
                assert code == 200
                with lock:
                    results[i] = got["results"][0]
            except Exception as e:  # noqa: BLE001 — collected for the main thread
                with lock:
                    errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads) and not errors, errors
        for i in range(8):
            _assert_rows_close([results[i]], [out["results"][i % 4]])
        code, health = _call(base, "/healthz")
        assert health["queries_answered"] == 12
        assert health["dispatches"] < health["queries_answered"]
        # the tracer's rings hold these queries' waits and their CE rows
        assert 0 <= health["queue_wait_ms"]["p50"] <= health["queue_wait_ms"]["p95"]
        assert 0 <= health["ce_pad_share"] < 1
    finally:
        _stop(t, server)


def test_http_adaptive_healthz_and_ipv6(world):
    t, server = _start(["--index", world["jax_state"], "--vocab_file", world["vocab"], "--crossenc_ckpt", world["ckpt"],
                        "--http", "[::1]:0", "--mode", "adaptive", "--budget", "12", "--rounds", "3",
                        "--escalate_budget", "100"] + TINY + F32 + CPU)
    base = "http://[::1]:%d" % server.server_address[1]
    try:
        code, health = _call(base, "/healthz")
        assert code == 200 and health["mode"] == "adaptive"
        # the budget as spent, the escalation ceiling clamped to the corpus
        assert health["cost_per_query"] == 12 and health["escalate_budget"] == N_ENTS
        code, out = _call(base, "/query", {"mention": "alpha beta"})
        assert code == 200 and len(out["results"][0]["results"]) == 10
        health = _call(base, "/healthz")[1]
        assert health["queue_wait_ms"]["p95"] >= 0 and 0 <= health["ce_pad_share"] < 1
    finally:
        _stop(t, server)


# ---------------------------------------------------------------- Coalescer


def test_coalescer_batches_across_requests():
    sizes = []
    gate = threading.Event()

    def dispatch(queries, toks):
        gate.wait(timeout=30)
        sizes.append(len(queries))
        return [q * 10 for q in queries]

    co = tserve.Coalescer(dispatch, batch=4, window_s=0.2, device_lock=threading.Lock())
    results, lock = {}, threading.Lock()

    def submit(i):
        rows = co.submit([i, i + 100], [None, None])
        with lock:
            results[i] = rows

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(5)]
    for th in threads:
        th.start()
    time.sleep(0.3)
    gate.set()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert results == {i: [i * 10, (i + 100) * 10] for i in range(5)}
    assert sum(sizes) == 10 and max(sizes) <= 4 and len(sizes) < 10
    assert co.n_queries == 10 and co.n_dispatches == len(sizes)
    co.stop()
    assert not co._worker.is_alive()
    with pytest.raises(RuntimeError, match="shutting down"):
        co.submit([1], [None])


def test_coalescer_error_fails_every_waiter_of_the_dispatch():
    calls = []

    def dispatch(queries, toks):
        calls.append(list(queries))
        if "bad" in queries:
            raise ValueError("no such item")
        return queries

    co = tserve.Coalescer(dispatch, batch=8, window_s=0.3, device_lock=threading.Lock())
    errors, oks, lock = [], [], threading.Lock()

    def submit(q):
        try:
            rows = co.submit([q], [None])
            with lock:
                oks.append(rows)
        except ValueError as e:
            with lock:
                errors.append(str(e))

    threads = [threading.Thread(target=submit, args=(q,)) for q in ("a", "bad", "c")]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert len(calls) == 1 and sorted(calls[0]) == ["a", "bad", "c"]
    assert errors == ["no such item"] * 3 and not oks
    # the worker lives on
    assert co.submit(["d"], [None]) == ["d"]
    co.stop()
