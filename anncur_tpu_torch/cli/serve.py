"""Batch/interactive query serving over a built CUR index.

Counterpart of ``anncur_tpu/cli/serve.py``, with the same flags, JSONL
rows and HTTP bodies, plus ``--device``. Load encoder weights + CUR
index + item tokens, then answer queries from a JSONL file (or stdin
lines formatted 'mention<TAB>context_left<TAB>context_right') with
top-k item ids.

Two serving modes (--mode):
- fixed    — anchor-score -> latent-project -> retrieve (kernel B) ->
             exact rerank; cost = n_anchors + top_k_retvr CE calls per
             query.
- adaptive — the fused multi-round engine (core/adaptive_fused.py);
             cost = --budget CE calls per query (--escalate_budget for
             queries whose top-k has not settled).
Queries are micro-batched (--batch) either way.

With --http HOST:PORT the same engine serves over HTTP (stdlib only,
one device dispatch at a time behind a lock; one process, whose /add
builder runs on a world-size-1 mesh, as the JAX server's runs on a mesh
of its local devices). /query traffic is batched
across requests: a coalescer worker gathers queries of concurrent
requests into shared device batches (see Coalescer), so N small clients
cost ~N/batch dispatches instead of N; --coalesce_ms bounds the extra
fill-wait latency (default 0):
- GET  /healthz            -> {"status", "n_items", "mode", ...,
                              "queue_wait_ms": {"p50", "p95"},
                              "ce_pad_share"}; the last two read the
                              tracer's rings (see traced_health): the
                              recent queries' waits in the coalescer's
                              queue, and the share of the recent engine
                              calls' CE pairs that padded a batch (null
                              until a query has been answered)
- POST /query              -> {"queries": [{"mention", "context_left",
                              "context_right"}, ...]} (or one bare
                              query object) -> {"results": [...]}
- POST /add                -> {"items": [{"title", "description"}, ...]}
                              -> {"ids": [...]}; each added item costs
                              k_q CE calls, no index rebuild
                              (CurRetriever.add_items; requires a state
                              file built by CurRetriever.build)
- POST /remove             -> {"ids": [...]} -> {"removed": N}

What the JAX CLI has and this one does not, and why: the JAX package pads
a partial batch to --batch so that no new device program is traced, and
enables XLA's persistent compilation cache; the port compiles nothing
per shape (its kernels are built once, cached by source hash in
``anncur_tpu_torch/build/``), so a partial batch is sent as it is and
there is no compilation cache. A query's answer does not depend on its
batch beyond the CE's rounding.
"""

from __future__ import annotations

import argparse
import json
import logging
import pickle
import sys
import threading
import time

import numpy as np

from anncur_tpu_torch.cli import _common
from anncur_tpu_torch.core.cur import load_cur_index
from anncur_tpu_torch.core.retriever import CurRetriever
from anncur_tpu_torch.data.tokenization import get_candidate_representation_ids
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer
from anncur_tpu_torch.utils.tracker import TRACER

LOGGER = logging.getLogger("anncur_tpu_torch.serve")

# bounds the request-body buffer: 64 MiB fits the largest legitimate
# payload (tens of thousands of queries) while a bad Content-Length cannot
# exhaust the serving process's memory
MAX_BODY_BYTES = 64 * 1024 * 1024
# CE pairs per forward of an /add (the build's blocks, 32 x 64)
ADD_PAIRS_PER_FORWARD = 2048


class _Pending:
    """One request's result slots, filled by the coalescer worker as each
    dispatch holding its queries completes."""

    def __init__(self, n):
        self.rows = [None] * n
        self.remaining = n
        self.done = threading.Event()
        self.error = None

    def set(self, slot, row):
        self.rows[slot] = row
        self.remaining -= 1  # worker thread only; no lock needed
        if self.remaining == 0:
            self.done.set()

    def fail(self, exc):
        self.error = exc
        self.done.set()


class Coalescer:
    """Cross-request dynamic micro-batching for the HTTP front end.

    One worker thread drains a shared queue in ``batch`` slices behind the
    device lock, so queries of different requests ride one dispatch: N
    concurrent single-query clients cost ~N/batch dispatches, not N.

    ``window_s`` bounds the extra latency: after the first query arrives
    the worker waits at most this long for the batch to fill (0 =
    dispatch whatever is queued at once; queries still coalesce under
    backlog, since they queue while the device is busy). A dispatch error
    fails every waiter of that dispatch. Memory is bounded by the
    callers: submit() blocks the request thread until its rows are
    filled, so the queue never holds more than the live request threads'
    queries.

    Each query's wait, from submit() enqueuing it to the worker taking it,
    is a ``serve.queue_wait`` sample of the tracer (nanoseconds), and each
    dispatch runs in a ``serve.dispatch`` span whose trace id is the
    dispatch's number.
    """

    def __init__(self, dispatch, batch, window_s, device_lock):
        self._dispatch = dispatch  # (queries, toks) -> rows, len <= batch
        self.batch = int(batch)
        self.window_s = float(window_s)
        self._device_lock = device_lock
        self._cond = threading.Condition()
        self._buf = []  # (query, tok, pending, slot, time.time_ns() when queued)
        self._stop = False
        self.n_dispatches = 0
        self.n_queries = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, queries, toks):
        """Enqueue a whole request (any length) and block until every one
        of its queries is answered; returns rows in request order."""
        pending = _Pending(len(queries))
        with self._cond:
            if self._stop:
                raise RuntimeError("server shutting down")
            now = time.time_ns()
            self._buf.extend((q, t, pending, i, now) for i, (q, t) in enumerate(zip(queries, toks)))
            self._cond.notify_all()
        # no timeout: the worker fills or fails every slot (its dispatch
        # call is wrapped); clients bound their own wait
        pending.done.wait()
        if pending.error is not None:
            raise pending.error
        return pending.rows

    def stop(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._worker.join(timeout=30)

    def _run(self):
        while True:
            with self._cond:
                while not self._buf and not self._stop:
                    self._cond.wait()
                if self._stop and not self._buf:
                    return
                if self.window_s > 0:
                    deadline = time.monotonic() + self.window_s
                    while len(self._buf) < self.batch and not self._stop:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._cond.wait(timeout=left)
                take, self._buf = self._buf[: self.batch], self._buf[self.batch :]
                self.n_dispatches += 1
                self.n_queries += len(take)
                number = self.n_dispatches
                now = time.time_ns()
                for *_, queued in take:
                    TRACER.sample("serve.queue_wait", now - queued, queued, now)
            try:
                with self._device_lock, TRACER.span("serve.dispatch", trace_id=number):
                    rows = self._dispatch([q for q, *_ in take], [t for _, t, *_ in take])
                for (_, _, pending, slot, _), row in zip(take, rows):
                    pending.set(slot, row)
            except Exception as e:  # noqa: BLE001 — handed to every waiter of this dispatch
                for _, _, pending, *_ in take:
                    pending.fail(e)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--index", required=True, help="CurRetriever.save state file or bare save_cur_index pickle")
    p.add_argument("--ent_tokens_file", default="", help="entity-token .npy (not needed with a CurRetriever.save state file)")
    p.add_argument("--vocab_file", required=True)
    p.add_argument("--crossenc_ckpt", default="")
    p.add_argument("--cross_enc_type", default="default")
    p.add_argument("--queries", default="-", help="JSONL with mention/context_left/context_right ('-' = stdin TSV)")
    p.add_argument("--out", default="-", help="output JSONL ('-' = stdout)")
    p.add_argument("--http", default="", help="serve over HTTP at HOST:PORT (e.g. ':8080') instead of reading --queries")
    p.add_argument("--top_k", type=int, default=10)
    p.add_argument("--top_k_retvr", type=int, default=100)
    p.add_argument("--mode", choices=["fixed", "adaptive"], default="fixed")
    p.add_argument("--budget", type=int, default=200, help="adaptive mode: total CE calls per query")
    p.add_argument("--rounds", type=int, default=5, help="adaptive mode: number of rounds")
    p.add_argument("--ada_method", choices=["cur", "axn"], default="cur")
    p.add_argument("--axn_rank", type=int, default=0, help="0 = full rank")
    p.add_argument(
        "--escalate_budget", type=int, default=0,
        help="adaptive mode: per-query early stopping — queries whose top-k has not "
        "settled after --budget CE calls spend up to this many in all (0 = off)",
    )
    p.add_argument("--escalate_rounds", type=int, default=3, help="adaptive mode: rounds for the escalation phase")
    p.add_argument("--batch", type=int, default=32, help="queries per device dispatch (both modes)")
    p.add_argument(
        "--coalesce_ms", type=float, default=0.0,
        help="HTTP mode: wait up to this long for concurrent requests' queries to fill "
        "a shared device batch (0 keeps single-request latency; queries that queued "
        "while the device was busy still coalesce)",
    )
    p.add_argument("--max_query_len", type=int, default=None, help="default: the state file's saved value, else 128")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--compute_dtype", choices=["bf16", "f32"], default="bf16",
        help="encoder compute dtype; f32 matches an f32-built index bit for bit "
        "(rankings differ only within the score noise floor)",
    )
    _common.add_arch_args(p)
    _common.add_device_arg(p)
    args = p.parse_args(argv)
    device = _common.device_of(args)

    tokenizer = WordPieceTokenizer.from_vocab_file(args.vocab_file)
    ce = _common.crossencoder(
        _common.spec_of(args, tokenizer.vocab_size), args.crossenc_ckpt, args.cross_enc_type,
        _common.DTYPES[args.compute_dtype], device, args.seed, LOGGER, "no --crossenc_ckpt: random cross-encoder",
    )

    # two on-disk formats: a retriever state file (CurRetriever.save: item
    # tokens, stable ids, the dynamic-corpus factors) or a bare CurIndex
    # pickle with a separate entity-token .npy
    with open(args.index, "rb") as fin:
        blob = pickle.load(fin)
    if isinstance(blob, dict) and "item_tokens" in blob:
        retriever = CurRetriever.from_state_dict(blob, ce, tokenizer)
        if args.max_query_len is not None:
            # only an explicit flag overrides the saved value: the index was
            # built for one query length
            retriever.max_query_len = args.max_query_len
    else:
        if not args.ent_tokens_file:
            raise SystemExit("bare CurIndex pickles need --ent_tokens_file")
        index = load_cur_index(args.index, device)
        retriever = CurRetriever(
            encoder=ce,
            tokenizer=tokenizer,
            item_tokens=np.load(args.ent_tokens_file).astype(np.int32),
            index=index,
            anchor_item_ids=index.col_idxs.cpu().numpy(),
            max_query_len=args.max_query_len if args.max_query_len is not None else 128,
            device=device,
        )
    LOGGER.info(
        "serving: %d items, %d anchor items, cost/query = %d + top_k_retvr CE calls",
        retriever.item_tokens.shape[0], len(retriever.anchor_item_ids), retriever.cost_per_query,
    )

    def tokenize(query):
        return retriever.tokenize_query(
            query["mention"], query.get("context_left", ""), query.get("context_right", "")
        )

    def answer(queries, toks):
        """Shared by the file loop and the HTTP handler: one dispatch of
        the batch as it is, one result row per query."""
        qtoks = np.asarray(toks, np.int32)
        if args.mode == "adaptive":
            scores, ids = retriever.query_tokens_adaptive_fused(
                qtoks,
                total_budget=args.budget,
                n_rounds=args.rounds,
                top_k=args.top_k,
                method=args.ada_method,
                axn_rank=args.axn_rank or None,
                escalate_budget=args.escalate_budget or None,
                escalate_rounds=args.escalate_rounds,
                seed=args.seed,
            )
        else:
            scores, ids = retriever.query_tokens_batch(qtoks, top_k=args.top_k, top_k_retvr=args.top_k_retvr)
        return [
            {"query": q["mention"], "results": list(zip(i_row.tolist(), s_row.tolist()))}
            for q, s_row, i_row in zip(queries, scores, ids)
        ]

    if args.http:
        return _serve_http(args, retriever, tokenize, answer)

    fin = sys.stdin if args.queries == "-" else open(args.queries)
    fout = sys.stdout if args.out == "-" else open(args.out, "w")

    def flush(queries, toks):
        if queries:
            for row in answer(queries, toks):
                fout.write(json.dumps(row) + "\n")
            fout.flush()

    try:
        queries, toks = [], []
        # stdin is interactive: answer line by line; files use --batch
        batch = 1 if args.queries == "-" else max(1, args.batch)
        for line in fin:
            line = line.rstrip("\n")
            if not line:
                continue
            if args.queries == "-" or not line.startswith("{"):
                parts = line.split("\t")
                query = {
                    "mention": parts[0],
                    "context_left": parts[1] if len(parts) > 1 else "",
                    "context_right": parts[2] if len(parts) > 2 else "",
                }
            else:
                query = json.loads(line)
            queries.append(query)
            toks.append(tokenize(query))
            if len(queries) >= batch:
                flush(queries, toks)
                queries, toks = [], []
        flush(queries, toks)
    finally:
        # never close sys.stdin/sys.stdout: main() is also an in-process API
        if fin is not sys.stdin:
            fin.close()
        if fout is not sys.stdout:
            fout.close()


def traced_health():
    """/healthz's view of the tracer's rings: ``queue_wait_ms`` (p50, p95
    of the recent queries' waits in the coalescer's queue) and
    ``ce_pad_share`` (the share of the recent engine calls' CE rows that
    were padding); None where nothing was recorded yet."""
    waits = [s.value / 1e6 for s in TRACER.samples("serve.queue_wait")]
    pairs = sum(s.value for s in TRACER.samples("ce.pairs"))
    pad = sum(s.value for s in TRACER.samples("ce.pad_pairs"))
    return {
        "queue_wait_ms": {
            "p50": float(np.percentile(waits, 50)) if waits else None,
            "p95": float(np.percentile(waits, 95)) if waits else None,
        },
        "ce_pad_share": pad / pairs if pairs else None,
    }


def _balanced_block(n: int, cap: int) -> int:
    """The block that covers ``n`` rows in the fewest blocks of at most
    ``cap`` rows, with the least padding."""
    return -(-n // -(-n // max(1, cap)))


def _serve_http(args, retriever, tokenize, answer):
    """Stdlib HTTP front end over the serving engine. The device runs one
    dispatch at a time, so every retriever call sits behind a lock; the
    threaded server only parallelises request I/O."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
    from anncur_tpu_torch.parallel.mesh import mesh_session

    lock = threading.Lock()
    session = {}  # the world-size-1 mesh of /add's builder, while serving
    # every /query goes through the coalescer: one worker drains a shared
    # queue in --batch slices, so queries of different requests share a
    # dispatch
    coalescer = Coalescer(
        dispatch=answer,
        batch=max(1, args.batch),
        window_s=max(0.0, args.coalesce_ms) / 1e3,
        device_lock=lock,
    )
    k_q = 1 if retriever.train_query_tokens is None else len(retriever.train_query_tokens)

    def add_builder(n_new):
        """A builder for one /add: an added item costs one CE call per
        anchor query, and the builder pads both axes to its blocks, so the
        blocks cover the anchor queries and the new items in balanced
        forwards of at most ADD_PAIRS_PER_FORWARD pairs (its default 8 x 64
        blocks would score 64 times the pairs of a one-item /add)."""
        ment_block = _balanced_block(k_q, ADD_PAIRS_PER_FORWARD)
        ent_block = _balanced_block(n_new, ADD_PAIRS_PER_FORWARD // ment_block)
        return ScoreMatrixBuilder(
            retriever.encoder, ment_block=ment_block, ent_block=ent_block, device=retriever.device,
            mesh=session["mesh"],
        )

    max_item_len = int(retriever.item_tokens.shape[1])

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # through logging, not stderr
            LOGGER.info("%s " + fmt, self.address_string(), *a)

        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._send(404, {"error": "unknown path"})
            n_items = int(retriever.item_tokens.shape[0])
            self._send(
                200,
                {
                    "status": "ok",
                    "n_items": n_items,
                    "mode": args.mode,
                    # CE calls per query, comparable across modes, with the
                    # engine's clamps to the live corpus size
                    "cost_per_query": int(
                        min(args.budget, n_items)
                        if args.mode == "adaptive"
                        else retriever.cost_per_query + min(args.top_k_retvr, n_items)
                    ),
                    # early-stop ceiling (0 = off): a query not settled after
                    # cost_per_query may spend up to this many
                    "escalate_budget": int(
                        min(args.escalate_budget, n_items)
                        if args.mode == "adaptive" and args.escalate_budget
                        else 0
                    ),
                    "batch": args.batch,
                    "coalesce_ms": args.coalesce_ms,
                    # dispatches < queries_answered: coalescing saved dispatches
                    "dispatches": coalescer.n_dispatches,
                    "queries_answered": coalescer.n_queries,
                    **traced_health(),
                },
            )

        def do_POST(self):
            try:
                if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
                    # the stdlib handler does not decode chunked bodies
                    return self._send(411, {"error": "chunked Transfer-Encoding unsupported; send Content-Length"})
                n = int(self.headers.get("Content-Length", 0))
                if n < 0:
                    # read(-n) would block until EOF on a keep-alive connection
                    return self._send(400, {"error": "negative Content-Length"})
                if n > MAX_BODY_BYTES:
                    return self._send(413, {"error": f"body too large ({n} > {MAX_BODY_BYTES} bytes)"})
                req = json.loads(self.rfile.read(n) or b"{}")
            except ValueError as e:  # int() of the header, or bad JSON
                return self._send(400, {"error": f"bad json: {e}"})
            try:
                if self.path == "/query":
                    queries = req.get("queries", [req] if "mention" in req else [])
                    if not queries:
                        return self._send(400, {"error": "no queries"})
                    # tokenize on this thread, so concurrent requests
                    # serialise only on the device
                    toks = [tokenize(q) for q in queries]
                    return self._send(200, {"results": coalescer.submit(queries, toks)})
                if self.path == "/add":
                    items = req.get("items", [])
                    if not items:
                        return self._send(400, {"error": "no items"})
                    toks = np.asarray(
                        [
                            get_candidate_representation_ids(
                                it.get("description", ""), retriever.tokenizer, max_item_len,
                                candidate_title=it.get("title"),
                            )
                            for it in items
                        ],
                        np.int32,
                    )
                    with lock:
                        ids = retriever.add_items(toks, add_builder(len(toks)))
                    return self._send(200, {"ids": [int(i) for i in ids]})
                if self.path == "/remove":
                    ids = req.get("ids", [])
                    if not ids:
                        return self._send(400, {"error": "no ids"})
                    with lock:
                        n_removed = retriever.remove_items(np.asarray(ids, np.int64))
                    # duplicates collapse inside remove_items
                    return self._send(200, {"removed": n_removed})
                return self._send(404, {"error": "unknown path"})
            except (ValueError, KeyError, TypeError, AttributeError) as e:
                # well-formed JSON of the wrong shape is the client's fault
                return self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — a server fault answers 500 with its traceback logged
                LOGGER.exception("internal error serving %s", self.path)
                return self._send(500, {"error": f"internal error: {e}"})

    # mark an earlier in-process server stale before binding: if this bind
    # fails, pollers see no server rather than a shut-down one
    _serve_http.last_server = None
    host, _, port = args.http.rpartition(":")
    host = host.strip("[]")  # bracketed IPv6 literals ([::1]:8080)
    # the stdlib's listen backlog of 5 resets a burst of concurrent
    # connects before accept() runs; the coalescer exists for such bursts
    attrs = {"request_queue_size": 128}
    if ":" in host:  # an IPv6 literal needs an AF_INET6 socket
        import socket

        attrs["address_family"] = socket.AF_INET6
    server_cls = type("CoalescingHTTPServer", (ThreadingHTTPServer,), attrs)
    server = server_cls((host or "127.0.0.1", int(port)), Handler)
    LOGGER.info("HTTP serving on %s:%d (mode=%s)", *server.server_address[:2], args.mode)
    # hook for callers running main() in a thread: the live server (its
    # port with ':0', shutdown()), its retriever, and the lock that orders
    # every dispatch and corpus edit (holding it, no device work is in flight)
    server.retriever = retriever
    server.device_lock = lock
    try:
        with mesh_session(retriever.device) as mesh:
            if mesh.size != 1:
                raise ValueError(f"serve runs as one process, not over {mesh.size} ranks")
            session["mesh"] = mesh
            _serve_http.last_server = server
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
    finally:
        server.server_close()
        coalescer.stop()
    return server


_serve_http.last_server = None


if __name__ == "__main__":
    main()
