"""Bi-encoder dense retrieval, closed loop: back-to-back requests of
``request_mentions`` mentions, each embedded by the port's input tower
(``evalx/retrieve_rerank.py::embed_tokenized``, ``batch_size`` rows a
forward) and searched with ``DenseIndex.search`` (kernel B) for the top
``k`` of the corpus's entity embeddings.

The entity embeddings stand for the label tower's offline output, the
index file a deployment loads: unit-norm rows drawn from the seed on the
device, f32. Requests cycle through a pool of distinct mention batches.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from cebench.lib import models, reference, world
from cebench.lib.yardstick import rate_over_window, seq_flops


def setup(run):
    from anncur_tpu_torch.models.biencoder import BiEncoder
    from anncur_tpu_torch.ops.dense_index import DenseIndex

    prm, cfg, dep = run.params, run.cfg, run.cfg["deployment"]
    with run.spans.span("setup.weights"):
        tree = world.bienc_weights(cfg, run.seed, run.device)
        enc = BiEncoder(models.bert_spec(cfg), pooling_type=dep["pooling_type"], bi_enc_type=dep["bi_enc_type"],
                        embed_dim=dep["embed_dim"], add_linear_layer=dep["add_linear_layer"],
                        compute_dtype=models.DTYPES[dep["compute_dtype"]], device=run.device,
                        params=world.host_tree(tree))
    models.wrap_counting(enc, "encode_input", lambda a, kw: run.count("tower_rows", int(np.shape(a[0])[0])))
    gen = world.generator(run.seed, "entity_embeds", run.device)
    embeds = torch.randn(dep["n_items"], dep["embed_dim"], generator=gen, device=run.device)
    embeds /= embeds.norm(dim=1, keepdim=True)
    with run.spans.span("setup.index"):
        index = DenseIndex(embeds, device=run.device)
    n = prm["request_mentions"]
    lm = dep["max_input_len"]
    pool = world.tokens(world.generator(run.seed, "queries", run.device), prm["pool_requests"] * n, lm,
                        cfg["vocab_size"], world.mention_tags(lm), run.device)
    st = SimpleNamespace(enc=enc, tree=tree, index=index, embeds=embeds, pool=pool,
                         pool_np=pool.cpu().numpy().reshape(prm["pool_requests"], n, lm), calls=[], out=[])
    with run.spans.span("setup.warmup"):
        _request(run, st, 0)
    st.out.clear()
    run.counters.clear()
    return st


def _request(run, st, r):
    from anncur_tpu_torch.evalx.retrieve_rerank import embed_tokenized

    prm = run.params
    toks = st.pool_np[r % prm["pool_requests"]]
    with run.spans.span("embed"):
        emb = embed_tokenized(st.enc, toks, batch_size=prm["batch_size"], which="input")
    with run.spans.span("search"):
        scores, ids = st.index.search(emb, prm["k"])
    # the rows this request keeps for the check, drawn from the seed
    rows = np.random.default_rng(world.subseed(run.seed, f"check.{r}")).choice(
        emb.shape[0], size=prm["kept_rows"], replace=False)
    st.out.append((r, rows, emb[rows], scores[rows], ids[rows]))


def window(run, st):
    r = 0
    while run.now() < run.deadline:
        run.trace_tick()
        t0 = run.now()
        _request(run, st, r)
        st.calls.append((t0, run.now(), st.pool_np.shape[1]))
        r += 1
    run.e2e["mentions_per_s"] = rate_over_window(st.calls, run.window_start, run.deadline)
    cfg, dep = run.cfg, run.cfg["deployment"]
    run.attempted = len(st.calls)
    run.counters.update(mentions=sum(w for _, _, w in st.calls), requests=len(st.calls))
    flop = seq_flops(cfg["hidden_size"], cfg["num_hidden_layers"], cfg["intermediate_size"], dep["max_input_len"])
    run.model_work([(t0, t1, w * flop) for t0, t1, w in st.calls], closed=True)


def release(run, st):
    st.enc = st.index = None


def dense_gaps(tree, cfg, toks: torch.Tensor, emb: torch.Tensor, scores: torch.Tensor, ids: torch.Tensor,
               embeds: torch.Tensor, k: int):
    """``embed_gap``: the tower's embeddings vs the reference's;
    ``search_score_gap``: each returned score vs the f64 inner product of
    that embedding and item; ``search_rank_gap``: the returned ids ranked
    by those f64 products, short of their own top k, as a share of the
    row's largest."""
    ref = reference.tower_embeds(tree["input_bert"], cfg, toks)
    embed_gap = float((emb - ref).abs().max())
    ip = reference.mips_scores(emb, embeds, "f64")
    got = torch.gather(ip, 1, ids.long())
    score_gap = float((scores.double() - got).abs().max())
    rank = max(reference.rank_gap(ip[i:i + 1], ids[i:i + 1], k) / float(ip[i].abs().max()) for i in range(len(ids)))
    return {"embed_gap": embed_gap, "search_score_gap": score_gap, "search_rank_gap": rank}


def check(run, st):
    prm = run.params
    rng = np.random.default_rng(world.subseed(run.seed, "check"))
    kept = [(c, j) for c in range(len(st.out)) for j in range(prm["kept_rows"])]
    picks = [kept[i] for i in sorted(rng.choice(len(kept), size=min(prm["check_mentions"], len(kept)), replace=False))]
    dev = st.embeds.device
    toks = torch.as_tensor(np.stack(
        [st.pool_np[st.out[c][0] % prm["pool_requests"]][st.out[c][1][j]] for c, j in picks]), device=dev)
    emb, scores, ids = (torch.as_tensor(np.stack([st.out[c][f][j] for c, j in picks]), device=dev) for f in (2, 3, 4))
    for name, value in dense_gaps(st.tree, run.cfg, toks, emb, scores, ids, st.embeds, prm["k"]).items():
        run.check(name, value)


def control(run):
    """The control's numbers: the tower and the search computed by the
    reference one precision lower, on as many mentions as a run checks."""
    prm, cfg, dep = run.params, run.cfg, run.cfg["deployment"]
    tree = world.bienc_weights(cfg, run.seed, run.device)
    gen = world.generator(run.seed, "entity_embeds", run.device)
    embeds = torch.randn(dep["n_items"], dep["embed_dim"], generator=gen, device=run.device)
    embeds /= embeds.norm(dim=1, keepdim=True)
    lm = dep["max_input_len"]
    pool = world.tokens(world.generator(run.seed, "queries", run.device), prm["pool_requests"] * prm["request_mentions"],
                        lm, cfg["vocab_size"], world.mention_tags(lm), run.device)
    rng = np.random.default_rng(world.subseed(run.seed, "check"))
    toks = pool[torch.as_tensor(rng.choice(pool.shape[0], size=prm["check_mentions"], replace=False), device=run.device)]
    emb = reference.tower_embeds(tree["input_bert"], cfg, toks, reference.CONTROL_CE)
    scores, ids = reference.topk(reference.mips_scores(emb, embeds, reference.CONTROL_MIPS), prm["k"])
    return dense_gaps(tree, cfg, toks, emb, scores.float(), ids, embeds, prm["k"])
