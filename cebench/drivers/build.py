"""Offline index build: back-to-back calls of the port's
``ScoreMatrixBuilder.__call__``.

Each call scores one block of ``ment_block`` anchor mentions against one
slab of ``slab`` entities (the builder's own slab: ``max_pairs_per_program``
pairs between two host copies); calls walk the entities in order, then
move on to the next block of mentions. These are the forwards a
whole-matrix call makes, cut at slab boundaries.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from cebench.lib import models, reference, world
from cebench.lib.yardstick import rate_over_window, seq_flops


def setup(run):
    from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder

    prm, dep = run.params, run.cfg["deployment"]
    ce, tree = models.make_ce(run)
    items = models.make_items(run)
    n_blocks = prm["mention_blocks"]
    ments = models.make_mentions(run, n_blocks * prm["ment_block"], "anchor_queries")
    builder = ScoreMatrixBuilder(ce, ment_block=prm["ment_block"], ent_block=prm["ent_block"],
                                 max_pairs_per_program=prm["max_pairs_per_program"], device=run.device)
    slab = prm["slab"]
    st = SimpleNamespace(ce=ce, tree=tree, items=items, ments=ments, builder=builder, slab=slab,
                         items_np=items.cpu().numpy(), ments_np=ments.cpu().numpy(), calls=[], out=[])
    with run.spans.span("setup.warmup"):
        builder(st.ments_np[:prm["ment_block"]], st.items_np[:slab])
    run.counters.clear()
    return st


def _calls(n_items: int, slab: int, n_blocks: int):
    """(mention block, entity start, entity end) in walking order."""
    for b in range(n_blocks):
        for e0 in range(0, n_items, slab):
            yield b, e0, min(e0 + slab, n_items)


def window(run, st):
    prm = run.params
    mb = prm["ment_block"]
    for blk, e0, e1 in _calls(st.items_np.shape[0], st.slab, prm["mention_blocks"]):
        if run.now() >= run.deadline:
            break
        run.trace_tick()
        t0 = run.now()
        with run.spans.span("build.call"):
            scores = st.builder(st.ments_np[blk * mb:(blk + 1) * mb], st.items_np[e0:e1])
        st.calls.append((t0, run.now(), scores.size))
        st.out.append((blk, e0, scores))
    else:
        raise RuntimeError("the traffic file's mention blocks ran out before the window closed")
    rate = rate_over_window(st.calls, run.window_start, run.deadline)
    run.e2e["build_pairs_per_s"] = rate
    cfg = run.cfg
    run.attempted = len(st.calls)
    run.counters.update(entries=sum(w for _, _, w in st.calls), calls=len(st.calls))
    flop = seq_flops(cfg["hidden_size"], cfg["num_hidden_layers"], cfg["intermediate_size"], models.pair_len(cfg))
    run.model_work([(t0, t1, w * flop) for t0, t1, w in st.calls], closed=True)


def release(run, st):
    st.builder = st.ce = None


def check(run, st):
    """``score_gap``: the delivered entries vs the reference's CE scores, at
    ``check_entries`` entries drawn from the seed over every call."""
    prm = run.params
    rng = np.random.default_rng(world.subseed(run.seed, "check"))
    mb = prm["ment_block"]
    picks = []
    for _ in range(prm["check_entries"]):
        c = int(rng.integers(len(st.out)))
        blk, e0, scores = st.out[c]
        i, j = int(rng.integers(scores.shape[0])), int(rng.integers(scores.shape[1]))
        picks.append((blk * mb + i, e0 + j, scores[i, j]))
    dev = st.items.device
    m = torch.as_tensor([p[0] for p in picks], device=dev)
    e = torch.as_tensor([p[1] for p in picks], device=dev)
    got = torch.as_tensor([p[2] for p in picks], dtype=torch.float32, device=dev)
    ref = reference.ce_scores(st.tree, run.cfg, st.ments[m], st.items[e], models.pair_len(run.cfg))
    run.check("score_gap", float((got - ref).abs().max()))
    shape_ok = all(s.shape == (mb, min(e0 + st.slab, st.items_np.shape[0]) - e0) and np.isfinite(s).all()
                   for _, e0, s in st.out)
    run.check("bad_blocks", 0 if shape_ok else 1, 0)


def control(run):
    """The control's ``score_gap``: the reference one precision lower at
    as many entries as a run's check draws."""
    prm, cfg = run.params, run.cfg
    tree = world.ce_weights(cfg, run.seed, run.device)
    items = models.make_items(run)
    ments = models.make_mentions(run, prm["mention_blocks"] * prm["ment_block"], "anchor_queries")
    rng = np.random.default_rng(world.subseed(run.seed, "check"))
    m = torch.as_tensor(rng.integers(prm["ment_block"], size=prm["check_entries"]), device=run.device)
    e = torch.as_tensor(rng.integers(cfg["deployment"]["n_items"], size=prm["check_entries"]), device=run.device)
    pl = models.pair_len(cfg)
    got = reference.ce_scores(tree, cfg, ments[m], items[e], pl, reference.CONTROL_CE)
    ref = reference.ce_scores(tree, cfg, ments[m], items[e], pl)
    return {"score_gap": float((got - ref).abs().max())}
