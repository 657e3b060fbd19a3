"""Offline index build with a decoder cross-encoder (DeepSeek-V2-Lite):
``build.py``'s walk of back-to-back ``ScoreMatrixBuilder.__call__`` calls,
one block of ``ment_block`` anchor mentions against one slab of ``slab``
entities each, handed the port's ``DeepseekV2CrossEncoder`` where the
bert-base cell hands it ``CrossEncoder``.

Besides the harness's own wrappers it wraps the expert layer's two
dispatch kernels (``ops/moe.py``: ``moe_permute``, ``moe_combine``), whose
bytes ``metrics/moe_dispatch_roofline.py`` reads, and zeroes the program's
``moe.expert_rows`` counter when set-up ends, so ``expert_load_max`` reads
the window's forwards.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from cebench.drivers.build import _calls
from cebench.lib import dsv2_cost, dsv2_world, models, reference, world
from cebench.lib import reference_deepseek_v2 as ref
from cebench.lib.harness import wrap_counting
from cebench.lib.trace import patch_everywhere
from cebench.lib.yardstick import rate_over_window


def make_ce(run):
    """The port's DeepseekV2CrossEncoder on the weights drawn from the
    run's seed. Every row it is handed is counted as ``ce_pairs``."""
    from anncur_tpu_torch.models.deepseek_v2 import DeepseekV2CrossEncoder, DeepseekV2Spec

    cfg, dep = run.cfg, run.cfg["deployment"]
    with run.spans.span("setup.weights"):
        dtype = models.DTYPES[dep["compute_dtype"]]
        ce = DeepseekV2CrossEncoder(DeepseekV2Spec.from_config(cfg), device=run.device,
                                    weights=dsv2_world.model_weights(cfg, run.seed, run.device, dtype),
                                    compute_dtype=dtype)
    wrap_counting(ce, "score", lambda a, kw: run.count("ce_pairs", int(np.shape(a[0])[0])))
    return ce


def install_dispatch_wrappers(run) -> None:
    """Record each ``moe_permute`` / ``moe_combine`` launch's (bytes,
    operations) in ``run.dispatch_costs`` while the harness records."""
    import anncur_tpu_torch.ops.moe  # noqa: F401  (loaded before patching)

    run.dispatch_costs = []

    def permute(fn):
        def moe_permute(x, dest):
            if run.launches.recording:
                n = x.shape[0]
                run.dispatch_costs.append(dsv2_cost.permute_cost(n, dest.numel() // n, x.shape[1], x.element_size()))
            return fn(x, dest)
        return moe_permute

    def combine(fn):
        def moe_combine(y, dest, weights, shared, residual):
            if run.launches.recording:
                n, k = weights.shape
                run.dispatch_costs.append(dsv2_cost.combine_cost(n, k, y.shape[1], y.element_size()))
            return fn(y, dest, weights, shared, residual)
        return moe_combine

    patch_everywhere("anncur_tpu_torch.ops.moe", "moe_permute", permute)
    patch_everywhere("anncur_tpu_torch.ops.moe", "moe_combine", combine)


def setup(run):
    from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
    from anncur_tpu_torch.models.deepseek_v2 import EXPERT_ROWS
    from anncur_tpu_torch.utils.tracker import TRACER

    prm = run.params
    ce = make_ce(run)
    install_dispatch_wrappers(run)
    items = dsv2_world.make_items(run)
    ments = dsv2_world.make_mentions(run, prm["mention_blocks"] * prm["ment_block"], "anchor_queries")
    builder = ScoreMatrixBuilder(ce, ment_block=prm["ment_block"], ent_block=prm["ent_block"],
                                 max_pairs_per_program=prm["max_pairs_per_program"], device=run.device)
    st = SimpleNamespace(ce=ce, items=items, ments=ments, builder=builder, slab=prm["slab"],
                         items_np=items.cpu().numpy(), ments_np=ments.cpu().numpy(), calls=[], out=[])
    with run.spans.span("setup.warmup"):
        builder(st.ments_np[:prm["ment_block"]], st.items_np[:st.slab])
    run.counters.clear()
    TRACER.reset_counter(EXPERT_ROWS)
    return st


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
    run.e2e["build_pairs_per_s"] = rate_over_window(st.calls, run.window_start, run.deadline)
    run.attempted = len(st.calls)
    run.counters.update(entries=sum(w for _, _, w in st.calls), calls=len(st.calls))
    flop = dsv2_cost.pair_flops(run.cfg, models.pair_len(run.cfg))
    run.model_work([(t0, t1, w * flop) for t0, t1, w in st.calls], closed=True)


def release(run, st):
    """Drop the program, its weights with it (the reference draws them
    again a layer at a time)."""
    st.builder = st.ce = None


def reference_scores(run, ments: torch.Tensor, ents: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(n,) f32 reference scores of (mention i, entity i) pairs, from the
    weights drawn again from the run's seed."""
    cfg = run.cfg
    toks = reference.pair_tokens(ments, ents, models.pair_len(cfg))
    embed, layer, final_norm, score = dsv2_world.reference_parts(cfg, run.seed, run.device)
    return ref.forward_scores(cfg, toks, embed, layer, final_norm, score, precision)


def check(run, st):
    """The delivered entries vs the reference's scores, at ``check_entries``
    entries drawn from the seed over every call: ``score_gap``, the widest
    gap, and ``score_gap_mean``, the mean one (a fault that moves every
    entry a little, such as a token sent to the wrong expert, shows in the
    mean long before the widest gap leaves bf16's own); ``bad_blocks``:
    blocks of the wrong shape or not finite."""
    prm = run.params
    rng = np.random.default_rng(world.subseed(run.seed, "check"))
    mb = prm["ment_block"]
    picks = []
    for _ in range(prm["check_entries"]):
        blk, e0, scores = st.out[int(rng.integers(len(st.out)))]
        i, j = int(rng.integers(scores.shape[0])), int(rng.integers(scores.shape[1]))
        picks.append((blk * mb + i, e0 + j, scores[i, j]))
    dev = st.items.device
    m = torch.as_tensor([p[0] for p in picks], device=dev)
    e = torch.as_tensor([p[1] for p in picks], device=dev)
    got = torch.as_tensor([p[2] for p in picks], dtype=torch.float32, device=dev)
    gap = (got - reference_scores(run, st.ments[m], st.items[e])).abs()
    run.check("score_gap", float(gap.max()))
    run.check("score_gap_mean", float(gap.mean()))
    shape_ok = all(s.shape == (mb, min(e0 + st.slab, st.items_np.shape[0]) - e0) and np.isfinite(s).all()
                   for _, e0, s in st.out)
    run.check("bad_blocks", 0 if shape_ok else 1, 0)


def control(run):
    """The control's ``score_gap`` and ``score_gap_mean``: the reference in
    float8 e4m3 against the f32 reference, at as many entries as a run's
    check draws."""
    prm, dep = run.params, run.cfg["deployment"]
    items = dsv2_world.make_items(run)
    ments = dsv2_world.make_mentions(run, prm["mention_blocks"] * prm["ment_block"], "anchor_queries")
    rng = np.random.default_rng(world.subseed(run.seed, "check"))
    m = torch.as_tensor(rng.integers(ments.shape[0], size=prm["check_entries"]), device=run.device)
    e = torch.as_tensor(rng.integers(dep["n_items"], size=prm["check_entries"]), device=run.device)
    gap = (reference_scores(run, ments[m], items[e], reference.CONTROL_CE) - reference_scores(run, ments[m], items[e])).abs()
    return {"score_gap": float(gap.max()), "score_gap_mean": float(gap.mean())}
