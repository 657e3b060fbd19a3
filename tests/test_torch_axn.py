"""Port parity, AXN and host ADACUR: ``core/axn.py`` (completions, never
embeddings: singular vectors are defined up to sign and rotation),
``axn_complete_batched``, the fused engine and its oracle entry points with
``method='axn'``, the host round loop ``core/adaptive.py`` with the CUR and
the AXN completion, and the retriever's ``query_tokens_adaptive`` and
``query_tokens_adaptive_fused(method='axn')``, against the JAX package on
the CPU with the same numpy inputs.

As in ``tests/test_torch_adaptive.py``, the engines are compared on
full-rank train matrices whose rows are well separated, with every AXN
solve well conditioned: the fit rank r stays at or below the number of
scored ids S, so the (r x r) Gram has full rank (with S < r the ridge
alone fixes r - S directions, and rounding moves the picks). There both
packages pick the same ids; scored ids, top ids and top scores are then
exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anncur_tpu.core.adaptive as jada
import anncur_tpu.core.adaptive_fused as jaf
import anncur_tpu.core.axn as jaxn
from test_torch_adaptive import _assert_same_run, _load_trained, _matrix
from test_torch_retriever import _assert_same_topk, _build_both, world  # noqa: F401  (world: a fixture)

from anncur_tpu_torch.core import adaptive as tada
from anncur_tpu_torch.core import adaptive_fused as taf
from anncur_tpu_torch.core import axn as taxn

torch.set_num_threads(2)  # xdist runs several test files side by side
CPU = "cpu"


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


def test_axn_completions_match_jax():
    """axn_complete (one shared scored set) and axn_complete_batched
    (per-query sets, with cols and dim_cap_frac) within 1e-4 relative of
    JAX's, each from its own package's fit; a fit on a rotated basis
    (signs flipped) completes the same."""
    full, train = _matrix(noise=0.5, q=12, m=400, n_train=48)
    idx_t = taxn.fit_item_embeddings(train, rank=40, device=CPU)
    idx_j = jaxn.fit_item_embeddings(train, rank=40)
    assert idx_t.rank == 40 and idx_t.item_embeds.shape == (400, 40)
    ids = np.arange(0, 400, 9)  # 45 shared ids
    got = taxn.axn_complete(idx_t, torch.as_tensor(ids), torch.as_tensor(full[:, ids]), lam=1e-3)
    want = jaxn.axn_complete(idx_j, jnp.asarray(ids), jnp.asarray(full[:, ids]), lam=1e-3)
    assert _rel_err(got, want) < 1e-4
    flipped = taxn.AxnIndex(item_embeds=-idx_t.item_embeds, mean=idx_t.mean)
    assert _rel_err(taxn.axn_complete(flipped, torch.as_tensor(ids), torch.as_tensor(full[:, ids]), lam=1e-3), got) < 1e-4

    rng = np.random.default_rng(1)
    per_q = np.stack([rng.choice(400, 30, replace=False) for _ in range(12)])
    vals = np.take_along_axis(full, per_q, axis=1)
    cols = rng.choice(400, 50, replace=False)
    for kw in ({}, {"cols": cols}, {"dim_cap_frac": 0.5}):
        got = taf.axn_complete_batched(idx_t.item_embeds, idx_t.mean, torch.as_tensor(per_q), torch.as_tensor(vals),
                                       1e-2, **{k: torch.as_tensor(v) if k == "cols" else v for k, v in kw.items()})
        want = jaf.axn_complete_batched(idx_j.item_embeds, idx_j.mean, jnp.asarray(per_q, jnp.int32),
                                        jnp.asarray(vals), 1e-2, **{k: jnp.asarray(v) if k == "cols" else v
                                                                    for k, v in kw.items()})
        assert got.shape == want.shape and _rel_err(got, want) < 1e-4, kw
    # the engine's kernel-B pair: [q_emb, 1] against [E, mean] is the completion
    side_q = taf.axn_query_side(idx_t.item_embeds, idx_t.mean, torch.as_tensor(per_q), torch.as_tensor(vals))
    side_i = taf.axn_item_side(idx_t, 416)
    assert side_i.shape == (416, 41) and float(side_i[400:].abs().max()) == 0.0
    full_c = taf.axn_complete_batched(idx_t.item_embeds, idx_t.mean, torch.as_tensor(per_q), torch.as_tensor(vals))
    assert _rel_err((side_q @ side_i.T)[:, :400], full_c) < 1e-5


def test_fit_cache_is_keyed_by_content():
    _, train = _matrix(q=4, m=200, n_train=32)
    a = taxn.fit_item_embeddings_cached(train, 16, device=CPU)
    assert taxn.fit_item_embeddings_cached(train.copy(), 16, device=CPU) is a
    other = train.copy()
    other[0, 0] += 1.0
    assert taxn.fit_item_embeddings_cached(other, 16, device=CPU) is not a
    assert taxn.fit_item_embeddings_cached(torch.as_tensor(train), 16, device=CPU) is a


@pytest.mark.parametrize(
    "budget,rounds,rank,seed,kw",
    [(48, 3, 16, 1, {}), (40, 4, 10, 2, {}), (60, 4, 15, 3, {"shortlist": 1000})],
)
def test_adaptive_topk_oracle_axn_matches_jax(budget, rounds, rank, seed, kw):
    """q=48, m=1,200, a rank-64 train matrix, every solve at S >= r: the
    same scored ids, top ids and scores."""
    full, train = _matrix(noise=0.5)
    got = taf.adaptive_topk_oracle(full, train, budget, rounds, top_k=10, seed=seed, method="axn",
                                   axn_rank=rank, device=CPU, **kw)
    want = jaf.adaptive_topk_oracle(full, train, budget, rounds, top_k=10, seed=seed, method="axn",
                                    axn_rank=rank, **kw)
    _assert_same_run(got, want)
    assert all(len(set(row)) == budget for row in got[2].tolist())


def test_axn_early_stop_and_recall_oracles_match_jax():
    full, train = _matrix(noise=0.5)
    kw = dict(top_k=10, seed=2, method="axn", axn_rank=8)
    got = taf.adaptive_topk_oracle_early_stop(full, train, 24, 3, 40, 2, device=CPU, **kw)
    want = jaf.adaptive_topk_oracle_early_stop(full, train, 24, 3, 40, 2, **kw)
    np.testing.assert_array_equal(got["top_ids"], np.asarray(want["top_ids"]))
    np.testing.assert_array_equal(got["top_scores"], np.asarray(want["top_scores"]))
    for key in ("avg_budget", "frac_escalated", "stable_frac"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    assert taf.adaptive_recall_oracle_early_stop(full, train, 24, 3, 40, 2, device=CPU, **kw) == pytest.approx(
        jaf.adaptive_recall_oracle_early_stop(full, train, 24, 3, 40, 2, **kw), abs=1e-6)
    assert taf.adaptive_recall_oracle(full, train, 40, 4, method="axn", axn_rank=10, device=CPU) == pytest.approx(
        jaf.adaptive_recall_oracle(full, train, 40, 4, method="axn", axn_rank=10), abs=1e-6)


def test_axn_recall_on_committed_trained_ce_matrix_and_matched_budget():
    """The quick trained-CE matrix through AXN (rank 16, S >= 20): the
    port's recall@10 equals JAX's within 1e-6; and matched_recall_budget
    with method='axn' reports the same sweep."""
    full, train = _load_trained("trained_ce_matrix_quick.npz")
    got = taf.adaptive_recall_oracle(full, train, 60, 3, method="axn", axn_rank=16, device=CPU)
    want = jaf.adaptive_recall_oracle(full, train, 60, 3, method="axn", axn_rank=16)
    assert got == pytest.approx(want, abs=1e-6)
    full, train = _matrix(noise=1.0, q=24, m=600, n_train=48)
    kw = dict(fixed_n_anchors=40, fixed_top_k_retvr=20, n_rounds=3, seeds=(0, 1), budgets=(30, 40), method="axn",
              axn_rank=8)
    got = taf.matched_recall_budget(full, train, device=CPU, **kw)
    want = jaf.matched_recall_budget(full, train, **kw)
    assert got["matched_budget"] == want["matched_budget"] and got["axn_rank"] == 8
    for b, r in want["adaptive_sweep"].items():
        assert got["adaptive_sweep"][b] == pytest.approx(r, abs=1e-6)


@pytest.mark.parametrize("rounds,budget", [(3, 45), (1, 20), (4, 4)])
def test_host_adaptive_cur_query_matches_jax(rounds, budget):
    """The host round loop with the f64 pinv completion and the same
    numpy oracle scorer: the same ids and scores, and the same union
    scoring calls; budget 4 < top_k fills with -1 / -inf."""
    full, train = _matrix(noise=0.5, q=10, m=300, n_train=64)
    calls_t, calls_j = [], []

    def scorer(calls):
        def fn(ids):
            calls.append(np.asarray(ids).copy())
            return full[:, ids]
        return fn

    got = tada.adaptive_cur_query(train, scorer(calls_t), 300, budget, rounds, top_k=10, seed=rounds)
    want = jada.adaptive_cur_query(train, scorer(calls_j), 300, budget, rounds, top_k=10, seed=rounds)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(calls_t) == len(calls_j) and all(np.array_equal(a, b) for a, b in zip(calls_t, calls_j))
    if budget < 10:
        assert (got[1][:, budget:] == -1).all() and np.isneginf(got[0][:, budget:]).all()
    ada_t = tada.adaptive_recall_vs_fixed(full, train, 40, 3, 10, seed=1, device=CPU)
    ada_j = jada.adaptive_recall_vs_fixed(full, train, 40, 3, 10, seed=1)
    assert ada_t == pytest.approx(ada_j, abs=1e-6)


def test_axn_query_matches_jax():
    full, train = _matrix(noise=0.5, q=6, m=300, n_train=64)
    idx_t = taxn.fit_item_embeddings(train, 16, device=CPU)
    idx_j = jaxn.fit_item_embeddings(train, 16)
    for budget, rounds in ((60, 3), (5, 1)):
        s_t, i_t = taxn.axn_query(idx_t, lambda ids: full[:, ids], 300, budget, rounds, top_k=8, seed=4)
        s_j, i_j = jaxn.axn_query(idx_j, lambda ids: full[:, ids], 300, budget, rounds, top_k=8, seed=4)
        np.testing.assert_array_equal(i_t, i_j)
        np.testing.assert_array_equal(s_t, s_j)


# ---------------------------------------------------------------- retriever


@pytest.mark.parametrize(
    "kw",
    [
        dict(total_budget=12, n_rounds=3, method="axn"),
        dict(total_budget=10, n_rounds=2, escalate_budget=18, escalate_rounds=2, stability_overlap=1.01,
             method="axn", axn_rank=12),
    ],
)
def test_query_tokens_adaptive_fused_axn_matches_jax(world, kw):  # noqa: F811
    """The tiny-CE world (32 items, 16 train rows): AXN serving of the
    port against JAX's, base rounds and every query escalating."""
    ment = world[0]
    r_j, r_t = _build_both(world)
    s_j, i_j, st_j = r_j.query_tokens_adaptive_fused(ment[16:], top_k=5, return_stats=True, **kw)
    s_t, i_t, st_t = r_t.query_tokens_adaptive_fused(ment[16:], top_k=5, return_stats=True, **kw)
    _assert_same_topk(s_t, i_t, s_j, i_j)
    assert st_t == pytest.approx(st_j)
    assert all(len(set(row)) == 5 for row in i_t.tolist())


def test_query_tokens_adaptive_host_matches_jax(world):  # noqa: F811
    ment = world[0]
    r_j, r_t = _build_both(world)
    for budget, rounds in ((12, 3), (3, 1)):
        s_j, i_j = r_j.query_tokens_adaptive(ment[16:], total_budget=budget, n_rounds=rounds, top_k=5)
        s_t, i_t = r_t.query_tokens_adaptive(ment[16:], total_budget=budget, n_rounds=rounds, top_k=5)
        if budget >= 5:
            _assert_same_topk(s_t, i_t, s_j, i_j)
        else:  # 3 scored ids: the rest is -1 / -inf, in external-id space
            assert (i_t[:, 3:] == -1).all() and np.isneginf(s_t[:, 3:]).all()
            _assert_same_topk(s_t[:, :3], i_t[:, :3], np.asarray(s_j)[:, :3], np.asarray(i_j)[:, :3])
    # the train matrix is copied to the host once per cache fill
    held = r_t._host_complete
    assert held is not None
    r_t.query_tokens_adaptive(ment[16:], total_budget=12, n_rounds=3, top_k=5)
    assert r_t._host_complete is held
    r_t.add_items(world[1][32:34], world[7])
    assert r_t._host_complete is None


def test_axn_fit_caches_follow_the_corpus_and_the_caller(world, monkeypatch):  # noqa: F811
    """The retriever's own AXN fit is cached by (rank, shape) and dropped by
    add_items/remove_items; a caller's train tensor is copied to the host
    and fitted once while it is unchanged, again after an in-place edit."""
    from anncur_tpu_torch.core import axn as taxn

    ment, ent, _, _, _, _, _, builder_t = world
    _, r_t = _build_both(world)
    r_t.query_tokens_adaptive_fused(ment[16:20], total_budget=8, n_rounds=2, method="axn")
    assert list(r_t._axn_cache) == [(16, (16, 32))]
    r_t.add_items(ent[32:34], builder_t)
    assert r_t._axn_cache == {}
    copies, fits = [], []
    host_f32, fit = taxn._host_f32, taxn.fit_item_embeddings
    monkeypatch.setattr(taxn, "_host_f32", lambda t: copies.append(1) or host_f32(t))
    monkeypatch.setattr(taxn, "fit_item_embeddings", lambda *a, **kw: fits.append(1) or fit(*a, **kw))
    monkeypatch.setattr(taxn, "_FIT_CACHE", {})
    monkeypatch.setattr(taxn, "_TENSOR_DIGESTS", {})
    train = torch.as_tensor(r_t._train_matrix()[:34].T.clone())
    kw = dict(total_budget=8, n_rounds=2, top_k=3, method="axn")
    _, i0 = r_t.query_tokens_adaptive_fused(ment[16:20], train_scores=train, **kw)
    assert (len(copies), len(fits)) == (1, 1)
    r_t.query_tokens_adaptive_fused(ment[16:20], train_scores=train, **kw)
    assert (len(copies), len(fits)) == (1, 1)
    train.mul_(2.0)
    r_t.query_tokens_adaptive_fused(ment[16:20], train_scores=train, **kw)
    assert (len(copies), len(fits)) == (2, 2)
    _, i1 = r_t.query_tokens_adaptive_fused(ment[16:20], total_budget=8, n_rounds=2, top_k=3, method="axn")
    np.testing.assert_array_equal(i0, i1)  # the caller's matrix is the index's own
