"""Port parity, adaptive serving: ``anncur_tpu_torch.core.adaptive_fused``,
``core.metrics`` and ``CurRetriever.query_tokens_adaptive_fused`` against
the JAX package on the CPU, with the same numpy inputs; and the plain
kernel B with an exclusion list, and the signed-zero order, against
``lax.top_k``. Kernel B itself is held to the plain version on the card
(``tests/test_torch_cuda.py``).

The completions of the two packages differ in rounding (other solvers and
sum orders), so the engine parity runs on matrices whose rows are well
separated and whose ridge solves stay below the train rank, where both
pick the same ids; there scored ids, top ids and top scores are exactly
equal (the scores are entries of one matrix).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import anncur_tpu.core.adaptive_fused as jaf
from anncur_tpu.core import metrics as jmetrics
from anncur_tpu.ops import mips as jmips
from test_torch_retriever import _assert_same_topk, _build_both, world  # noqa: F401  (world: a fixture)

from anncur_tpu_torch.core import adaptive_fused as taf
from anncur_tpu_torch.core import metrics as tmetrics
from anncur_tpu_torch.ops.mips import masked_topk, mips_topk, topk_stable

torch.set_num_threads(2)  # xdist runs several test files side by side

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks")


def _matrix(noise=0.0, q=48, m=1200, n_train=64, seed=0):
    """(full (q, m), train (n_train, m)) f32: query rows in the train rows'
    span plus ``noise`` outside it; row values spread ~8 apart at the top."""
    rng = np.random.default_rng(seed)
    train = rng.standard_normal((n_train, m)).astype(np.float32)
    full = rng.standard_normal((q, n_train)).astype(np.float32) @ train
    full = (full + noise * rng.standard_normal((q, m))).astype(np.float32)
    return full, train


def _assert_same_run(got, want):
    """(top scores, top ids, scored ids) of the port and JAX: exactly equal."""
    s_t, i_t, sc_t = got
    s_j, i_j, sc_j = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(sc_t, sc_j)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(s_t, s_j)


def test_split_rounds_matches_jax_on_a_grid():
    for budget in range(1, 260, 7):
        for rounds in range(1, 12):
            assert taf.split_rounds(budget, rounds) == jaf.split_rounds(budget, rounds)


def test_take_per_row_matches_jax():
    rng = np.random.default_rng(1)
    mat = rng.standard_normal((7, 50)).astype(np.float32)
    ids = rng.integers(0, 50, size=(7, 9))
    got = taf.take_per_row(torch.as_tensor(mat), torch.as_tensor(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jaf.take_per_row(jnp.asarray(mat), jnp.asarray(ids, jnp.int32))))


@pytest.mark.parametrize("s", [5, 40])
def test_ridge_complete_matches_jax_and_an_f64_pinv(s):
    """At S below the train rank the ridge (λ = 1e-6 of the Gram's mean
    diagonal) is the pinv completion: both packages within rel 1e-4 of the
    f64 ``vals @ pinv(C) @ train`` and of each other (f32 solves), on all
    columns and on a column subset."""
    full, train = _matrix(noise=0.3, q=6, m=300)
    rng = np.random.default_rng(s)
    ids = np.stack([rng.choice(300, size=s, replace=False) for _ in range(6)])
    vals = np.take_along_axis(full, ids, axis=1)
    want = np.stack([
        vals[r].astype(np.float64) @ np.linalg.pinv(train[:, ids[r]].astype(np.float64)) @ train.astype(np.float64)
        for r in range(6)
    ])
    train_t = torch.as_tensor(train.T.copy())
    got = taf.ridge_complete(train_t, torch.as_tensor(ids), torch.as_tensor(vals)).numpy()
    jax_out = np.asarray(jaf.ridge_complete(jnp.asarray(train), jnp.asarray(ids, jnp.int32), jnp.asarray(vals)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=1e-4 * scale)
    cols = np.array([3, 299, 0, 150])
    got_c = taf.ridge_complete(train_t, torch.as_tensor(ids), torch.as_tensor(vals), cols=torch.as_tensor(cols)).numpy()
    np.testing.assert_allclose(got_c, got[:, cols], rtol=0, atol=1e-5 * scale)


def test_ridge_runs_in_true_f32_whatever_the_caller_set():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with taf._true_f32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


SIGNED_ZERO_ROWS = np.array(
    [[0.0, -0.0, 1.0, -0.0, 0.0, -1.0, -0.0, 0.0], [-0.0, -0.0, 0.0, -np.inf, -0.0, 0.0, 2.0, -0.0]], np.float32
)


def test_signed_zero_rows_rank_as_jax():
    """+0.0 ranks above -0.0, then ties to the lowest index, as lax.top_k:
    ``topk_stable`` (the fixed-anchor rerank's and CurIndex.topk_in_row's
    top-k) and ``masked_topk``; the plain kernel B sorts the same keys."""
    rows = SIGNED_ZERO_ROWS
    for k in (3, 8):
        s_j, i_j = lax.top_k(jnp.asarray(rows), k)
        s_t, i_t = topk_stable(torch.as_tensor(rows), k)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(np.signbit(s_t.numpy()), np.signbit(np.asarray(s_j)))
        valid = np.array([True] * 7 + [False])
        s_jm, i_jm = jmips.masked_topk(jnp.asarray(rows), k, jnp.asarray(valid))
        s_tm, i_tm = masked_topk(torch.as_tensor(rows), k, torch.as_tensor(valid))
        np.testing.assert_array_equal(i_tm.numpy(), np.asarray(i_jm))
        np.testing.assert_array_equal(np.signbit(s_tm.numpy()), np.signbit(np.asarray(s_jm)))
    assert topk_stable(torch.as_tensor(rows[0]), 8)[1].tolist() == [2, 0, 4, 7, 1, 3, 6, 5]


def _jax_excluded_topk(queries, items, k, n_valid, exclude):
    """JAX's pick: approx with padded columns and excluded ids at -inf
    (``adaptive_fused.py:237-245``), then lax.top_k."""
    approx = jnp.dot(jnp.asarray(queries), jnp.asarray(items).T, precision="highest")
    approx = jnp.where(jnp.arange(items.shape[0])[None, :] < n_valid, approx, -jnp.inf)
    if exclude.shape[1]:
        keep = (exclude >= 0) & (exclude < n_valid)
        rows = np.broadcast_to(np.arange(queries.shape[0])[:, None], exclude.shape)
        approx = approx.at[rows[keep], exclude[keep]].set(-jnp.inf)
    return lax.top_k(approx, k)


@pytest.mark.parametrize(
    "q,n,d,n_valid,n_ex,k",
    [
        (5, 300, 8, 300, 0, 20),  # S = 0
        (4, 300, 8, 280, 30, 7),
        (3, 500, 4, 450, 40, 410),  # k = n_valid - S: every candidate left
        (6, 2500, 16, 2400, 64, 100),  # ids past n_valid, duplicates, -1s
        (2, 9000, 3, 9000, 210, 8790),  # heavy ties (d = 3), k = n_valid - S
    ],
)
def test_plain_mips_exclusions_match_jax(q, n, d, n_valid, n_ex, k):
    """The plain ``mips_topk(..., exclude=)`` equals JAX's ``.at[].set(-inf)``
    + ``lax.top_k`` on small-integer inputs (exact products, many ties):
    the excluded ids hold each row's best scores, with duplicates,
    negatives and ids past n_valid among them."""
    rng = np.random.default_rng(n + n_ex)
    queries = rng.integers(-2, 3, size=(q, d)).astype(np.float32)
    items = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    best = np.argsort(-(queries @ items[:n_valid].T), axis=1, kind="stable")[:, :n_ex]
    exclude = best.copy()
    if n_ex >= 8:
        exclude[:, 1] = exclude[:, 0]
        exclude[:, 2] = -1
        exclude[:, 3] = n_valid + (n - n_valid) // 2 if n_valid < n else -5
    s_t, i_t = mips_topk(torch.as_tensor(queries), torch.as_tensor(items), k, n_valid, torch.as_tensor(exclude))
    s_j, i_j = _jax_excluded_topk(queries, items, k, n_valid, exclude)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    for r in range(q):
        assert not set(i_t[r].tolist()) & set(exclude[r].tolist())
    # int32 lists are taken as well, and an exhausted budget is refused
    i_32 = mips_topk(torch.as_tensor(queries), torch.as_tensor(items), k, n_valid, torch.as_tensor(exclude, dtype=torch.int32))[1]
    assert torch.equal(i_32, i_t)
    if n_ex:
        with pytest.raises(ValueError, match="fewer than k"):
            mips_topk(torch.as_tensor(queries), torch.as_tensor(items), n_valid - n_ex + 1, n_valid, torch.as_tensor(exclude))


@pytest.mark.parametrize(
    "budget,rounds,noise,seed",
    [(80, 4, 0.0, 1), (60, 3, 4.0, 2), (33, 5, 1.0, 3), (20, 1, 1.0, 4)],
)
def test_adaptive_topk_oracle_matches_jax(budget, rounds, noise, seed):
    """q=48, m=1,200, n_train=64, solves at S <= 60: scored ids (in pick
    order), top ids and top scores exactly equal."""
    full, train = _matrix(noise)
    got = taf.adaptive_topk_oracle(full, train, budget, rounds, top_k=10, seed=seed, device="cpu")
    want = jaf.adaptive_topk_oracle(full, train, budget, rounds, top_k=10, seed=seed)
    _assert_same_run(got, want)
    assert got[2].shape == (48, budget)
    assert all(len(set(row)) == budget for row in got[2].tolist())


@pytest.mark.parametrize("overlap", [1.0, 0.8])
def test_adaptive_topk_oracle_early_stop_matches_jax(overlap):
    full, train = _matrix(noise=0.5)
    got = taf.adaptive_topk_oracle_early_stop(full, train, 40, 3, 80, 2, top_k=10, seed=2,
                                              stability_overlap=overlap, device="cpu")
    want = jaf.adaptive_topk_oracle_early_stop(full, train, 40, 3, 80, 2, top_k=10, seed=2,
                                               stability_overlap=overlap)
    np.testing.assert_array_equal(got["top_ids"], np.asarray(want["top_ids"]))
    np.testing.assert_array_equal(got["top_scores"], np.asarray(want["top_scores"]))
    for key in ("avg_budget", "frac_escalated", "stable_frac"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key


@pytest.mark.parametrize("budget,rounds,shortlist", [(80, 4, 1100), (60, 3, 1000)])
def test_adaptive_shortlist_matches_jax(budget, rounds, shortlist):
    """The batch-shared pool of rounds 2+: the same picks as JAX's, and no
    query scores an item twice."""
    full, train = _matrix(noise=1.0)
    got = taf.adaptive_topk_oracle(full, train, budget, rounds, top_k=10, seed=5, shortlist=shortlist, device="cpu")
    want = jaf.adaptive_topk_oracle(full, train, budget, rounds, top_k=10, seed=5, shortlist=shortlist)
    _assert_same_run(got, want)
    assert all(len(set(row)) == budget for row in got[2].tolist())


@pytest.mark.parametrize("budget,rounds,kw", [(60, 3, {}), (57, 3, {}), (80, 4, {"shortlist": 1100})])
def test_wide_round_tiling_identical(monkeypatch, budget, rounds, kw):
    """One pick of ``per`` (the port; kernel B takes any k) equals JAX's
    tiled sub-picks of ROUND_WIDTH_CAP (patched to 7 in JAX only: per=20
    -> 7/7/6, per=19 -> 7/6/6): lowest-index ties make them the same ids
    in the same order."""
    full, train = _matrix(noise=1.0)
    monkeypatch.setattr(jaf, "ROUND_WIDTH_CAP", 7)
    jaf._oracle_fn.cache_clear()  # cached programs bake the cap in
    try:
        assert len(jaf._split_width(taf.split_rounds(budget, rounds)[1])) == 3
        want = jaf.adaptive_topk_oracle(full, train, budget, rounds, top_k=10, seed=6, **kw)
    finally:
        jaf._oracle_fn.cache_clear()
    got = taf.adaptive_topk_oracle(full, train, budget, rounds, top_k=10, seed=6, device="cpu", **kw)
    _assert_same_run(got, want)


def _load_trained(name):
    d = np.load(os.path.join(BENCH, name))
    scores = np.asarray(d["scores"], np.float32)
    n_train, n_q = int(d["n_train"]), int(d["n_q"])
    return scores[n_train:n_train + n_q], scores[:n_train]


@pytest.mark.parametrize("name", ["trained_ce_matrix_quick.npz", "trained_ce_matrix_hard_quick.npz"])
def test_recall_on_committed_trained_ce_matrix_matches_jax(name):
    """adaptive_recall_oracle (and its early-stop form, and fixed-anchor
    recall) on the committed quick trained-CE matrices: the port's equal
    JAX's (recall means in f32, summed in other orders: 1e-6)."""
    full, train = _load_trained(name)
    for budget, rounds in ((30, 3), (60, 3)):
        got = taf.adaptive_recall_oracle(full, train, budget, rounds, device="cpu")
        assert got == pytest.approx(jaf.adaptive_recall_oracle(full, train, budget, rounds), abs=1e-6)
        ids_t = taf.adaptive_topk_oracle(full, train, budget, rounds, device="cpu")[1]
        np.testing.assert_array_equal(ids_t, np.asarray(jaf.adaptive_topk_oracle(full, train, budget, rounds)[1]))
    got = taf.adaptive_recall_oracle_early_stop(full, train, 20, 2, 40, 2, device="cpu")
    assert got == pytest.approx(jaf.adaptive_recall_oracle_early_stop(full, train, 20, 2, 40, 2), abs=1e-6)
    assert taf.fixed_anchor_recall(full, train, 50, 20, 10, device="cpu") == pytest.approx(
        jaf.fixed_anchor_recall(full, train, 50, 20, 10), abs=1e-6)


def test_matched_recall_budget_matches_jax():
    full, train = _matrix(noise=1.0, q=24, m=600, n_train=48)
    kw = dict(fixed_n_anchors=40, fixed_top_k_retvr=20, n_rounds=3, seeds=(0, 1), budgets=(30, 45, 60))
    got = taf.matched_recall_budget(full, train, device="cpu", **kw)
    want = jaf.matched_recall_budget(full, train, **kw)
    assert got["matched_budget"] == want["matched_budget"]
    assert got["fixed_recall"] == pytest.approx(want["fixed_recall"], abs=1e-6)
    for b, r in want["adaptive_sweep"].items():
        assert got["adaptive_sweep"][b] == pytest.approx(r, abs=1e-6)


def test_axn_and_cuda_defaults_raise():
    """method='axn' runs (tests/test_torch_axn.py holds it to JAX's), an
    unknown method raises, and the default device is CUDA."""
    full, train = _matrix(q=4, m=100, n_train=16)
    s, i, scored = taf.adaptive_topk_oracle(full, train, 20, 2, method="axn", device="cpu")
    assert i.shape == (4, 10) and scored.shape == (4, 20) and all(len(set(r)) == 20 for r in scored.tolist())
    with pytest.raises(ValueError, match="method"):
        taf.adaptive_topk_oracle(full, train, 20, 2, method="svd", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            taf.adaptive_topk_oracle(full, train, 20, 2)


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    gt = rng.integers(0, 30, size=40)
    pred = np.stack([rng.choice(30, size=10, replace=False) for _ in range(40)])
    scores = rng.integers(0, 4, size=(40, 10)).astype(np.float32)  # ties keep their order
    np.testing.assert_allclose(
        tmetrics.reciprocal_ranks(gt, pred, scores).numpy(),
        np.asarray(jmetrics.reciprocal_ranks(jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(scores))),
        rtol=1e-7,
    )
    assert tmetrics.score_topk_preds(gt, pred, scores) == jmetrics.score_topk_preds(gt, pred, scores)
    other = np.stack([rng.choice(30, size=10, replace=False) for _ in range(40)])
    np.testing.assert_array_equal(
        tmetrics.topk_overlap_frac(pred, other).numpy(), np.asarray(jmetrics.topk_overlap_frac(jnp.asarray(pred), jnp.asarray(other)))
    )
    assert tmetrics.overlap_metrics(pred, other) == jmetrics.overlap_metrics(pred, other)
    assert tmetrics.overlap_metrics(pred[:0], other[:0]) == jmetrics.overlap_metrics(pred[:0], other[:0])
    a, b = rng.standard_normal((20, 30)), rng.standard_normal((20, 30))
    got, want = tmetrics.frobenius_error(a, b), jmetrics.frobenius_error(a, b)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-6)


# ---------------------------------------------------------------- retriever


@pytest.mark.parametrize(
    "kw",
    [
        dict(total_budget=12, n_rounds=3),
        dict(total_budget=10, n_rounds=2, escalate_budget=18, escalate_rounds=2, stability_overlap=1.01),
        dict(total_budget=9, n_rounds=3, escalate_budget=15, escalate_rounds=2),
    ],
)
def test_query_tokens_adaptive_fused_matches_jax(world, kw):  # noqa: F811
    """The tiny-CE world of ``test_torch_retriever.py`` (32 items, 16 train
    rows): the port's adaptive serving against JAX's, base rounds and with
    per-query early stopping, checked as the fixed-anchor path is."""
    ment = world[0]
    r_j, r_t = _build_both(world)
    s_j, i_j, st_j = r_j.query_tokens_adaptive_fused(ment[16:], top_k=5, return_stats=True, **kw)
    s_t, i_t, st_t = r_t.query_tokens_adaptive_fused(ment[16:], top_k=5, return_stats=True, **kw)
    _assert_same_topk(s_t, i_t, s_j, i_j)
    assert st_t == pytest.approx(st_j)
    # the scores returned are the CE's scores of the ids returned
    assert all(len(set(row)) == 5 for row in i_t.tolist())


def test_adaptive_train_guard_and_cache(world):  # noqa: F811
    """A train matrix over another item set is refused; add_items and
    remove_items drop the cached train matrix, which then follows the
    corpus; an explicit train matrix (host or tensor) gives the same answer
    as the index's own."""
    ment, ent, _, _, _, _, _, builder_t = world
    r_j, r_t = _build_both(world)
    train = np.asarray(r_j.index.reconstruct())  # (16, 32)
    with pytest.raises(ValueError, match="item columns"):
        r_t.query_tokens_adaptive_fused(ment[16:20], total_budget=8, train_scores=train[:, :-1])
    _, i0 = r_t.query_tokens_adaptive_fused(ment[16:20], total_budget=8, n_rounds=2, top_k=3)
    _, i1 = r_t.query_tokens_adaptive_fused(ment[16:20], total_budget=8, n_rounds=2, top_k=3,
                                             train_scores=torch.as_tensor(r_t.index.reconstruct()))
    np.testing.assert_array_equal(i0, i1)
    t_before = r_t._train_matrix()
    assert t_before.shape == (r_t._padded_n_items(), 16) and r_t._train_t is t_before
    r_t.add_items(ent[32:36], builder_t)
    assert r_t._train_t is None
    t_after = r_t._train_matrix()
    np.testing.assert_allclose(t_after[:32].numpy(), t_before[:32].numpy(), rtol=1e-5, atol=1e-5)
    assert float(t_after[36:].abs().max()) == 0.0 and float(t_after[32:36].abs().max()) > 0
    anchors = set(int(a) for a in r_t.anchor_item_ids)
    drop = [i for i in (1, 5, 33) if i not in anchors][:2]
    r_t.remove_items(drop)
    assert r_t._train_t is None
    _, ids = r_t.query_tokens_adaptive_fused(ment[16:20], total_budget=8, n_rounds=2, top_k=3)
    assert not set(drop) & set(ids.ravel().tolist())
    # AXN serving follows the edited corpus too
    _, ids = r_t.query_tokens_adaptive_fused(ment[16:20], total_budget=8, method="axn")
    assert ids.shape == (4, 8) and not set(drop) & set(ids.ravel().tolist())
