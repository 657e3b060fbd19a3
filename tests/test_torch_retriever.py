"""Port parity, serving: the fixed-anchor CurRetriever (anchor CE scores ->
latent projection + top-k_retvr -> exact rerank -> top-k) against the
JAX package's, before and after add_items / remove_items, and its state
files across the two packages (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.core.retriever import CurRetriever as JaxRetriever
from anncur_tpu.data.synthetic import make_tokenized_world
from anncur_tpu.indexer.score_matrix import ScoreMatrixBuilder as JaxBuilder
from anncur_tpu.models.bert import BertSpec as JaxBertSpec
from anncur_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder

from anncur_tpu_torch.core.retriever import CurRetriever
from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.convert import crossencoder_from_jax_params
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer

torch.set_num_threads(2)  # xdist runs several test files side by side

# At the default init scale (0.02) a random tiny CE scores near rank one
# (score std ~6e-5); at 0.3 its matrix has a real spectrum (s2/s1 ~ 0.24)
# and ranking to check. Larger scales amplify f32 rounding through the
# layers (at 0.5 the two frameworks' CE scores differ by 2e-5 of their
# scale). Neighbouring scores can still sit closer than that rounding
# apart, so ids are compared only where the JAX score is more than GAP
# from both neighbours.
INIT_RANGE = 0.3
GAP = 1e-4
N0 = 32  # items at build time; 8 more arrive through add_items


def _assert_same_topk(s_t, i_t, s_j, i_j):
    s_j, i_j = np.asarray(s_j), np.asarray(i_j)
    assert s_t.shape == s_j.shape and i_t.shape == i_j.shape
    # f32 on both sides, summed in other orders: 1e-4, or 1e-5 of the score
    # scale where the latent projection spreads the scores wider
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=max(1e-4, 1e-5 * np.abs(s_j).max()))
    gaps = -np.diff(s_j, axis=1)
    sep = np.ones(s_j.shape, bool)
    sep[:, :-1] &= gaps > GAP
    sep[:, 1:] &= gaps > GAP
    assert sep.mean() > 0.3, "too few separated scores: the check would be vacuous"
    np.testing.assert_array_equal(i_t[sep], i_j[sep])


@pytest.fixture(scope="module")
def world():
    ment, ent, _, tok = make_tokenized_world(seed=9, n_ents=40, n_ments=24, max_ment_len=16, max_ent_len=16)
    kw = dict(vocab_size=tok.vocab_size, max_position_embeddings=64, initializer_range=INIT_RANGE)
    ce_j = JaxCrossEncoder(spec=JaxBertSpec.tiny(**kw), compute_dtype=jnp.float32)
    params = ce_j.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    ce_t = crossencoder_from_jax_params(tree, BertSpec.tiny(**kw), device="cpu", dtype=torch.float32)
    builder_j = JaxBuilder(ce_j, ment_block=4, ent_block=8, pair_pad_multiple=32)
    builder_t = ScoreMatrixBuilder(ce_t, ment_block=4, ent_block=8, pair_pad_multiple=32, device="cpu")
    return ment, ent, tok, ce_j, params, ce_t, builder_j, builder_t


def _build_both(world):
    ment, ent, tok, ce_j, params, ce_t, builder_j, builder_t = world
    # one train matrix for both, so the indexes differ only by the build's
    # own f32 arithmetic
    train = builder_j(params, ment[:16], ent[:N0])
    r_j = JaxRetriever.build(
        ce_j, params, tok, ment[:16], ent[:N0], n_anchor_items=12, builder=builder_j,
        train_scores=train, max_query_len=16, seed=3,
    )
    r_t = CurRetriever.build(
        ce_t, WordPieceTokenizer(tok.vocab), ment[:16], ent[:N0], n_anchor_items=12,
        builder=builder_t, train_scores=train, max_query_len=16, seed=3, device="cpu",
    )
    np.testing.assert_array_equal(r_t.anchor_item_ids, r_j.anchor_item_ids)
    np.testing.assert_allclose(r_t.u, np.asarray(r_j.u), rtol=1e-6, atol=1e-6 * np.abs(r_j.u).max())
    return r_j, r_t


def test_query_tokens_batch_matches_jax(world):
    ment = world[0]
    r_j, r_t = _build_both(world)
    for rerank in (True, False):
        s_j, i_j = r_j.query_tokens_batch(ment[16:], top_k=5, top_k_retvr=20, rerank=rerank)
        s_t, i_t = r_t.query_tokens_batch(ment[16:], top_k=5, top_k_retvr=20, rerank=rerank)
        _assert_same_topk(s_t, i_t, s_j, i_j)
    # text path: same tokens, same answer
    res_j = r_j.query("alpha beta", context_left="gamma", top_k=3, top_k_retvr=10)
    res_t = r_t.query("alpha beta", context_left="gamma", top_k=3, top_k_retvr=10)
    assert r_t.tokenize_query("Alpha Beta", "gamma") == r_j.tokenize_query("Alpha Beta", "gamma")
    _assert_same_topk(
        np.asarray([[s for _, s in res_t]]), np.asarray([[i for i, _ in res_t]]),
        np.asarray([[s for _, s in res_j]]), np.asarray([[i for i, _ in res_j]]),
    )
    assert r_t.cost_per_query == r_j.cost_per_query == 12


def test_add_and_remove_items_match_jax(world):
    ment, ent, _, _, _, _, builder_j, builder_t = world
    r_j, r_t = _build_both(world)
    ids_j = r_j.add_items(ent[N0:], builder_j)
    ids_t = r_t.add_items(ent[N0:], builder_t)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(
        r_t.index.latent_cols.numpy(), np.asarray(r_j.index.latent_cols),
        rtol=1e-4, atol=1e-4 * np.abs(np.asarray(r_j.index.latent_cols)).max(),
    )
    anchors = set(int(a) for a in r_j.anchor_item_ids)
    drop = [i for i in (1, 5, 33, 38) if i not in anchors][:3]
    assert r_t.remove_items(drop) == r_j.remove_items(drop) == len(drop)
    np.testing.assert_array_equal(r_t.anchor_item_ids, r_j.anchor_item_ids)
    np.testing.assert_array_equal(r_t.item_ids, r_j.item_ids)
    s_j, i_j = r_j.query_tokens_batch(ment[16:], top_k=5, top_k_retvr=20)
    s_t, i_t = r_t.query_tokens_batch(ment[16:], top_k=5, top_k_retvr=20)
    _assert_same_topk(s_t, i_t, s_j, i_j)
    assert not set(drop) & set(i_t.ravel().tolist())
    with pytest.raises(ValueError, match="anchor"):
        r_t.remove_items([int(r_t.item_ids[r_t.anchor_item_ids[0]])])


def test_state_files_cross_packages(world, tmp_path):
    ment, ent, tok, ce_j, params, ce_t, builder_j, builder_t = world
    r_j, r_t = _build_both(world)
    r_t.add_items(ent[N0:N0 + 2], builder_t)
    r_t.save(str(tmp_path / "t.pkl"))
    back_j = JaxRetriever.load(str(tmp_path / "t.pkl"), ce_j, params, tok)
    assert back_j.next_item_id == r_t.next_item_id == N0 + 2
    np.testing.assert_array_equal(np.asarray(back_j.index.latent_cols), r_t.index.latent_cols.numpy())
    r_j.save(str(tmp_path / "j.pkl"))
    back_t = CurRetriever.load(str(tmp_path / "j.pkl"), ce_t, WordPieceTokenizer(tok.vocab))
    np.testing.assert_array_equal(back_t.index.latent_cols.numpy(), np.asarray(r_j.index.latent_cols))
    np.testing.assert_array_equal(back_t.item_tokens, r_j.item_tokens)
    s_j, i_j = r_j.query_tokens_batch(ment[16:20], top_k=4, top_k_retvr=12)
    s_t, i_t = back_t.query_tokens_batch(ment[16:20], top_k=4, top_k_retvr=12)
    _assert_same_topk(s_t, i_t, s_j, i_j)
