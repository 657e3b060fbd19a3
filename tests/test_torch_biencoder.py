"""Port parity, bi-encoder and retrieve-and-rerank: ``BiEncoder``'s towers
(separate and shared, every pooling type, with and without the linear
heads, f32 and bf16) through weights carried across both ways, and the
``evalx/retrieve_rerank.py`` entry points (embedding, CE rerank, the
retrieve-and-rerank and bi-encoder evals, prediction files read across
the two packages), against the JAX package on the CPU."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.data.synthetic import make_tokenized_world
from anncur_tpu.models.bert import BertSpec as JaxBertSpec
from anncur_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from anncur_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder

from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.biencoder import BiEncoder
from anncur_tpu_torch.models.convert import (
    biencoder_from_jax_params,
    biencoder_to_jax_params,
    crossencoder_from_jax_params,
)

# the modules (both packages' evalx re-export a function of the same name)
jrr = importlib.import_module("anncur_tpu.evalx.retrieve_rerank")
trr = importlib.import_module("anncur_tpu_torch.evalx.retrieve_rerank")
torch.set_num_threads(2)  # xdist runs several test files side by side

# the tolerances of tests/test_torch_models.py: f32 sums in other orders;
# bf16 activations rounded at other places through 2 layers
F32_ATOL = 1e-4
BF16_ATOL = 3e-2
POOLINGS = ("cls_w_lin", "cls", "mean", "max", "lse", "spl_tkns")
# the rerank world's init: wider than 0.02, so that CE scores and
# rankings spread out (tests/test_torch_retriever.py)
INIT_RANGE = 0.3


def _world(init_range):
    ment, ent, gt, tok = make_tokenized_world(seed=4, n_ents=40, n_ments=20, max_ment_len=16, max_ent_len=16)
    kw = dict(vocab_size=tok.vocab_size, max_position_embeddings=64, initializer_range=init_range)
    return ment, ent, gt, JaxBertSpec.tiny(**kw), BertSpec.tiny(**kw)


@pytest.fixture(scope="module")
def world():
    return _world(0.02)


def _pair(world, bi_enc_type, pooling, add_linear, dtype="f32", embed_dim=None):
    """(JAX encoder, JAX params, the port's encoder from those params)."""
    _, _, _, spec_j, spec_t = world
    embed_dim = embed_dim or (48 if add_linear else spec_t.hidden_size)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    enc_j = JaxBiEncoder(spec=spec_j, pooling_type=pooling, bi_enc_type=bi_enc_type, embed_dim=embed_dim,
                         add_linear_layer=add_linear, compute_dtype=jdt)
    params = jax.tree_util.tree_map(np.asarray, enc_j.init(jax.random.PRNGKey(1)))
    if add_linear:  # nonzero biases, so a dropped bias shows
        for name in ("linear", "input_linear", "label_linear"):
            if name in params:
                params[name]["bias"] = np.linspace(-1, 1, embed_dim).astype(np.float32)
    enc_t = biencoder_from_jax_params(params, spec_t, pooling, bi_enc_type, embed_dim, device="cpu", dtype=tdt)
    return enc_j, params, enc_t


@pytest.mark.parametrize("add_linear", [False, True])
@pytest.mark.parametrize("pooling", POOLINGS)
@pytest.mark.parametrize("bi_enc_type", ["separate", "shared"])
def test_encoders_match_jax(world, bi_enc_type, pooling, add_linear):
    """Both towers on mentions and entities (with padding, the tags in
    place), f32 everywhere; bf16 for every other pooling of the grid."""
    ment, ent = world[0], world[1]
    dtypes = ("f32", "bf16") if (POOLINGS.index(pooling) + add_linear) % 2 == 0 else ("f32",)
    for dtype in dtypes:
        enc_j, params, enc_t = _pair(world, bi_enc_type, pooling, add_linear, dtype)
        atol = F32_ATOL if dtype == "f32" else BF16_ATOL
        for toks, fn_j, fn_t in ((ment, enc_j.encode_input, enc_t.encode_input),
                                 (ent, enc_j.encode_label, enc_t.encode_label)):
            want = np.asarray(fn_j(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(toks)), np.float32)
            got = fn_t(toks)
            assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (toks.shape[0], enc_t.embed_dim)
            np.testing.assert_allclose(got.numpy(), want, atol=atol * max(1.0, np.abs(want).max()), rtol=0)


def test_convert_both_ways_and_scores(world):
    """JAX tree -> port -> JAX tree is the identity for both tower layouts;
    a mismatched tree is refused; score_labels is true f32 and matches
    JAX's, score_paired is the row-wise dot."""
    _, _, _, spec_j, spec_t = world
    for bi_enc_type, add_linear in (("separate", True), ("shared", True), ("shared", False)):
        _, params, enc_t = _pair(world, bi_enc_type, "cls", add_linear)
        back = biencoder_to_jax_params(enc_t)
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(a, b)
    _, params, _ = _pair(world, "separate", "cls", True)
    with pytest.raises(ValueError, match="bi_enc_type"):
        biencoder_from_jax_params(params, spec_t, bi_enc_type="shared", embed_dim=48, device="cpu")
    with pytest.raises(ValueError, match="input_linear"):
        biencoder_from_jax_params(params, spec_t, embed_dim=32, device="cpu")
    with pytest.raises(ValueError, match="embed_dim"):
        BiEncoder(spec_t, embed_dim=32, device="cpu")
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((5, 24)).astype(np.float32), rng.standard_normal((7, 24)).astype(np.float32)
    want = np.asarray(JaxBiEncoder.score_labels(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(BiEncoder.score_labels(torch.as_tensor(a), torch.as_tensor(b)).numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(BiEncoder.score_paired(torch.as_tensor(a), torch.as_tensor(a)).numpy(),
                               np.asarray(JaxBiEncoder.score_paired(jnp.asarray(a), jnp.asarray(a))), rtol=1e-6)


@pytest.fixture(scope="module")
def eval_world():
    """A separate cls_w_lin bi-encoder and a default-head CE, f32, carried
    from JAX params to the port."""
    world = _world(INIT_RANGE)
    ment, ent, gt, spec_j, spec_t = world
    enc_j, bi_params, enc_t = _pair(world, "separate", "cls_w_lin", False)
    ce_j = JaxCrossEncoder(spec=spec_j, compute_dtype=jnp.float32)
    ce_params = ce_j.init(jax.random.PRNGKey(2))
    ce_t = crossencoder_from_jax_params(jax.tree_util.tree_map(np.asarray, ce_params), spec_t, device="cpu",
                                        dtype=torch.float32)
    bi_params = jax.tree_util.tree_map(jnp.asarray, bi_params)
    return ment, ent, gt, enc_j, bi_params, enc_t, ce_j, ce_params, ce_t


def test_embed_and_rerank_match_jax(eval_world):
    """embed_tokenized (batches of 8, the last padded) and
    crossenc_rerank_scores (batches of 3 mentions, the last short) against
    JAX's; the rerank scores are the retriever's pair scorer's."""
    from anncur_tpu_torch.indexer.score_matrix import make_pair_scorer

    ment, ent, _, enc_j, bi_params, enc_t, ce_j, ce_params, ce_t = eval_world
    for which, toks in (("label", ent), ("input", ment)):
        got = trr.embed_tokenized(enc_t, toks, batch_size=8, which=which)
        want = jrr.embed_tokenized(enc_j, bi_params, toks, batch_size=8, which=which)
        np.testing.assert_allclose(got, want, atol=F32_ATOL * max(1.0, np.abs(want).max()), rtol=0)
    cand = np.random.default_rng(3).integers(0, ent.shape[0], size=(ment.shape[0], 5))
    got = trr.crossenc_rerank_scores(ce_t, ment, ent, cand, batch_ments=3, pair_pad_multiple=32)
    want = np.asarray(jrr.crossenc_rerank_scores(ce_j, ce_params, ment, ent, cand, batch_ments=3, pair_pad_multiple=32))
    assert got.shape == (ment.shape[0], 5)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=1e-5)
    scorer = make_pair_scorer(ce_t, ment.shape[1], ent.shape[1], 32)
    # the first batch of 3 mentions again, as one call of the scorer: the same bits
    direct = scorer(torch.as_tensor(ment[:3]), torch.as_tensor(ent)[torch.as_tensor(cand[:3])]).numpy()
    np.testing.assert_array_equal(got[:3], direct)


def _metrics_only(res):
    return {key: res[key] for key in ("bienc", "crossenc", "n_ments", "n_ents", "top_k")}


def test_retrieve_rerank_eval_and_files_match_jax(eval_world, tmp_path):
    """run_retrieve_rerank_eval and run_biencoder_eval: the same metrics as
    JAX's; each package's run_from_precomputed_preds reads the other's
    prediction files to the same metrics; over a 1-rank mesh (the sharded
    search, gathered) the metrics are the same; an empty slice raises."""
    ment, ent, gt, enc_j, bi_params, enc_t, ce_j, ce_params, ce_t = eval_world
    kw = dict(top_k=8, batch_size=8, ment_start=2, n_ment=15)
    got = trr.run_retrieve_rerank_eval(enc_t, ce_t, ment, ent, gt, res_dir=str(tmp_path / "port"), **kw)
    want = jrr.run_retrieve_rerank_eval(enc_j, bi_params, ce_j, ce_params, ment, ent, gt,
                                        res_dir=str(tmp_path / "jax"), **kw)
    assert _metrics_only(got) == want
    assert set(got["seconds"]) == {"embed_entities", "embed_mentions", "index_build", "search", "rerank"}
    assert trr.run_biencoder_eval(enc_t, ment, ent, gt, top_k=10, batch_size=8) == jrr.run_biencoder_eval(
        enc_j, bi_params, ment, ent, gt, top_k=10, batch_size=8)
    for reader, writer in ((trr, "jax"), (jrr, "port"), (trr, "port")):
        res = reader.run_from_precomputed_preds(str(tmp_path / writer))
        assert res["bienc"] == want["bienc"] and res["crossenc"] == want["crossenc"] and res["n_ments"] == 15
    from anncur_tpu_torch.parallel.mesh import mesh_session

    with mesh_session("cpu") as mesh:
        sharded = trr.run_retrieve_rerank_eval(enc_t, ce_t, ment, ent, gt, mesh=mesh, **kw)
    assert _metrics_only(sharded) == want
    with pytest.raises(ValueError, match="empty mention slice"):
        trr.run_retrieve_rerank_eval(enc_t, ce_t, ment, ent, gt, ment_start=100)
