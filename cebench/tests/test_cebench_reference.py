"""The plain reference against the port at a tiny size on the CPU, in
f32 on both sides: cross-encoder scores, tower embeddings, CUR latents,
ridge completion and MIPS top-k. And the seeded inputs: the same seed
makes the same ones, another seed the same sizes and gaps."""

import numpy as np
import pytest
import torch

from cebench.drivers import fixed_open
from cebench.lib import checks, models, reference, world
from cebench.tests.tiny import TINY_MODEL

CFG = {**world.load_config("ce-bert-base.yugioh"), **TINY_MODEL}
CFG["deployment"] = {**CFG["deployment"], "max_input_len": 16, "max_label_len": 16, "pair_pad_multiple": 32}


def _toks(seed, n, length):
    return world.tokens(world.generator(seed, "t", "cpu"), n, length, CFG["vocab_size"], world.mention_tags(length), "cpu")


def test_cross_encoder_scores_match_the_port():
    from anncur_tpu_torch.indexer.score_matrix import build_pairs
    from anncur_tpu_torch.models.crossencoder import CrossEncoder

    tree = world.ce_weights(CFG, 3, "cpu")
    ce = CrossEncoder(models.bert_spec(CFG), compute_dtype=torch.float32, device="cpu", params=world.host_tree(tree))
    ment, ent = _toks(1, 3, 16), _toks(2, 5, 16)
    ent[:, 10:] = 0  # padded entities: masked keys
    pl = models.pair_len(CFG)
    port = ce.score(build_pairs(ment, ent, pl), first_segment_end=16).reshape(3, 5)
    m = ment.repeat_interleave(5, 0)
    e = ent.repeat(3, 1)
    ref = reference.ce_scores(tree, CFG, m, e, pl).reshape(3, 5)
    assert torch.allclose(port, ref, atol=2e-5, rtol=0)
    # the float8 control differs from both by far more
    ctl = reference.ce_scores(tree, CFG, m, e, pl, "fp8").reshape(3, 5)
    assert (ctl - ref).abs().max() > 20 * (port - ref).abs().max()


def test_tower_embeddings_match_the_port():
    from anncur_tpu_torch.models.biencoder import BiEncoder

    cfg = {**CFG, "deployment": {**CFG["deployment"], "embed_dim": CFG["hidden_size"]}}
    tree = world.bienc_weights(cfg, 4, "cpu")
    enc = BiEncoder(models.bert_spec(cfg), embed_dim=cfg["hidden_size"], compute_dtype=torch.float32, device="cpu",
                    params=world.host_tree(tree))
    toks = _toks(5, 6, 16)
    toks[2, 8:] = 0
    assert torch.allclose(enc.encode_input(toks), reference.tower_embeds(tree["input_bert"], cfg, toks), atol=2e-5)


def test_cur_latent_and_mips_match_the_port():
    from anncur_tpu_torch.core.cur import build_cur
    from anncur_tpu_torch.ops.mips import mips_topk

    train = world.train_matrix(world.generator(6, "train", "cpu"), 40, 300, 8, 1.0, "cpu").numpy()
    anchors = np.sort(np.random.default_rng(0).choice(300, 32, replace=False))
    index = build_cur(rows=train, cols=train[:, anchors], row_idxs=np.arange(40), col_idxs=anchors,
                      validate=False, device="cpu")
    latent = reference.cur_latent(train, anchors)
    assert np.allclose(index.latent_cols.numpy(), latent, atol=1e-4 * np.abs(latent).max())
    q = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    items = torch.as_tensor(latent.T, dtype=torch.float32).contiguous()
    s_port, i_port = mips_topk(q, items, 10)
    s_ref, i_ref = reference.topk(reference.mips_scores(q, items), 10)
    assert torch.equal(i_port, i_ref)
    assert reference.rank_gap(reference.mips_scores(q, items, "f64"), i_port, 10) < 1e-5


def test_ridge_completion_matches_the_port():
    from anncur_tpu_torch.core.adaptive_fused import ridge_complete

    train_t = torch.randn(300, 40, generator=torch.Generator().manual_seed(1))
    ids = torch.randperm(300, generator=torch.Generator().manual_seed(2))[:20]
    vals = torch.randn(20, generator=torch.Generator().manual_seed(3))
    port = ridge_complete(train_t, ids[None], vals[None], 1e-2)[0]
    ref = checks.ridge_completion(train_t, ids, vals, 1e-2)
    assert torch.allclose(port.double(), ref, atol=1e-4 * ref.abs().max())


def test_rank_gap_is_zero_for_the_top_k_and_the_shortfall_otherwise():
    s = torch.tensor([[5.0, 4.0, 3.0, 2.0, 1.0]])
    assert reference.rank_gap(s, torch.tensor([[1, 0]]), 2) == 0.0
    assert reference.rank_gap(s, torch.tensor([[0, 2]]), 2) == pytest.approx(1.0)
    assert reference.rank_gap(s, torch.tensor([[4, 3]]), 2) == pytest.approx(3.0)


def test_tf32_and_fp8_round_as_stated():
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -9, 3.0])
    assert reference.tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -9, 3.0]
    y = torch.linspace(-2, 2, 101)
    err = (reference.fp8(y) - y).abs().max()
    assert 0 < err <= 2 * 2.0 ** -4 * 2


def test_seeded_inputs_repeat_and_keep_their_sizes():
    a, b = world.ce_weights(CFG, 9, "cpu"), world.ce_weights(CFG, 9, "cpu")
    assert torch.equal(a["bert"]["layers"][1]["mlp"]["in_kernel"], b["bert"]["layers"][1]["mlp"]["in_kernel"])
    c = world.ce_weights(CFG, 10, "cpu")
    assert not torch.equal(a["bert"]["pooler"]["kernel"], c["bert"]["pooler"]["kernel"])
    assert torch.equal(_toks(2**31 + 7, 4, 16), _toks(2**31 + 7, 4, 16))
    assert (_toks(2**31 + 7, 4, 16) >= world.FIRST_WORD_ID).sum() > 0


def test_arrivals_are_the_exponential_quantiles_in_a_fixed_order():
    got = fixed_open.arrivals(326, 6.4, 0)
    assert np.array_equal(got, fixed_open.arrivals(326, 6.4, 0))
    gaps = np.diff(got, prepend=0.0)
    p = (np.arange(326) + 0.5) / 326
    assert np.allclose(np.sort(gaps), np.sort(-np.log1p(-p) / 6.4))
    assert got[-1] == pytest.approx(326 / 6.4, rel=0.02)
    assert not np.array_equal(got, fixed_open.arrivals(326, 6.4, 1))


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**33 + 1])
def test_queries_repeat_for_a_seed_and_differ_between_seeds(seed):
    from types import SimpleNamespace

    run = SimpleNamespace(cfg=CFG, seed=seed, device="cpu")
    a = models.make_mentions(run, 8, "queries")
    assert torch.equal(a, models.make_mentions(run, 8, "queries"))
    assert not torch.equal(a, models.make_mentions(SimpleNamespace(cfg=CFG, seed=seed + 1, device="cpu"), 8, "queries"))
