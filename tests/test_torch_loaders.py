"""Port parity, loading: ``models/hf_loader.py`` (reference Lightning
``.ckpt`` files and local HF directories, written here with
``torch.save`` in the reference's key layout with random numpy weights),
``CurRetriever.from_state_dict`` and ``ScoreMatrixBuilder.paired_embeds``,
held against the JAX package on the same files (CPU, f32 compute).

Tolerances: ``test_torch_index.py``'s SCORE_ATOL / SCORE_RTOL (f32 on
both sides, sums in other orders)."""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.core.retriever import CurRetriever as JaxRetriever
from anncur_tpu.data.synthetic import make_tokenized_world
from anncur_tpu.indexer.score_matrix import ScoreMatrixBuilder as JaxBuilder
from anncur_tpu.models import hf_loader as jhf
from anncur_tpu.models.bert import BertSpec as JaxBertSpec
from anncur_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from anncur_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder

from anncur_tpu_torch.core.retriever import CurRetriever
from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
from anncur_tpu_torch.models import hf_loader as thf
from anncur_tpu_torch.models.bert import BertSpec, init_bert_params
from anncur_tpu_torch.models.biencoder import BiEncoder
from anncur_tpu_torch.models.convert import crossencoder_from_jax_params
from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer

torch.set_num_threads(2)  # xdist runs several test files side by side

SCORE_ATOL, SCORE_RTOL = 1e-4, 1e-5
HF_CONFIG = dict(
    vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
    max_position_embeddings=64, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
)
# widened init so that scores and embeddings spread beyond f32 rounding
INIT_RANGE = 0.3


def _hf_state_dict(tree, prefix=""):
    """A JAX-layout bert tree under HF BertModel key names, as torch
    tensors ((out, in) Linear weights)."""
    sd = {}

    def put(name, arr, transpose=False):
        arr = np.asarray(arr, np.float32)
        sd[prefix + name] = torch.from_numpy(np.ascontiguousarray(arr.T if transpose else arr))

    emb = tree["embeddings"]
    put("embeddings.word_embeddings.weight", emb["word"])
    put("embeddings.position_embeddings.weight", emb["position"])
    put("embeddings.token_type_embeddings.weight", emb["token_type"])
    put("embeddings.LayerNorm.weight", emb["ln_scale"])
    put("embeddings.LayerNorm.bias", emb["ln_bias"])
    for li, layer in enumerate(tree["layers"]):
        p, a, m = f"encoder.layer.{li}.", layer["attn"], layer["mlp"]
        for hf, ours in (("query", "q"), ("key", "k"), ("value", "v")):
            put(p + f"attention.self.{hf}.weight", a[f"{ours}_kernel"], True)
            put(p + f"attention.self.{hf}.bias", a[f"{ours}_bias"])
        put(p + "attention.output.dense.weight", a["out_kernel"], True)
        put(p + "attention.output.dense.bias", a["out_bias"])
        put(p + "attention.output.LayerNorm.weight", a["ln_scale"])
        put(p + "attention.output.LayerNorm.bias", a["ln_bias"])
        put(p + "intermediate.dense.weight", m["in_kernel"], True)
        put(p + "intermediate.dense.bias", m["in_bias"])
        put(p + "output.dense.weight", m["out_kernel"], True)
        put(p + "output.dense.bias", m["out_bias"])
        put(p + "output.LayerNorm.weight", m["ln_scale"])
        put(p + "output.LayerNorm.bias", m["ln_bias"])
    put("pooler.dense.weight", tree["pooler"]["kernel"], True)
    put("pooler.dense.bias", tree["pooler"]["bias"])
    return sd


def _linear(rng, prefix, h, out):
    return {
        prefix + "weight": torch.from_numpy(rng.standard_normal((out, h), dtype=np.float32) * 0.3),
        prefix + "bias": torch.from_numpy(rng.standard_normal((out,), dtype=np.float32) * 0.1),
    }


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A reference-layout Lightning .ckpt (every tower prefix and head) and
    an HF directory ('bert.' prefix), from random numpy weights."""
    root = tmp_path_factory.mktemp("ckpts")
    spec = thf.spec_from_hf_config(HF_CONFIG)
    rng = np.random.default_rng(0)
    spec_init = BertSpec(**{**spec.__dict__, "initializer_range": INIT_RANGE})
    towers = [init_bert_params(rng, spec_init) for _ in range(3)]
    sd = {}
    for prefix, tree in zip(
        ("model.input_encoder.bert_model.", "model.label_encoder.bert_model.", "model.encoder.bert_model."), towers
    ):
        sd.update(_hf_state_dict(tree, prefix))
    for prefix, out in (("model.input_encoder.additional_linear.", 32), ("model.label_encoder.additional_linear.", 32)):
        sd.update(_linear(rng, prefix, 32, out))
    sd.update(_linear(rng, "model.encoder.additional_linear.", 32, 1))
    ckpt = str(root / "model.ckpt")
    torch.save({"state_dict": sd, "epoch": 3}, ckpt)
    shared_lin = {**sd, **_linear(rng, "model.encoder.additional_linear.", 32, 32)}
    shared_ckpt = str(root / "shared.ckpt")
    torch.save({"state_dict": shared_lin}, shared_ckpt)
    hf_dir = root / "hf"
    hf_dir.mkdir()
    with open(hf_dir / "config.json", "w") as fout:
        json.dump(HF_CONFIG, fout)
    torch.save(_hf_state_dict(towers[0], "bert."), str(hf_dir / "pytorch_model.bin"))
    (hf_dir / "vocab.txt").write_text("\n".join(["[PAD]"] + [f"t{i}" for i in range(127)]) + "\n")
    toks = rng.integers(5, 128, (3, 12)).astype(np.int32)
    toks[:, 9:] = 0  # padding
    pairs = rng.integers(5, 128, (4, 24)).astype(np.int32)
    pairs[:, 2], pairs[:, 5], pairs[:, 15] = 1, 2, 3  # the w_embeds tags
    pairs[:, 20:] = 0
    return {"ckpt": ckpt, "shared_ckpt": shared_ckpt, "hf_dir": str(hf_dir), "toks": toks, "pairs": pairs}


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}/{i}")
    else:
        assert isinstance(got, np.ndarray) and got.dtype == np.float32, path
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)


def test_spec_from_hf_config_equals_jax():
    got, want = thf.spec_from_hf_config(HF_CONFIG), jhf.spec_from_hf_config(HF_CONFIG)
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
                  "max_position_embeddings", "type_vocab_size", "layer_norm_eps", "hidden_dropout",
                  "attention_dropout"):
        assert getattr(got, field) == getattr(want, field), field
    with pytest.raises(ValueError, match="missing"):
        thf.spec_from_hf_config({"vocab_size": 3})


@pytest.mark.parametrize("cross_enc_type", ["default", "w_embeds"])
def test_crossencoder_from_lightning_equals_jax(files, cross_enc_type):
    sd_t = thf.load_lightning_checkpoint(files["ckpt"])
    sd_j = jhf.load_lightning_checkpoint(files["ckpt"])
    spec_t, spec_j = thf.spec_from_hf_config(HF_CONFIG), jhf.spec_from_hf_config(HF_CONFIG)
    tree_t = thf.crossencoder_params_from_lightning(sd_t, spec_t, cross_enc_type)
    tree_j = jhf.crossencoder_params_from_lightning(sd_j, spec_j, cross_enc_type)
    _assert_tree_equal(tree_t, tree_j)
    ce_t = CrossEncoder(spec_t, cross_enc_type, compute_dtype=torch.float32, device="cpu").load_params_(tree_t)
    ce_j = JaxCrossEncoder(spec=spec_j, cross_enc_type=cross_enc_type, compute_dtype=jnp.float32)
    want = np.asarray(ce_j.score(tree_j, jnp.asarray(files["pairs"]), first_segment_end=12))
    got = ce_t.score(files["pairs"], first_segment_end=12).numpy()
    assert np.abs(want).max() > 1e-2  # scores spread beyond rounding
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=SCORE_RTOL)
    if cross_enc_type == "w_embeds":
        m_j, e_j = ce_j.embed_paired(tree_j, jnp.asarray(files["pairs"]), 12)
        m_t, e_t = ce_t.embed_paired(files["pairs"], 12)
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=SCORE_ATOL, rtol=SCORE_RTOL)
        np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), atol=SCORE_ATOL, rtol=SCORE_RTOL)


@pytest.mark.parametrize("bi_enc_type,linear", [("separate", False), ("separate", True), ("shared", False), ("shared", True)])
def test_biencoder_from_lightning_equals_jax(files, bi_enc_type, linear):
    path = files["shared_ckpt"] if bi_enc_type == "shared" and linear else files["ckpt"]
    spec_t, spec_j = thf.spec_from_hf_config(HF_CONFIG), jhf.spec_from_hf_config(HF_CONFIG)
    tree_t = thf.biencoder_params_from_lightning(thf.load_lightning_checkpoint(path), spec_t, bi_enc_type, linear)
    tree_j = jhf.biencoder_params_from_lightning(jhf.load_lightning_checkpoint(path), spec_j, bi_enc_type, linear)
    _assert_tree_equal(tree_t, tree_j)
    kw = dict(pooling_type="cls", bi_enc_type=bi_enc_type, embed_dim=32, add_linear_layer=linear)
    be_t = BiEncoder(spec_t, compute_dtype=torch.float32, device="cpu", **kw).load_params_(tree_t)
    be_j = JaxBiEncoder(spec=spec_j, compute_dtype=jnp.float32, **kw)
    toks = files["toks"]
    for which in ("input", "label"):
        want = np.asarray(getattr(be_j, f"encode_{which}")(tree_j, jnp.asarray(toks)))
        got = getattr(be_t, f"encode_{which}")(toks).numpy()
        np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=SCORE_RTOL)


def test_pretrained_dir_equals_jax(files):
    spec_t, tree_t, vocab_t = thf.load_bert_from_pretrained_dir(files["hf_dir"])
    spec_j, tree_j, vocab_j = jhf.load_bert_from_pretrained_dir(files["hf_dir"])
    assert vocab_t == vocab_j and vocab_t.endswith("vocab.txt")
    assert spec_t.num_layers == spec_j.num_layers == 2
    _assert_tree_equal(tree_t, tree_j)
    with pytest.raises(FileNotFoundError):
        thf.load_bert_from_pretrained_dir(os.path.dirname(files["ckpt"]))


def test_transformers_bert_parity(files):
    """The imported encoder against ``transformers.BertModel`` on the same
    weights (skipped where transformers is absent)."""
    transformers = pytest.importorskip("transformers")
    spec, tree, _ = thf.load_bert_from_pretrained_dir(files["hf_dir"])
    model = transformers.BertModel(transformers.BertConfig(**HF_CONFIG)).eval()
    sd = torch.load(os.path.join(files["hf_dir"], "pytorch_model.bin"), weights_only=True)
    missing, unexpected = model.load_state_dict({k[len("bert."):]: v for k, v in sd.items()}, strict=False)
    assert not unexpected and all("position_ids" in k for k in missing)
    be = BiEncoder(spec, pooling_type="cls", embed_dim=32, bi_enc_type="shared", compute_dtype=torch.float32,
                   device="cpu", params={"bert": tree})
    toks = torch.as_tensor(files["toks"], dtype=torch.long)
    mask = (toks != 0).long()
    with torch.no_grad():
        want = model(input_ids=toks, token_type_ids=torch.zeros_like(toks), attention_mask=mask).last_hidden_state
    np.testing.assert_allclose(be.encode_input(files["toks"]).numpy(), want[:, 0].numpy(), atol=3e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def tiny_ce():
    ment, ent, _, tok = make_tokenized_world(seed=9, n_ents=24, n_ments=12, max_ment_len=16, max_ent_len=16)
    kw = dict(vocab_size=tok.vocab_size, max_position_embeddings=64, initializer_range=INIT_RANGE)
    ce_j = JaxCrossEncoder(spec=JaxBertSpec.tiny(**kw), compute_dtype=jnp.float32)
    params = ce_j.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    ce_t = crossencoder_from_jax_params(tree, BertSpec.tiny(**kw), device="cpu", dtype=torch.float32)
    return ment, ent, tok, ce_j, params, ce_t, tree, kw


def test_from_state_dict_serves_a_jax_state(tiny_ce, tmp_path, caplog):
    ment, ent, tok, ce_j, params, ce_t, _, _ = tiny_ce
    builder_j = JaxBuilder(ce_j, ment_block=4, ent_block=8, pair_pad_multiple=32)
    r_j = JaxRetriever.build(
        ce_j, params, tok, ment[:8], ent, n_anchor_items=10, builder=builder_j, max_query_len=16, seed=1,
    )
    non_anchor = sorted(set(range(ent.shape[0])) - set(np.asarray(r_j.anchor_item_ids).tolist()))
    r_j.remove_items(np.asarray([non_anchor[-1]]))
    path = str(tmp_path / "state.pkl")
    r_j.save(path)
    import pickle

    with open(path, "rb") as fin:
        d = pickle.load(fin)
    r_t = CurRetriever.from_state_dict(d, ce_t, WordPieceTokenizer(tok.vocab), pair_pad_multiple=32)
    assert r_t.next_item_id == r_j.next_item_id and r_t.max_query_len == 16
    np.testing.assert_array_equal(r_t.item_ids, np.asarray(r_j.item_ids))
    s_j, i_j = r_j.query_tokens_batch(ment[8:], top_k=4, top_k_retvr=12)
    s_t, i_t = r_t.query_tokens_batch(ment[8:], top_k=4, top_k_retvr=12)
    np.testing.assert_allclose(s_t, np.asarray(s_j), atol=SCORE_ATOL, rtol=SCORE_RTOL)
    gaps = -np.diff(np.asarray(s_j), axis=1)
    sep = np.ones(s_t.shape, bool)
    sep[:, :-1] &= gaps > 1e-4
    sep[:, 1:] &= gaps > 1e-4
    np.testing.assert_array_equal(i_t[sep], np.asarray(i_j)[sep])
    # a legacy state without the id allocator: the warning JAX gives
    del d["next_item_id"]
    with caplog.at_level(logging.WARNING):
        legacy = CurRetriever.from_state_dict(d, ce_t, WordPieceTokenizer(tok.vocab))
    assert "next_item_id" in caplog.text
    assert legacy.next_item_id == int(np.asarray(r_j.item_ids).max()) + 1


def test_paired_embeds_equal_jax(tiny_ce):
    ment, ent, tok, _, _, _, _, kw = tiny_ce
    ce_j = JaxCrossEncoder(spec=JaxBertSpec.tiny(**kw), cross_enc_type="w_embeds", compute_dtype=jnp.float32)
    params = ce_j.init(jax.random.PRNGKey(2))
    ce_t = crossencoder_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), BertSpec.tiny(**kw), "w_embeds", device="cpu", dtype=torch.float32
    )
    m_j, e_j = JaxBuilder(ce_j, ent_block=7, pair_pad_multiple=32).paired_embeds(params, ment[:3], ent[:17])
    m_t, e_t = ScoreMatrixBuilder(ce_t, ent_block=7, pair_pad_multiple=32, device="cpu").paired_embeds(ment[:3], ent[:17])
    assert m_t.shape == e_t.shape == (3, 17, 64) and m_t.dtype == np.float32
    np.testing.assert_allclose(m_t, np.asarray(m_j), atol=SCORE_ATOL, rtol=SCORE_RTOL)
    np.testing.assert_allclose(e_t, np.asarray(e_j), atol=SCORE_ATOL, rtol=SCORE_RTOL)
