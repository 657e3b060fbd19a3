"""Port parity, the offline command-line pipeline: every CLI run by the
JAX ``main(argv)`` and by the port's ``main(argv + ["--device", "cpu"])``
on one synthetic ZeShEL-format world (40 entities x 24 mentions) and one
JAX-written checkpoint, then the files compared: names, pickle and JSON
schemas, score matrices within SCORE_ATOL in f32 (the encoders' compute
dtype is set to f32 on both sides: these CLIs have no dtype flag and
compute in bf16), and everything downstream of them equal. The JAX CLIs
run once, in module fixtures (CPU)."""

import contextlib
import functools
import glob
import json
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.data.synthetic import make_tokenizer, make_world, write_world_files
from anncur_tpu.models.bert import BertSpec as JaxBertSpec
from anncur_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from anncur_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from anncur_tpu.train.checkpoint import save_pytree as jax_save_pytree

torch.set_num_threads(2)  # xdist runs several test files side by side

SCORE_ATOL, SCORE_RTOL = 1e-4, 1e-5
TINY = ["--hidden_size", "32", "--num_layers", "1", "--num_heads", "2", "--intermediate_size", "64"]
LENS = ["--max_ment_len", "16", "--max_ent_len", "16"]
CPU = ["--device", "cpu"]
GRID = ["--top_k_vals", "1", "5", "--top_k_retvr_vals", "10", "--n_ent_anchors_vals", "8"]


def _jax_cli(name):
    return __import__(f"anncur_tpu.cli.{name}", fromlist=["main"])


def _port_cli(name):
    return __import__(f"anncur_tpu_torch.cli.{name}", fromlist=["main"])


@contextlib.contextmanager
def f32_encoders():
    """Both packages' build and retrieve-and-rerank CLIs compute in f32."""
    mp = pytest.MonkeyPatch()
    try:
        for name in ("build_score_matrix", "eval_retrieve_rerank"):
            mod = _jax_cli(name)
            mp.setattr(mod, "CrossEncoder", functools.partial(JaxCrossEncoder, compute_dtype=jnp.float32))
            if hasattr(mod, "BiEncoder"):
                mp.setattr(mod, "BiEncoder", functools.partial(JaxBiEncoder, compute_dtype=jnp.float32))
            mp.setattr(_port_cli(name), "COMPUTE_DTYPE", torch.float32)
        yield
    finally:
        mp.undo()


def _tiny_spec(vocab_size, **kw):
    return JaxBertSpec(vocab_size=vocab_size, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, **kw)


def _run_pipeline(kind, world, out, mono=None):
    """Every CLI of the pipeline by one package into ``out``. The split and
    the evals read ``mono`` (default: this run's own matrix), so that both
    packages' downstream CLIs can be given one input."""
    cli = _jax_cli if kind == "jax" else _port_cli
    extra = CPU if kind == "port" else []
    w = world
    ents = os.path.join(out, "ents.npy")
    cli("tokenize_entities").main(["--ent_file", w["ent_file"], "--vocab_file", w["vocab"], "--out_file", ents, "--max_len", "16"])
    build = ["--ment_file", w["ment_file"], "--ent_file", w["ent_file"], "--ent_tokens_file", ents,
             "--vocab_file", w["vocab"], "--ckpt_path", w["ce_ckpt"], "--ment_block", "4", "--ent_block", "8"] + TINY + LENS
    with f32_encoders():
        for start in (0, 12):
            cli("build_score_matrix").main(build + ["--res_dir", os.path.join(out, "parts"), "--n_ment_start", str(start),
                                                    "--n_ment", "12"] + extra)
        cli("build_score_matrix").main(build + ["--res_dir", os.path.join(out, "mono")] + extra)
        cli("build_score_matrix").main(
            build + ["--res_dir", os.path.join(out, "embeds"), "--mode", "embeds",
                     "--n_ment", "2", "--cross_enc_type", "w_embeds",
                     "--ckpt_path", w["ce_w_embeds_ckpt"], "--misc", "_x"] + extra
        )
        rr = ["--ment_file", w["ment_file"], "--ent_file", w["ent_file"], "--vocab_file", w["vocab"],
              "--bienc_ckpt", w["bienc_ckpt"], "--crossenc_ckpt", w["ce_ckpt"], "--top_k", "8", "--batch_size", "8",
              "--pooling_type", "cls"] + TINY + LENS + extra
        cli("eval_retrieve_rerank").main(rr + ["--res_dir", os.path.join(out, "rr"), "--n_ment", "16"])
        cli("eval_retrieve_rerank").main(rr + ["--res_dir", os.path.join(out, "bi"), "--bienc_only"])
    parts = sorted(glob.glob(os.path.join(out, "parts", "*.pkl")))
    full = os.path.join(out, "full.pkl")
    cli("combine_chunks").main(["--chunks", *parts, "--out", full])
    mono = mono or os.path.join(out, "mono", "ment_to_ent_scores_n_m_24_n_e_40_all_layers_False.pkl")
    cli("split_matrix").main(["--score_matrix", mono, "--out_dir", os.path.join(out, "splits"), "--nm_train_vals", "16"])
    cli("eval_retrieval").main(["--mode", "transductive", "--score_matrix", mono, "--res_dir", os.path.join(out, "trans"),
                                "--methods", "cur", "cur_oracle", "--n_ment_anchors_vals", "8"] + GRID + extra)
    split = os.path.join(out, "splits", "nm_train=16_split=0")
    cli("eval_retrieval").main(["--mode", "inductive", "--score_matrix", os.path.join(split, "test.pkl"),
                                "--train_score_matrix", os.path.join(split, "train.pkl"),
                                "--res_dir", os.path.join(out, "ind"), "--methods", "cur"] + GRID + extra)
    cli("eval_retrieval").main(["--mode", "inductive", "--score_matrix", mono, "--res_dir", os.path.join(out, "ind"),
                                "--methods", "bienc", "tfidf", "--bienc_scores_pkl", w["bienc_scores"],
                                "--ment_file", w["ment_file"], "--ent_file", w["ent_file"]] + GRID + extra)
    for d in ("yugioh", "lego"):
        os.makedirs(os.path.join(out, "domains", d))
        shutil.copy(os.path.join(out, "ind", "method=cur_s=0", "res.json"), os.path.join(out, "domains", d, "res.json"))
    cli("avg_results").main(["--res_glob", os.path.join(out, "domains", "*", "res.json"), "--out",
                             os.path.join(out, "avg.json"), "--metric_key", "top_k=5"])
    cli("compute_tfidf_hard_negs").main(["--ment_file", w["ment_file"], "--ent_file", w["ent_file"],
                                         "--out_file", os.path.join(out, "negs.json"), "--num_negs", "6"] + extra)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_world")
    mentions, entities = make_world(np.random.default_rng(5), n_ents=40, n_ments=24)
    w = write_world_files(str(root), mentions, entities)
    tok = make_tokenizer()
    w["vocab"] = str(root / "vocab.txt")
    tok.save_vocab(w["vocab"])
    # widened init: a random CE at 0.02 scores near rank one
    spec = _tiny_spec(tok.vocab_size, initializer_range=0.3)
    for key, cet in (("ce_ckpt", "default"), ("ce_w_embeds_ckpt", "w_embeds")):
        params = JaxCrossEncoder(spec=spec, cross_enc_type=cet, compute_dtype=jnp.float32).init(jax.random.PRNGKey(1))
        w[key] = str(root / f"{key}.pkl")
        jax_save_pytree(w[key], {"params": params})
    bi = JaxBiEncoder(spec=spec, pooling_type="cls", embed_dim=32, compute_dtype=jnp.float32)
    w["bienc_ckpt"] = str(root / "bienc.pkl")
    jax_save_pytree(w["bienc_ckpt"], {"params": bi.init(jax.random.PRNGKey(2))})
    w["bienc_scores"] = str(root / "bienc_scores.pkl")
    with open(w["bienc_scores"], "wb") as fout:
        pickle.dump({"scores": np.random.default_rng(3).standard_normal((24, 40)).astype(np.float32)}, fout)
    w["mentions"], w["entities"] = mentions, entities
    return w


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """Both packages' runs; downstream of the build both read JAX's matrix
    (the port's own is held to it in test_score_matrices_equal_jax), so
    near-tied scores cannot make the evals differ."""
    jax_out = _run_pipeline("jax", world, str(tmp_path_factory.mktemp("jax")))
    mono = os.path.join(jax_out, "mono", "ment_to_ent_scores_n_m_24_n_e_40_all_layers_False.pkl")
    return {"jax": jax_out, "port": _run_pipeline("port", world, str(tmp_path_factory.mktemp("port")), mono)}


def _files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
                  if os.path.isfile(p) and not os.path.basename(p).startswith("."))


def _pickle(path):
    with open(path, "rb") as fin:
        return pickle.load(fin)


def _json(path):
    with open(path) as fin:
        return json.load(fin)


def _assert_close_tree(got, want, path=""):
    """Equal trees, floats within 1e-6 relative (host arithmetic in other
    orders)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_close_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, x) in enumerate(zip(got, want)):
            _assert_close_tree(g, x, f"{path}/{i}")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), path
    else:
        assert got == want, path


def test_same_files(runs):
    got, want = _files(runs["port"]), _files(runs["jax"])
    assert got == want
    assert "parts/ment_to_ent_scores_n_m_12_n_e_40_all_layers_False_start_12.pkl" in got
    assert "embeds/ment_and_ent_embeds_n_m_2_n_e_40_all_layers_False_x.pkl" in got


def test_tokenize_entities_equals_jax(runs):
    got, want = (np.load(os.path.join(runs[k], "ents.npy")) for k in ("port", "jax"))
    assert got.shape == (40, 16) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rel", [
    "mono/ment_to_ent_scores_n_m_24_n_e_40_all_layers_False.pkl",
    "parts/ment_to_ent_scores_n_m_12_n_e_40_all_layers_False.pkl",
    "parts/ment_to_ent_scores_n_m_12_n_e_40_all_layers_False_start_12.pkl",
    "full.pkl",
])
def test_score_matrices_equal_jax(runs, rel):
    got, want = (_pickle(os.path.join(runs[k], rel)) for k in ("port", "jax"))
    assert set(got) == set(want)
    assert np.abs(want["ment_to_ent_scores"]).std() > 1e-2  # rankings to compare
    np.testing.assert_allclose(got["ment_to_ent_scores"], want["ment_to_ent_scores"], atol=SCORE_ATOL, rtol=SCORE_RTOL)
    for key in ("mention_tokens_list", "entity_id_list", "entity_tokens_list"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["test_data"] == want["test_data"]
    if rel != "full.pkl":
        assert set(got["arg_dict"]) - {"device"} == set(want["arg_dict"])


def test_chunked_equals_monolithic(runs):
    full = _pickle(os.path.join(runs["port"], "full.pkl"))["ment_to_ent_scores"]
    mono = _pickle(os.path.join(runs["port"], "mono/ment_to_ent_scores_n_m_24_n_e_40_all_layers_False.pkl"))
    np.testing.assert_array_equal(full, mono["ment_to_ent_scores"])


def test_build_resumes_from_jax_chunks(runs, world, tmp_path):
    """The port resumes a JAX job's chunk directory: every chunk is read,
    none is recomputed, so the matrix is JAX's bit for bit."""
    res = str(tmp_path / "mono")
    shutil.copytree(os.path.join(runs["jax"], "mono"), res)
    os.remove(os.path.join(res, "ment_to_ent_scores_n_m_24_n_e_40_all_layers_False.pkl"))
    assert os.listdir(os.path.join(res, "chunks_start_0"))
    _port_cli("build_score_matrix").main(
        ["--ment_file", world["ment_file"], "--ent_file", world["ent_file"], "--vocab_file", world["vocab"],
         "--ckpt_path", world["ce_ckpt"], "--res_dir", res, "--ment_block", "4", "--ent_block", "8"] + TINY + LENS + CPU
    )
    rel = "ment_to_ent_scores_n_m_24_n_e_40_all_layers_False.pkl"
    np.testing.assert_array_equal(
        _pickle(os.path.join(res, rel))["ment_to_ent_scores"],
        _pickle(os.path.join(runs["jax"], "mono", rel))["ment_to_ent_scores"],
    )


def test_paired_embeds_cli_equals_jax(runs):
    rel = "embeds/ment_and_ent_embeds_n_m_2_n_e_40_all_layers_False_x.pkl"
    got, want = (_pickle(os.path.join(runs[k], rel)) for k in ("port", "jax"))
    assert set(got) == set(want) == {"ment_embeds", "ent_embeds"}
    for key in got:
        assert got[key].shape == (2, 40, 32)
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=SCORE_ATOL, rtol=SCORE_RTOL)


def test_split_equals_jax(runs):
    for name in ("train", "train_train", "train_dev", "test"):
        rel = f"splits/nm_train=16_split=0/{name}.pkl"
        got, want = (_pickle(os.path.join(runs[k], rel)) for k in ("port", "jax"))
        assert got["arg_dict"] == want["arg_dict"]
        np.testing.assert_array_equal(got["mention_tokens_list"], want["mention_tokens_list"])
        np.testing.assert_array_equal(got["ment_to_ent_scores"], want["ment_to_ent_scores"])


@pytest.mark.parametrize("rel", [
    "trans/retrieval_wrt_exact_crossenc.json",
    "ind/method=cur_s=0/res.json",
    "ind/method=bienc_s=0/res.json",
    "ind/method=tfidf_s=0/res.json",
    "avg.json",
])
def test_eval_outputs_equal_jax(runs, rel):
    got, want = (_json(os.path.join(runs[k], rel)) for k in ("port", "jax"))
    if rel.startswith("trans"):
        for tree in (got, want):  # the transductive sweep records its own arguments
            tree.get("other_args", {}).pop("device", None)
        # approximation errors: host f64 vs f32 device pinvs
        for tree in (got, want):
            _drop_keys(tree, ("approx_error", "approx_error_relative"))
    _assert_close_tree(got, want)


def _drop_keys(tree, keys):
    if isinstance(tree, dict):
        for k in keys:
            tree.pop(k, None)
        for v in tree.values():
            _drop_keys(v, keys)


def test_retrieve_rerank_cli_equals_jax(runs):
    for sub in ("rr", "bi"):
        got_files = sorted(os.listdir(os.path.join(runs["port"], sub)))
        assert got_files == sorted(os.listdir(os.path.join(runs["jax"], sub)))
    got, want = (_json(os.path.join(runs[k], "rr/res.json")) for k in ("port", "jax"))
    _assert_close_tree(got, want)
    got_p, want_p = (_json(os.path.join(runs[k], "rr/crossenc_topk_preds_w_bienc_retrvr.txt")) for k in ("port", "jax"))
    np.testing.assert_array_equal(got_p["indices"], want_p["indices"])
    np.testing.assert_allclose(got_p["scores"], want_p["scores"], atol=SCORE_ATOL, rtol=SCORE_RTOL)
    _assert_close_tree(*(_json(os.path.join(runs[k], "bi/res.json")) for k in ("port", "jax")))
    # --from_precomputed rewrites res.json from the saved predictions alone
    before = _json(os.path.join(runs["port"], "rr/res.json"))
    _port_cli("eval_retrieve_rerank").main(["--res_dir", os.path.join(runs["port"], "rr"), "--from_precomputed"])
    after = _json(os.path.join(runs["port"], "rr/res.json"))
    assert after["from_precomputed"] and after["crossenc"] == before["crossenc"]


def test_tfidf_hard_negs_cli_equals_jax(runs, world):
    got, want = (_json(os.path.join(runs[k], "negs.json")) for k in ("port", "jax"))
    assert set(got) == {"indices", "scores"}
    assert got["indices"] == want["indices"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-6, atol=1e-7)
    gold = [m["label_id"] for m in world["mentions"]]
    assert all(g not in row and len(row) == 6 for g, row in zip(gold, got["indices"]))


def test_preprocess_zeshel_cli_equals_jax(tmp_path):
    from test_torch_data import _raw_zeshel

    for kind, cli in (("port", _port_cli), ("jax", _jax_cli)):
        _raw_zeshel(str(tmp_path / kind))
        cli("preprocess_zeshel").main(["--root_data_dir", str(tmp_path / kind)])
    got, want = _files(str(tmp_path / "port")), _files(str(tmp_path / "jax"))
    assert got == want
    for rel in got:
        with open(os.path.join(tmp_path, "port", rel)) as f1, open(os.path.join(tmp_path, "jax", rel)) as f2:
            assert f1.read() == f2.read()


NO_CARD = {
    "build_score_matrix": ["--ment_file", "m", "--ent_file", "e", "--vocab_file", "v", "--res_dir", "r"],
    "serve": ["--index", "i", "--vocab_file", "v"],
    "eval_retrieval": ["--mode", "transductive", "--score_matrix", "s", "--res_dir", "r"],
    "eval_retrieve_rerank": ["--ment_file", "m", "--ent_file", "e", "--vocab_file", "v", "--res_dir", "r"],
    "compute_tfidf_hard_negs": ["--ment_file", "m", "--ent_file", "e", "--out_file", "o"],
    "train": ["--config", "c"],
}


@pytest.mark.parametrize("name", sorted(NO_CARD))
def test_cli_without_a_card_exits(name, monkeypatch):
    """Without ``--device cpu`` a port CLI asks for the card and exits
    with resolve_device's error, ANNCUR_ALLOW_CPU (the JAX CLIs' guard)
    notwithstanding."""
    monkeypatch.setenv("ANNCUR_ALLOW_CPU", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        _port_cli(name).main(NO_CARD[name])
