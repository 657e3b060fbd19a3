"""Port parity, the analysis CLIs and the job launcher: each run by the JAX
``main(argv)`` and by the port's (``--device cpu`` where it touches
tensors) on the same files, and the outputs compared. The encoder CLIs
read one JAX-written checkpoint and compute in f32 on both sides (they
have no dtype flag and compute in bf16), so their scores agree within
SCORE_ATOL, SCORE_RTOL; everything else is equal. The launcher's
commands are JAX's with the package name swapped, and its ``local``
backend runs a port job to the JAX CLI's recall."""

import contextlib
import functools
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.data.synthetic import make_tokenizer, make_world
from anncur_tpu.models.bert import BertSpec as JaxBertSpec
from anncur_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from anncur_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from anncur_tpu.train.checkpoint import save_pytree as jax_save_pytree
from anncur_tpu_torch.data.tokenization import tokenize_entities, tokenize_mentions
from anncur_tpu_torch.indexer.score_matrix import save_score_matrix

torch.set_num_threads(2)  # xdist runs several test files side by side

SCORE_ATOL, SCORE_RTOL = 1e-4, 1e-5
TINY = ["--hidden_size", "32", "--num_layers", "1", "--num_heads", "2", "--intermediate_size", "64"]
CPU = ["--device", "cpu"]
N_ENTS, N_MENTS = 40, 12


def _jax_cli(name):
    return __import__(f"anncur_tpu.cli.{name}", fromlist=["main"])


def _port_cli(name):
    return __import__(f"anncur_tpu_torch.cli.{name}", fromlist=["main"])


@contextlib.contextmanager
def f32_encoders():
    """Both packages' encoder CLIs compute in f32."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(_jax_cli("build_ent2ent"), "CrossEncoder", functools.partial(JaxCrossEncoder, compute_dtype=jnp.float32))
        mp.setattr(_jax_cli("compute_bienc_scores"), "BiEncoder", functools.partial(JaxBiEncoder, compute_dtype=jnp.float32))
        for name in ("build_ent2ent", "compute_bienc_scores"):
            mp.setattr(_port_cli(name), "COMPUTE_DTYPE", torch.float32)
        yield
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("analysis_world")
    mentions, entities = make_world(np.random.default_rng(5), n_ents=N_ENTS, n_ments=N_MENTS)
    tok = make_tokenizer()
    w = {"root": str(root), "vocab": str(root / "vocab.txt"), "ents": str(root / "ents.npy")}
    tok.save_vocab(w["vocab"])
    np.save(w["ents"], tokenize_entities(entities, tok, 16))
    # widened init: a random CE at 0.02 scores near rank one
    spec = JaxBertSpec(vocab_size=tok.vocab_size, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                       initializer_range=0.3)
    w["ce_ckpt"] = str(root / "ce.pkl")
    jax_save_pytree(w["ce_ckpt"], {"params": JaxCrossEncoder(spec=spec, compute_dtype=jnp.float32).init(jax.random.PRNGKey(1))})
    w["bienc_ckpt"] = str(root / "bienc.pkl")
    bienc = JaxBiEncoder(spec=spec, pooling_type="cls", embed_dim=32, compute_dtype=jnp.float32)
    jax_save_pytree(w["bienc_ckpt"], {"params": bienc.init(jax.random.PRNGKey(2))})
    rng = np.random.default_rng(0)
    w["scores_pkl"] = str(root / "scores.pkl")
    save_score_matrix(w["scores_pkl"], rng.standard_normal((N_MENTS, N_ENTS)).astype(np.float32),
                      tokenize_mentions(mentions, tok, 16), np.arange(N_ENTS))
    w["embeds"] = str(root / "ent_embeds.npy")
    np.save(w["embeds"], rng.standard_normal((N_ENTS, 8)).astype(np.float32))
    return w


def _load_pickle(path):
    with open(path, "rb") as fin:
        return pickle.load(fin)


@pytest.mark.parametrize("anchors_from", ["kmeans", "random"])
def test_build_ent2ent_matches_jax(world, tmp_path, anchors_from):
    argv = ["--ent_tokens_file", world["ents"], "--vocab_file", world["vocab"], "--crossenc_ckpt", world["ce_ckpt"],
            "--n_anchors", "6", "--ment_block", "4", "--ent_block", "4", "--seed", "3"] + TINY
    if anchors_from == "kmeans":
        argv += ["--ent_embeds_file", world["embeds"]]
    with f32_encoders():
        _jax_cli("build_ent2ent").main(argv + ["--out_file", str(tmp_path / "jax.pkl")])
        _port_cli("build_ent2ent").main(argv + ["--out_file", str(tmp_path / "port.pkl")] + CPU)
    want, got = _load_pickle(tmp_path / "jax.pkl"), _load_pickle(tmp_path / "port.pkl")
    assert set(got) == set(want) == {"ent_to_ent_scores", "topk_ents"}
    np.testing.assert_array_equal(got["topk_ents"], want["topk_ents"])
    assert got["ent_to_ent_scores"].shape == (N_ENTS, 6)
    np.testing.assert_allclose(got["ent_to_ent_scores"], np.asarray(want["ent_to_ent_scores"]),
                               atol=SCORE_ATOL, rtol=SCORE_RTOL)


def test_compute_bienc_scores_matches_jax(world, tmp_path):
    argv = ["--score_matrix", world["scores_pkl"], "--ent_tokens_file", world["ents"], "--vocab_file", world["vocab"],
            "--bienc_ckpt", world["bienc_ckpt"], "--pooling_type", "cls", "--batch_size", "8"] + TINY
    with f32_encoders():
        _jax_cli("compute_bienc_scores").main(argv + ["--out_file", str(tmp_path / "jax.pkl")])
        _port_cli("compute_bienc_scores").main(argv + ["--out_file", str(tmp_path / "port.pkl")] + CPU)
    want, got = _load_pickle(tmp_path / "jax.pkl"), _load_pickle(tmp_path / "port.pkl")
    assert set(got) == set(want) == {"scores"}
    assert got["scores"].shape == (N_MENTS, N_ENTS) and got["scores"].dtype == np.float32
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]), atol=SCORE_ATOL, rtol=SCORE_RTOL)


@pytest.mark.parametrize("name", ["trained_ce_matrix_quick.npz", "trained_ce_matrix_hard_quick.npz"])
def test_rank_probe_matches_jax(tmp_path, name):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scores = np.asarray(np.load(os.path.join(root, "benchmarks", name))["scores"], np.float32)
    pkl = str(tmp_path / "m.pkl")
    save_score_matrix(pkl, scores, np.zeros((scores.shape[0], 1), np.int32), np.arange(scores.shape[1]))
    _jax_cli("rank_probe").main(["--score_matrices", pkl, "--out", str(tmp_path / "jax.json")])
    _port_cli("rank_probe").main(["--score_matrices", pkl, "--out", str(tmp_path / "port.json")])
    with open(tmp_path / "jax.json") as a, open(tmp_path / "port.json") as b:
        want, got = json.load(a), json.load(b)
    assert got == want and got[pkl]["rank"] > 0


@pytest.fixture(scope="module")
def results_tree(tmp_path_factory):
    """Inductive results of two methods and two seeds, and a transductive
    result file, by the port's eval CLI on a low-rank matrix."""
    root = tmp_path_factory.mktemp("results_tree")
    rng = np.random.default_rng(4)
    mat = (rng.standard_normal((60, 4)) @ rng.standard_normal((4, 50))).astype(np.float32)
    pkls = {}
    for name, rows in (("test", mat[40:]), ("train", mat[:40]), ("all", mat[:30])):
        pkls[name] = str(root / f"{name}.pkl")
        save_score_matrix(pkls[name], rows, np.zeros((rows.shape[0], 1), np.int32), np.arange(50))
    bienc = str(root / "bienc.pkl")
    with open(bienc, "wb") as fout:
        pickle.dump({"scores": mat[40:] + 0.5 * rng.standard_normal((20, 50)).astype(np.float32)}, fout)
    res = str(root / "ind")
    grid = ["--top_k_vals", "1", "10", "--top_k_retvr_vals", "10", "20", "--n_ent_anchors_vals", "8", "16"]
    for seed in ("0", "1"):
        _port_cli("eval_retrieval").main(
            ["--mode", "inductive", "--score_matrix", pkls["test"], "--train_score_matrix", pkls["train"],
             "--bienc_scores_pkl", bienc, "--res_dir", res, "--methods", "cur", "bienc", "--seed", seed] + grid + CPU)
    trans = str(root / "trans")
    _port_cli("eval_retrieval").main(
        ["--mode", "transductive", "--score_matrix", pkls["all"], "--res_dir", trans, "--methods", "cur",
         "--n_ment_anchors_vals", "8", "16", "--n_ent_anchors_vals", "8", "16", "--top_k_vals", "5",
         "--top_k_retvr_vals", "16"] + CPU)
    return {"ind": res, "trans_json": os.path.join(trans, "retrieval_wrt_exact_crossenc.json"), "scores": pkls["all"]}


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fin:
                out[os.path.relpath(os.path.join(d, f), root)] = fin.read()
    return out


@pytest.mark.parametrize("extra", [[], ["--style", "paper", "--nm_train", "40"]])
def test_compile_results_matches_jax(results_tree, tmp_path, extra):
    argv = ["--res_dir", results_tree["ind"], "--top_k_vals", "1", "10"] + extra
    _jax_cli("compile_results").main(argv + ["--out_dir", str(tmp_path / "jax")])
    _port_cli("compile_results").main(argv + ["--out_dir", str(tmp_path / "port")])
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert set(got) == set(want)
    assert any(p.endswith(".csv") for p in got) and any(p.endswith(".pdf") for p in got)
    for path in want:
        if path.endswith(".json"):
            assert json.loads(got[path]) == json.loads(want[path]), path
        elif path.endswith(".csv"):
            assert got[path] == want[path], path


@pytest.mark.parametrize("extra", [[], ["--rq7"]])
def test_plot_results_matches_jax(results_tree, tmp_path, extra):
    argv = ["--transductive_json", results_tree["trans_json"], "--score_matrix", results_tree["scores"],
            "--methods", "cur", "--top_k", "5", "--top_k_retvr", "16"] + extra
    _jax_cli("plot_results").main(argv + ["--out_dir", str(tmp_path / "jax")])
    _port_cli("plot_results").main(argv + ["--out_dir", str(tmp_path / "port")])
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert set(got) == set(want) and "score_distribution.pdf" in got and len(got) > 1


GRID = {"domain": ["lego", "yugioh"], "nm_train": [100, 500], "neg_strategy": ["random", "bienc_hard_negs"]}


def _swap(cmd):
    return cmd.replace("-m anncur_tpu.cli.", "-m anncur_tpu_torch.cli.")


@pytest.mark.parametrize("device", [None, "cpu"])
def test_launcher_commands_are_jax_with_the_package_swapped(tmp_path, device):
    from anncur_tpu.utils import launcher as jax_launcher
    from anncur_tpu_torch.utils import launcher

    probe = str(tmp_path / "{domain}_{nm_train}_{neg_strategy}.done")
    open(probe.format(domain="lego", nm_train=100, neg_strategy="random"), "w").close()
    tail = "" if device is None else f" --device {device}"
    pairs = [
        (jax_launcher.make_train_jobs("configs/el_zeshel_bi_enc.json", GRID, result_probe=probe),
         launcher.make_train_jobs("configs/el_zeshel_bi_enc.json", GRID, result_probe=probe, device=device)),
    ]
    for mode in ("inductive", "transductive"):
        args = (mode, str(tmp_path / "{domain}.pkl"), str(tmp_path / "res" / "{domain}"),
                {"domain": ["lego", "star wars"], "method": ["cur", "fixed_anc_ent"], "seed": [0, 1],
                 "train_score_matrix": ["t.pkl"]}, "--n_seeds 1")
        pairs.append((jax_launcher.make_eval_jobs(*args), launcher.make_eval_jobs(*args, device=device)))
    for want, got in pairs:
        assert len(got) == len(want) > 1
        for w, g in zip(want, got):
            assert g["cmd"] == _swap(w["cmd"]) + tail
            assert (g["overrides"], g["done"], g["probe"]) == (w["overrides"], w["done"], w["probe"])
    assert sum(j["done"] for j in pairs[0][1]) == 1
    pending = launcher.launch(pairs[0][1], backend="print")
    assert len(pending) == len(pairs[0][1]) - 1
    assert len(launcher.launch(pairs[0][1], backend="print", skip_done=False)) == len(pairs[0][1])


def test_launch_jobs_cli_prints_jax_commands(tmp_path, capsys):
    argv = ["--kind", "eval", "--grid", json.dumps({"seed": [0, 1], "method": ["cur"]}), "--mode", "transductive",
            "--score_matrix_template", str(tmp_path / "m.pkl"), "--res_dir_template", str(tmp_path / "r"),
            "--extra_args", "--n_seeds 1"]
    _jax_cli("launch_jobs").main(argv)
    want = capsys.readouterr().out
    _port_cli("launch_jobs").main(argv)
    got = capsys.readouterr().out
    assert got == _swap(want) and got.count("anncur_tpu_torch.cli.eval_retrieval") == 2
    _port_cli("launch_jobs").main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == "".join(line + " --device cpu\n" for line in _swap(want).splitlines())


def test_local_backend_runs_a_port_job_to_the_jax_recall_and_skips_it_after(tmp_path):
    """One port eval_retrieval job in a subprocess of another working
    directory (the launcher puts the checkout on its path), its recall
    equal to the JAX CLI's on the same matrix; launched again it is done."""
    from anncur_tpu_torch.utils import launcher

    rng = np.random.default_rng(8)
    mat = (rng.standard_normal((30, 4)) @ rng.standard_normal((4, 40))).astype(np.float32)
    pkl = str(tmp_path / "m.pkl")
    save_score_matrix(pkl, mat, np.zeros((30, 1), np.int32), np.arange(40))
    extra = "--n_ment_anchors_vals 8 --n_ent_anchors_vals 8 --top_k_vals 5 --top_k_retvr_vals 16"
    jobs = launcher.make_eval_jobs("transductive", pkl, str(tmp_path / "port"), {"method": ["cur"]}, extra,
                                   device="cpu")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert len(launcher.launch(jobs, backend="local")) == 1
    finally:
        os.chdir(cwd)
    _jax_cli("eval_retrieval").main(["--mode", "transductive", "--score_matrix", pkl, "--res_dir",
                                     str(tmp_path / "jax"), "--methods", "cur"] + extra.split())
    with open(jobs[0]["probe"]) as a, open(tmp_path / "jax" / "retrieval_wrt_exact_crossenc.json") as b:
        got, want = json.load(a), json.load(b)
    cell = ["cur", "top_k=5", "k_retvr=16", "anc_n_m=8~anc_n_e=8", "all", "exact_vs_reranked_approx_retvr~common_frac_mean"]
    for key in cell:
        got, want = got[key], want[key]
    assert got == pytest.approx(want, abs=1e-9)
    again = launcher.make_eval_jobs("transductive", pkl, str(tmp_path / "port"), {"method": ["cur"]}, extra,
                                    device="cpu")
    assert again[0]["done"] and launcher.launch(again, backend="local") == []


def test_a_failing_job_fails_the_launch_after_the_rest_ran(tmp_path):
    from anncur_tpu_torch.utils import launcher

    marker = tmp_path / "ran"
    jobs = [{"cmd": f"{sys.executable} -c 'raise SystemExit(3)'", "done": False},
            {"cmd": f"touch {marker}", "done": False}]
    with pytest.raises(RuntimeError, match="1 of 2 jobs failed"):
        launcher.launch(jobs, backend="local")
    assert marker.exists() and jobs[0]["failed"]
    with pytest.raises(SystemExit):
        _port_cli("launch_jobs").main(["--kind", "train", "--grid", json.dumps({"seed": [0]}), "--backend",
                                       "false {cmd}"])
