"""Port parity, training from the command line: ``cli/train.py`` run by
the JAX ``main(argv)`` and by the port's ``main(argv + ["--device",
"cpu"])`` on one ZeShEL-format world (bi-encoder with random negatives,
cross-encoder with TF-IDF hard negatives, bi-encoder distillation from a
teacher score pickle), two fast steps each with a tiny encoder in place
of bert-base (both packages' ``build_model`` patched alike), and the
files compared: the result directory, the saved config, the tracker's
metrics and a checkpoint that JAX's ``load_pytree`` reads with JAX's
tree layout. Then the port alone: overrides, the mesh refusal, dropout
from ``bert_args``, the tracker and the code snapshot (CPU)."""

import glob
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anncur_tpu.cli.train as jtrain
from anncur_tpu.data.synthetic import make_tokenizer, make_world, write_world_files
from anncur_tpu.indexer.score_matrix import save_score_matrix
from anncur_tpu.models.bert import BertSpec as JaxBertSpec
from anncur_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from anncur_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from anncur_tpu.train.checkpoint import load_pytree as jax_load_pytree

import anncur_tpu_torch.cli.train as ttrain
from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.biencoder import BiEncoder
from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.utils import TRACER, ExperimentTracker, trace_profile

torch.set_num_threads(2)  # xdist runs several test files side by side

L = 16
TINY = dict(hidden_size=64, num_layers=1)


def _jax_tiny_build(cfg, vocab_size):
    spec = JaxBertSpec.tiny(vocab_size=vocab_size, **TINY)
    if cfg.model_type == "bi_enc":
        return JaxBiEncoder(spec=spec, pooling_type="cls", embed_dim=64, compute_dtype=jnp.float32)
    return JaxCrossEncoder(spec=spec, compute_dtype=jnp.float32)


def _port_tiny_build(cfg, vocab_size, device):
    spec = BertSpec.tiny(vocab_size=vocab_size, **TINY)
    if cfg.model_type == "bi_enc":
        return BiEncoder(spec=spec, pooling_type="cls", embed_dim=64, compute_dtype=torch.float32, device=device)
    return CrossEncoder(spec=spec, compute_dtype=torch.float32, device=device)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_world")
    mentions, entities = make_world(np.random.default_rng(8), n_ents=30, n_ments=16)
    w = write_world_files(str(root), mentions, entities)
    w["vocab"] = str(root / "vocab.txt")
    make_tokenizer().save_vocab(w["vocab"])
    rng = np.random.default_rng(0)
    ment_toks = rng.integers(1, 90, (20, L)).astype(np.int32)
    ent_toks = rng.integers(1, 90, (30, L)).astype(np.int32)
    save_score_matrix(str(root / "yugioh_train.pkl"), rng.standard_normal((20, 30)).astype(np.float32), ment_toks,
                      np.arange(30), ent_toks)
    np.save(str(root / "yugioh_ents.npy"), ent_toks)
    w["root"] = str(root)
    return w


def _config(world, case):
    cfg = {
        "loss_type": "ce", "pooling_type": "cls", "embed_dim": 64, "num_epochs": 1, "train_batch_size": 8,
        "grad_acc_steps": 1, "max_input_len": L, "max_label_len": L, "bert_args": {"vocab_file": world["vocab"]},
        "fast_dev_run": 2, "save_code": False, "use_bf16": False, "print_interval": 1,
    }
    files = {"synthville": {"ment_file": world["ment_file"], "ent_file": world["ent_file"]}}
    if case == "bienc_random":
        cfg.update(model_type="bi_enc", neg_strategy="random", num_negs=2, trn_files=files, dev_files={})
    elif case == "crossenc_tfidf":
        cfg.update(model_type="cross_enc", neg_strategy="tfidf_hard_negs", num_negs=3, trn_files=files,
                   dev_files=files, train_batch_size=4)
    else:  # distillation from a teacher score pickle
        cfg.update(model_type="bi_enc", data_type="ent_link_ce", neg_strategy="top_ce_match", distill_n_labels=4,
                   train_domains=["yugioh"], dev_domains=[],
                   ent_w_score_file_template=os.path.join(world["root"], "{}_train.pkl"),
                   entity_token_file_template=os.path.join(world["root"], "{}_ents.npy"))
    return cfg


def _run(kind, world, case, tmp_path, monkeypatch, extra=()):
    cfg = dict(_config(world, case), base_res_dir=str(tmp_path / kind))
    path = str(tmp_path / f"{kind}.json")
    with open(path, "w") as fout:
        json.dump(cfg, fout)
    if kind == "jax":
        monkeypatch.setattr(jtrain, "build_model", _jax_tiny_build)
        jtrain.main(["--config", path, *extra])
    else:
        monkeypatch.setattr(ttrain, "build_model", _port_tiny_build)
        ttrain.main(["--config", path, *extra, "--device", "cpu"])
    (res,) = glob.glob(str(tmp_path / kind / "**" / "orig_config.json"), recursive=True)
    return os.path.dirname(res)


def _tree_layout(tree, path=""):
    """{path: shape} of a params tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_layout(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_tree_layout(v, f"{path}/{i}"))
        return out
    return {path: np.shape(tree)}


@pytest.mark.parametrize("case", ["bienc_random", "crossenc_tfidf", "distill"])
def test_train_cli_equals_jax(world, case, tmp_path, monkeypatch):
    dirs = {kind: _run(kind, world, case, tmp_path, monkeypatch) for kind in ("jax", "port")}
    assert os.path.relpath(dirs["port"], tmp_path / "port") == os.path.relpath(dirs["jax"], tmp_path / "jax")
    with open(os.path.join(dirs["port"], "orig_config.json")) as f1, open(os.path.join(dirs["jax"], "orig_config.json")) as f2:
        got, want = json.load(f1), json.load(f2)
    assert got.keys() == want.keys()
    own = ("base_res_dir", "config_name")  # the two runs' own paths
    assert {k: v for k, v in got.items() if k not in own} == {k: v for k, v in want.items() if k not in own}
    with open(os.path.join(dirs["port"], "metrics.jsonl")) as fin:
        losses = [r["train_loss"] for r in map(json.loads, fin) if "train_loss" in r]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert os.path.exists(os.path.join(dirs["port"], "tracker_config.json"))
    (ckpt_t,) = glob.glob(os.path.join(dirs["port"], "model", "eoe-*"))
    (ckpt_j,) = glob.glob(os.path.join(dirs["jax"], "model", "eoe-*"))
    assert os.path.basename(ckpt_t) == os.path.basename(ckpt_j)
    # JAX reads the port's checkpoint: the same params layout as its own
    tree_t, _ = jax_load_pytree(ckpt_t)
    tree_j, _ = jax_load_pytree(ckpt_j)
    assert tree_t["step"] == tree_j["step"] == 2
    assert _tree_layout(tree_t["params"]) == _tree_layout(tree_j["params"])


def test_overrides_and_one_device(world, tmp_path, monkeypatch):
    res = _run("port", world, "bienc_random", tmp_path, monkeypatch, extra=["--seed", "7", "--misc", "x"])
    assert res.endswith("m=bi_enc_l=ce_neg=random_s=7_x")
    with open(os.path.join(res, "orig_config.json")) as fin:
        assert json.load(fin)["seed"] == 7
    (tmp_path / "mesh").mkdir()
    for extra in (["--num_devices", "2"], ["--mesh_shape", "4"]):
        with pytest.raises(ValueError, match="needs"):
            _run("port", world, "bienc_random", tmp_path / "mesh", monkeypatch, extra=extra)


def test_build_model_reads_dropout_from_bert_args():
    cfg = ttrain.Config(model_type="bi_enc", bert_args={"vocab_file": "v", "attention_probs_dropout_prob": 0.0})
    be = ttrain.build_model(cfg, 100, "cpu")
    assert be.spec.attention_dropout == 0.0 and be.spec.hidden_dropout == 0.1
    assert be.spec.hidden_size == 768 and be.compute_dtype == torch.bfloat16
    ce = ttrain.build_model(ttrain.Config(model_type="cross_enc", use_bf16=False), 100, "cpu")
    assert isinstance(ce, CrossEncoder) and ce.spec.attention_dropout == 0.1 and ce.compute_dtype == torch.float32
    with pytest.raises(ValueError, match="model_type"):
        ttrain.build_model(ttrain.Config(model_type="nope"), 100, "cpu")


def test_code_snapshot(tmp_path, monkeypatch):
    monkeypatch.setattr("sys.argv", ["train", "--config", "c.json"])
    ttrain.save_code_snapshot(str(tmp_path))
    assert os.path.exists(tmp_path / "code" / "anncur_tpu_torch" / "cli" / "train.py")
    assert not os.path.exists(tmp_path / "code" / "anncur_tpu_torch" / "build")
    assert (tmp_path / "command.txt").read_text() == "train --config c.json\n"


def test_tracker_and_timer(tmp_path):
    tracker = ExperimentTracker(str(tmp_path / "run"), config={"a": 1})
    tracker.log({"loss": np.float32(0.5)})
    tracker.progress("build", 0.25)
    tracker.alert("disk full")
    tracker.finish()
    with open(tmp_path / "run" / "metrics.jsonl") as fin:
        recs = [json.loads(line) for line in fin]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert recs[0]["loss"] == 0.5 and recs[1]["build_frac"] == 0.25 and recs[2]["alert"] == "disk full"
    assert json.load(open(tmp_path / "run" / "tracker_config.json")) == {"a": 1}
    with TRACER.span("a"):  # no profiler session: nothing recorded
        pass
    with trace_profile(str(tmp_path / "prof")):
        with TRACER.span("a"):
            torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    # the program's span sits on the trace's host track around the op it ran
    events = json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in spans] == ["a"]
    ones = [e for e in events if e.get("name") == "aten::ones"]
    assert ones and spans[0]["ts"] <= ones[0]["ts"] and ones[0]["ts"] + ones[0]["dur"] <= spans[0]["ts"] + spans[0]["dur"]
    assert spans[0]["tid"] == ones[0]["tid"]
    with trace_profile(None):  # off: nothing written
        pass
