"""Port parity, the data layer: the ZeShEL loaders and registry, the
token-level and id-level representation builders, preprocessing, TF-IDF,
the synthetic worlds, the native tokenizer and TF-IDF hard negatives,
held against the JAX package on the same inputs (CPU). Everything here
is exact: the same ids, the same floats."""

import json
import os

import numpy as np
import pytest
import torch

from anncur_tpu.data import preprocess as jprep
from anncur_tpu.data import synthetic as jsyn
from anncur_tpu.data import tfidf as jtfidf
from anncur_tpu.data import tokenization as jtok
from anncur_tpu.data import zeshel as jzes
from anncur_tpu.models.native_tokenizer import NativeWordPieceTokenizer as JaxNative
from anncur_tpu.models.tokenizer import WordPieceTokenizer as JaxWordPiece
from anncur_tpu.train import data as jdata
from anncur_tpu.train import negatives as jnegs

import anncur_tpu_torch.data as tdata_pkg
from anncur_tpu_torch.data import preprocess as tprep
from anncur_tpu_torch.data import synthetic as tsyn
from anncur_tpu_torch.data import tfidf as ttfidf
from anncur_tpu_torch.data import tokenization as ttok
from anncur_tpu_torch.data import zeshel as tzes
from anncur_tpu_torch.models import native_tokenizer as tnative
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer, make_realistic_vocab
from anncur_tpu_torch.train import data as tdata
from anncur_tpu_torch.train import negatives as tnegs

torch.set_num_threads(2)  # xdist runs several test files side by side

CPU = "cpu"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 40-entity x 24-mention world on disk, and the tokenizers."""
    root = str(tmp_path_factory.mktemp("world"))
    mentions, entities = tsyn.make_world(np.random.default_rng(5), n_ents=40, n_ments=24)
    files = tsyn.write_world_files(root, mentions, entities)
    return root, files, mentions, entities, tsyn.make_tokenizer(), jsyn.make_tokenizer()


def test_data_package_exports_the_jax_names():
    import anncur_tpu.data as jdata_pkg

    want = {n for n in dir(jdata_pkg) if not n.startswith("_")} - {"zeshel", "tokenization"}
    got = {n for n in dir(tdata_pkg) if not n.startswith("_")}
    assert want <= got


@pytest.mark.parametrize("seed", [0, 5])
def test_make_world_and_tokenized_world_equal_jax(seed):
    t_m, t_e = tsyn.make_world(np.random.default_rng(seed), n_ents=30, n_ments=20)
    j_m, j_e = jsyn.make_world(np.random.default_rng(seed), n_ents=30, n_ments=20)
    assert t_m == j_m and t_e == j_e
    got = tsyn.make_tokenized_world(seed=seed, n_ents=30, n_ments=20, max_ment_len=24, max_ent_len=20)
    want = jsyn.make_tokenized_world(seed=seed, n_ents=30, n_ments=20, max_ment_len=24, max_ent_len=20)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3].vocab == want[3].vocab


def test_loaders_and_registry_equal_jax(world, tmp_path):
    root, files, *_ = world
    t_kb, t_ents = tzes.load_entities(files["ent_file"])
    j_kb, j_ents = jzes.load_entities(files["ent_file"])
    assert t_kb == j_kb and t_ents == j_ents
    assert tzes.load_mentions(files["ment_file"], t_kb) == jzes.load_mentions(files["ment_file"], j_kb)
    # the raw schema (text / label_document_id / corpus / category) too
    raw = str(tmp_path / "raw.jsonl")
    with open(files["ment_file"]) as fin, open(raw, "w") as fout:
        for line in fin:
            r = json.loads(line)
            fout.write(json.dumps({
                "mention_id": r["mention_id"], "text": r["mention"], "context_left": r["context_left"],
                "context_right": r["context_right"], "label_document_id": r["label_id"],
                "corpus": r["world"], "category": r["type"], "context_document_id": r["context_doc_id"],
            }) + "\n")
    assert tzes.load_mentions(raw, t_kb) == jzes.load_mentions(raw, j_kb)
    assert tzes.N_ENTS_ZESHEL == jzes.N_ENTS_ZESHEL and tzes.N_MENTS_ZESHEL == jzes.N_MENTS_ZESHEL
    worlds = tzes.get_zeshel_world_info()
    assert worlds == jzes.get_zeshel_world_info()
    for res_dir in (None, "res"):
        assert tzes.get_dataset_info("data", res_dir, worlds, 100) == jzes.get_dataset_info("data", res_dir, worlds, 100)


def test_representations_equal_jax(world):
    *_, mentions, entities, ttk, jtk = world
    long_left = {"mention": mentions[0]["mention"], "context_left": "alpha beta " * 40, "context_right": "x"}
    for sample in list(mentions) + [long_left, {"mention": "", "context_left": "a", "context_right": "b"}]:
        for length in (16, 32):
            got = ttok.get_context_representation(sample, ttk, length)
            want = jtok.get_context_representation(sample, jtk, length)
            assert got == want
            assert ttok.get_context_representation_ids(sample, ttk, length) == got["ids"]
    for title, desc in entities:
        for length in (8, 16):
            got = ttok.get_candidate_representation(desc, ttk, length, candidate_title=title)
            assert got == jtok.get_candidate_representation(desc, jtk, length, candidate_title=title)
            assert ttok.get_candidate_representation_ids(desc, ttk, length, title) == got["ids"]
    ment = ttok.tokenize_mentions(mentions, ttk, 16)
    ent = ttok.tokenize_entities(entities, ttk, 12)
    np.testing.assert_array_equal(ment, jtok.tokenize_mentions(mentions, jtk, 16))
    np.testing.assert_array_equal(ent, jtok.tokenize_entities(entities, jtk, 12))
    np.testing.assert_array_equal(ttok.pair_token_matrix(ment[3], ent), jtok.pair_token_matrix(ment[3], ent))
    np.testing.assert_array_equal(
        ttok.create_input_label_pair(ment[0], ent[1]), jtok.create_input_label_pair(ment[0], ent[1])
    )


def _raw_zeshel(root):
    """A raw ZeShEL layout: documents/<world>.json and mentions/<split>.json
    with token offsets into the mention's document."""
    os.makedirs(os.path.join(root, "documents"))
    os.makedirs(os.path.join(root, "mentions"))
    rng = np.random.default_rng(2)
    words = ["alpha", "beta", "gamma", "delta", "castle", "dragon"]
    docs = {}
    for world_name in ("lego", "yugioh"):
        with open(os.path.join(root, "documents", f"{world_name}.json"), "w") as fout:
            for i in range(5):
                docs[f"{world_name}{i}"] = text = " ".join(rng.choice(words, size=12))
                fout.write(json.dumps({"document_id": f"{world_name}{i}", "title": f"t{i}", "text": text}) + "\n")
    for split in ("train", "val", "test"):
        with open(os.path.join(root, "mentions", f"{split}.json"), "w") as fout:
            for j, world_name in enumerate(("lego", "yugioh")):
                start = int(rng.integers(0, 8))
                span = " ".join(docs[f"{world_name}{j}"].split()[start : start + 2])
                fout.write(json.dumps({
                    "mention_id": f"{split}{j}", "category": "LOW_OVERLAP", "text": span,
                    "corpus": world_name, "context_document_id": f"{world_name}{j}",
                    "label_document_id": f"{world_name}{j + 1}", "start_index": start, "end_index": start + 1,
                }) + "\n")


def test_preprocess_equals_jax(tmp_path):
    roots = {}
    for name, mod in (("port", tprep), ("jax", jprep)):
        root = str(tmp_path / name)
        _raw_zeshel(root)
        mod.preprocess_zeshel_data(root)
        roots[name] = root
    got = sorted(os.path.relpath(os.path.join(d, f), roots["port"]) for d, _, fs in os.walk(roots["port"]) for f in fs)
    want = sorted(os.path.relpath(os.path.join(d, f), roots["jax"]) for d, _, fs in os.walk(roots["jax"]) for f in fs)
    assert got == want and any("processed" in f for f in got)
    for rel in got:
        with open(os.path.join(roots["port"], rel)) as f1, open(os.path.join(roots["jax"], rel)) as f2:
            assert f1.read() == f2.read(), rel


def test_tfidf_equals_jax(world):
    *_, mentions, entities, _, _ = world
    texts = [" ".join([m["context_left"], m["mention"], m["context_right"]]) for m in mentions]
    np.testing.assert_array_equal(
        ttfidf.compute_ent_embeds_w_tfidf(entities), jtfidf.compute_ent_embeds_w_tfidf(entities)
    )
    np.testing.assert_array_equal(
        ttfidf.compute_ment_embeds_w_tfidf(entities, texts), jtfidf.compute_ment_embeds_w_tfidf(entities, texts)
    )
    vt = ttfidf.TfidfVectorizer().fit(texts)
    vj = jtfidf.TfidfVectorizer().fit(texts)
    assert vt.vocabulary_ == vj.vocabulary_
    np.testing.assert_array_equal(vt.idf_, vj.idf_)


def test_tfidf_hard_negatives_equal_jax(world):
    *_, mentions, entities, _, _ = world
    texts = [m["mention"] for m in mentions]
    gt = np.asarray([m["label_id"] for m in mentions])
    got = tnegs.get_hard_negs_tfidf(texts, entities, gt, 5, device=CPU)
    want = jnegs.get_hard_negs_tfidf(texts, entities, gt, 5)
    np.testing.assert_array_equal(got, want)
    assert not (got == gt[:, None]).any()
    # and through the dataset dispatch, per world on a merged dataset
    ment = tsyn.make_tokenized_world(seed=5, n_ents=40, n_ments=24)[0]
    ent = np.zeros((40, 8), np.int32)
    kw = dict(mention_texts=texts, entities=entities)
    merged_t = tdata.merge_worlds([tdata.EntLinkDataset(ment, ent, gt, **kw)] * 2)
    merged_j = jdata.merge_worlds([jdata.EntLinkDataset(ment, ent, gt, **kw)] * 2)
    np.testing.assert_array_equal(
        tdata.mine_negatives(merged_t, "tfidf_hard_negs", 4, device=CPU),
        jdata.mine_negatives(merged_j, "tfidf_hard_negs", 4),
    )


NATIVE_TEXTS = [
    "hello world",
    "Unaffable tokenizer test!!! 123, 456.",
    "   spaces\t\teverywhere   ",
    "word-with-dashes and 'quotes'",
    "x" * 150,
    "",
    "nul\x00inside",
    "naïve café",  # non-ASCII: the Python path
    "日本語 test",
    "emoji 🙂 here",
    "[CLS] kept [SEP] whole",
]


def test_native_tokenizer_equals_python_and_jax():
    vocab = make_realistic_vocab(n_words=3000)
    native = tnative.NativeWordPieceTokenizer(vocab)
    assert native.native_available
    assert os.path.dirname(tnative.library_path()).endswith(os.path.join("anncur_tpu_torch", "build"))
    python = WordPieceTokenizer(vocab)
    jax_native = JaxNative(vocab)
    rng = np.random.default_rng(0)
    words = [t for t in vocab if t.isalpha()]
    texts = NATIVE_TEXTS + [" ".join(rng.choice(words, size=40)) for _ in range(20)]
    for text in texts:
        assert native.encode(text) == python.encode(text) == jax_native.encode(text), text
    assert JaxWordPiece(vocab).encode(texts[-1]) == native.encode(texts[-1])
    # where the fast path would give other ids, it is not taken
    gapped = dict(vocab)
    gapped.pop("hello", None)
    gapped["zzgap"] = max(vocab.values()) + 5
    assert not tnative.NativeWordPieceTokenizer(gapped).native_available
    assert not tnative.NativeWordPieceTokenizer(vocab, do_lower_case=False).native_available


def test_native_tokenizer_build_failure_raises(monkeypatch, tmp_path):
    """A failed build raises; nothing falls back to the Python path."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.raises(RuntimeError, match="build failed"):
        tnative.NativeWordPieceTokenizer(make_realistic_vocab(n_words=100))
